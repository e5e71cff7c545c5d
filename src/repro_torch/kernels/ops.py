"""Public entry points of the port's kernels (``repro.kernels.ops``).

Each op dispatches on the device of its input: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel,
which launches or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import FlashAttention

__all__ = ["flash_attention_op"]


def flash_attention_op(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, causal=True,
                       window=None):
    """Segment flash attention, differentiable in q, k and v (forward and
    backward kernels on CUDA, plain versions on CPU); returns out
    [B, H, Tq, D]."""
    out, _ = FlashAttention.apply(q, k, v, q_seg, kv_seg, q_pos, kv_pos, bool(causal),
                                  None if window is None else int(window))
    return out
