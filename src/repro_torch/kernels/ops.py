"""Public entry points of the port's kernels (``repro.kernels.ops``).

Each op dispatches on the device of its input: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel,
which launches or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

__all__ = ["flash_attention_op"]


def flash_attention_op(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, causal=True,
                       window=None):
    """Segment flash-attention forward; returns out [B, H, Tq, D]."""
    if q.device.type == "cpu":
        fn = flash_attention_plain
    elif q.device.type == "cuda":
        fn = flash_attention_fwd
    else:
        raise ValueError(f"flash_attention_op runs on cpu or cuda, not {q.device}")
    out, _ = fn(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal=causal, window=window)
    return out
