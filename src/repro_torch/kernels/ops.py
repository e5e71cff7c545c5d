"""Public entry points of the port's kernels (``repro.kernels.ops``).

Each op dispatches on the device of its input: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel,
which launches or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.grouped_gemm import GroupedMatmul, check_grouped_args

__all__ = ["flash_attention_op", "grouped_matmul_op"]


def flash_attention_op(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, causal=True,
                       window=None):
    """Segment flash attention, differentiable in q, k and v (forward and
    backward kernels on CUDA, plain versions on CPU); returns out
    [B, H, Tq, D]."""
    out, _ = FlashAttention.apply(q, k, v, q_seg, kv_seg, q_pos, kv_pos, bool(causal),
                                  None if window is None else int(window))
    return out


def grouped_matmul_op(x, w, group_offsets, *, block_m=128, block_n=128):
    """Grouped expert product ``x [M, K] @ w[group] [E, K, N]`` over sorted
    expert row groups (``group_offsets [E + 1]`` int32; rows at or past
    ``group_offsets[E]`` give 0), differentiable in x and w (gmm / tgmm
    kernels on CUDA, plain versions on CPU).  Refuses what the JAX
    package's ``grouped_matmul`` refuses, blocks included."""
    check_grouped_args(x, w, group_offsets, block_m=block_m, block_n=block_n)
    return GroupedMatmul.apply(x, w, group_offsets.to(torch.int32))
