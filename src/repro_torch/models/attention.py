"""Attention for packed (post-balanced) batches (``repro.models.attention``
in PyTorch).

Segment id 0 is padding; positive ids are example ids; positions
restart at 0 per example.  :func:`attention` selects a ``backend``:

  * ``reference``  full [Tq, Tkv] score matrix;
  * ``flash``      the segment flash-attention kernel behind the
                   model-level ``[B, T, H, D]`` calling convention
                   (``kernels.ops.flash_attention_op``: the CUDA kernel on
                   CUDA tensors, its plain version on CPU tensors).

Shapes: q [B,Tq,H,D]; k,v [B,Tkv,Hkv,D] with q head h reading KV head
``h // (H // Hkv)``; seg/pos [B,T*] int.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, make_segment_mask
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.utils import round_up

__all__ = ["ATTENTION_BACKENDS", "NEG_INF", "attention", "make_segment_mask"]

ATTENTION_BACKENDS = ("reference", "flash")


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _gqa_scores(q, k):
    """q [B,Tq,H,D], k [B,Tkv,Hkv,D] -> scores [B,H,Tq,Tkv]."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    q, k = _promote(q, k)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Tq, Hkv, H // Hkv, D), k)
    return s.reshape(B, H, Tq, k.shape[1])


def _gqa_out(p, v):
    """p [B,H,Tq,Tkv], v [B,Tkv,Hkv,D] -> [B,Tq,H,D]."""
    B, H, Tq, Tkv = p.shape
    Hkv = v.shape[2]
    p, v = _promote(p, v)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.reshape(B, Hkv, H // Hkv, Tq, Tkv), v)
    return o.reshape(B, Tq, H, v.shape[-1])


def _reference(q, k, v, mask, scale):
    s = _gqa_scores(q, k).float() * scale
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # Fully-masked rows (padding queries) -> zero output.
    p = torch.where(mask[:, None].any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return _gqa_out(p.to(q.dtype), v)


def _flash(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *, causal, window, block_q,
           block_kv):
    """The JAX package's ``_pallas_flash`` contract: pad T to tile
    multiples with segment 0 (masked out), run the kernel in the
    ``[B, H, T, D]`` layout, slice the padded query rows off.  K/V take
    q's dtype (a bf16 cache under an fp32 model converts exactly)."""
    B, Tq, H, D = q.shape
    Tkv = k.shape[1]
    bq = min(block_q, round_up(Tq, 8))
    bk = min(block_kv, round_up(Tkv, 8))
    pad_q = round_up(Tq, bq) - Tq
    pad_k = round_up(Tkv, bk) - Tkv

    def heads_first(x, n):
        return F.pad(x, (0, 0, 0, 0, 0, n)).transpose(1, 2).contiguous()

    def padt(x, n):
        return F.pad(x.to(torch.int32), (0, n))

    out = flash_attention_op(
        heads_first(q, pad_q), heads_first(k.to(q.dtype), pad_k),
        heads_first(v.to(q.dtype), pad_k),
        padt(q_seg, pad_q), padt(kv_seg, pad_k), padt(q_pos, pad_q),
        padt(kv_pos, pad_k),
        causal=causal, window=None if window is None else int(window))
    return out.transpose(1, 2)[:, :Tq]


def attention(q, k, v, *, q_seg, kv_seg, q_pos, kv_pos, causal: bool = True,
              window: int | None = None, backend: str = "reference",
              block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """Segment-aware GQA attention behind a selectable ``backend``.
    Returns [B,Tq,H,D]."""
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"n_heads {q.shape[2]} not multiple of kv heads {k.shape[2]}")
    if backend == "reference":
        mask = make_segment_mask(q_seg, kv_seg, q_pos, kv_pos, causal=causal,
                                 window=window)
        return _reference(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]))
    if backend == "flash":
        return _flash(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal=causal,
                      window=window, block_q=block_q, block_kv=block_kv)
    raise ValueError(f"unknown attention backend {backend!r}; the port runs "
                     f"{ATTENTION_BACKENDS}")
