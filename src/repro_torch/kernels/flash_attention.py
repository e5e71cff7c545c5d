"""Segment-aware flash attention forward: the CUDA kernel and its plain
PyTorch version (``repro.kernels.flash_attention`` in the port).

Layout as in the JAX package: q ``[B, H, Tq, D]``, k/v ``[B, Hkv, Tkv,
D]`` (q head h reads KV head ``h // (H // Hkv)``), seg/pos ``[B, T]``
int32 with segment 0 = padding.  Both versions return ``(out, lse)``:
out in the dtype of q, lse ``[B, H, Tq]`` fp32, 0 on fully-masked rows.

* :func:`flash_attention_plain` -- dense fp32 math over the whole score
  matrix.  The CPU path and the tests use it; on the card it is the
  yardstick the kernel is held against.
* :func:`flash_attention_fwd` -- the hand-written CUDA kernel
  ``csrc/flash_fwd.cu``, which replaces the Pallas ``_fwd_kernel``
  (``src/repro/kernels/flash_attention.py:181``).  CUDA tensors only.

Block skipping: :func:`tile_stats` / :func:`live_tile_mask` are the JAX
package's interval rules, in torch.  The kernel wrapper evaluates them at
the kernel's own tile sizes and compacts each (stream, Q tile) row of the
mask into a list of live KV-tile indices plus a count, with device ops
only (no host sync), so the kernel walks live tiles and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.utils import round_up

__all__ = [
    "NEG_INF",
    "count_live_tiles",
    "flash_attention_fwd",
    "flash_attention_plain",
    "kernel_blocks",
    "live_tile_mask",
    "live_tile_lists",
    "make_segment_mask",
    "tile_skip_fraction",
    "tile_stats",
]

NEG_INF = -(2.0**30)
_BIG = 2**30


# ----------------------------------------------------------------------
# Block-skip precomputation.
# ----------------------------------------------------------------------
def tile_stats(seg: torch.Tensor, pos: torch.Tensor, block: int) -> dict:
    """Interval summaries per tile of a packed stream.

    seg, pos: [B, T] int32 (seg 0 = padding), T a multiple of ``block``.
    Returns a dict of [B, T // block] tensors: smin/smax/pmin/pmax over
    valid entries and ``any`` (tile has at least one valid token)."""
    B, T = seg.shape
    n = T // block
    s = seg.reshape(B, n, block)
    p = pos.reshape(B, n, block)
    valid = s > 0
    big = torch.full_like(s, _BIG)
    neg = torch.full_like(s, -1)
    return {
        "smin": torch.where(valid, s, big).amin(dim=-1),
        "smax": torch.where(valid, s, neg).amax(dim=-1),
        "pmin": torch.where(valid, p, big).amin(dim=-1),
        "pmax": torch.where(valid, p, neg).amax(dim=-1),
        "any": valid.any(dim=-1),
    }


def live_tile_mask(q_seg, kv_seg, q_pos, kv_pos, *, block_q: int, block_kv: int,
                   causal: bool, window: int | None) -> torch.Tensor:
    """[B, nQ, nK] bool: True where the (Q tile, KV tile) pair may hold at
    least one unmasked score.  A pair is dead when either tile has no
    valid token, their segment intervals are disjoint, every key lies in
    the causal future, or every key fell out of the window."""
    qs = tile_stats(q_seg, q_pos, block_q)
    ks = tile_stats(kv_seg, kv_pos, block_kv)
    live = qs["any"][:, :, None] & ks["any"][:, None, :]
    live &= qs["smin"][:, :, None] <= ks["smax"][:, None, :]
    live &= ks["smin"][:, None, :] <= qs["smax"][:, :, None]
    if causal:
        live &= ks["pmin"][:, None, :] <= qs["pmax"][:, :, None]
    if window is not None:
        live &= qs["pmin"][:, :, None] - ks["pmax"][:, None, :] < window
    return live


def count_live_tiles(q_seg, kv_seg, q_pos, kv_pos, *, block_q, block_kv, causal,
                     window) -> tuple[int, int]:
    """(visited, total) KV-tile visits for ONE head's pass, summed over
    the streams of the batch (every head of a stream visits the same
    tiles)."""
    live = live_tile_mask(q_seg, kv_seg, q_pos, kv_pos, block_q=block_q,
                          block_kv=block_kv, causal=causal, window=window)
    return int(live.sum()), live.numel()


def tile_skip_fraction(q_seg, kv_seg, q_pos, kv_pos, *, block_q, block_kv, causal,
                       window) -> float:
    """Fraction of (Q tile, KV tile) pairs skipped on this batch."""
    visited, total = count_live_tiles(
        q_seg, kv_seg, q_pos, kv_pos, block_q=block_q, block_kv=block_kv,
        causal=causal, window=window)
    return 1.0 - visited / total if total else 0.0


# ----------------------------------------------------------------------
# Plain version.
# ----------------------------------------------------------------------
def make_segment_mask(q_seg, kv_seg, q_pos, kv_pos, *, causal: bool,
                      window: int | None) -> torch.Tensor:
    """Boolean [.., Tq, Tkv] mask, True = attend: same segment, segment
    > 0, and (causal) no key in the future, (window) none out of it."""
    same = (q_seg[..., :, None] == kv_seg[..., None, :]) & (q_seg[..., :, None] > 0)
    if causal:
        same &= kv_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        same &= q_pos[..., :, None] - kv_pos[..., None, :] < window
    return same


def flash_attention_plain(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                          causal: bool = True, window: int | None = None):
    """Dense fp32 attention with the kernel's mask and zero rules.
    Returns (out [B,H,Tq,D] in q's dtype, lse [B,H,Tq] fp32)."""
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Hkv, g, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(D))
    mask = make_segment_mask(q_seg, kv_seg, q_pos, kv_pos, causal=causal,
                             window=window)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l_safe[..., None]
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.zeros_like(l))
    return out.reshape(B, H, Tq, D).to(q.dtype), lse.reshape(B, H, Tq)


# ----------------------------------------------------------------------
# CUDA kernel.
# ----------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load("flash_fwd.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [vp] * 11 + [i32] * 10 + [ctypes.c_float, i32, vp]
    lib.flash_fwd.restype = i32
    lib.flash_fwd_block_q.restype = i32
    lib.flash_fwd_block_kv.restype = i32
    return lib


def kernel_blocks() -> tuple[int, int]:
    """The kernel's (query, KV) tile sizes, read from the built library."""
    lib = _lib()
    return lib.flash_fwd_block_q(), lib.flash_fwd_block_kv()


def live_tile_lists(q_seg, kv_seg, q_pos, kv_pos, *, block_q, block_kv, causal,
                    window):
    """``live_tile_mask`` compacted per (stream, Q tile): returns
    (count [B, nQ] int32, idx [B, nQ, nK] int32) where ``idx[b, i, :count]``
    are the live KV-tile indices in ascending order.  T need not divide
    by the blocks: the tail tile is padded with segment 0.  Device ops
    only; nothing is read back to the host."""
    Tq, Tkv = q_seg.shape[1], kv_seg.shape[1]
    pq, pk = round_up(Tq, block_q) - Tq, round_up(Tkv, block_kv) - Tkv
    live = live_tile_mask(F.pad(q_seg, (0, pq)), F.pad(kv_seg, (0, pk)),
                          F.pad(q_pos, (0, pq)), F.pad(kv_pos, (0, pk)),
                          block_q=block_q, block_kv=block_kv, causal=causal,
                          window=window)
    nK = live.shape[-1]
    tiles = torch.arange(nK, dtype=torch.int32, device=live.device)
    idx = torch.where(live, tiles, nK).sort(dim=-1).values
    return live.sum(dim=-1, dtype=torch.int32), idx.to(torch.int32).contiguous()


def flash_attention_fwd(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                        causal: bool = True, window: int | None = None):
    """Launch the CUDA kernel (``csrc/flash_fwd.cu``) on the current
    stream.  Same arguments and results as :func:`flash_attention_plain`;
    q/k/v contiguous, one dtype (fp32 or bf16), D in {64, 128}.  Counts
    each launch in ``flash_attention_fwd.launches``."""
    B, H, Tq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    Hkv, Tkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not a multiple of kv heads {Hkv}")
    tensors = (q, k, v, q_seg, kv_seg, q_pos, kv_pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_attention_fwd needs every tensor on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one "
                         f"of {list(_DTYPE_CODES)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for name, t, T in (("q_seg", q_seg, Tq), ("kv_seg", kv_seg, Tkv),
                       ("q_pos", q_pos, Tq), ("kv_pos", kv_pos, Tkv)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, T):
            raise ValueError(f"{name} must be int32 [{B}, {T}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_fwd needs contiguous tensors")

    bq, bk = kernel_blocks()
    count, idx = live_tile_lists(q_seg, kv_seg, q_pos, kv_pos, block_q=bq,
                                 block_kv=bk, causal=causal, window=window)
    return _launch(q, k, v, q_seg, kv_seg, q_pos, kv_pos, count, idx,
                   causal=causal, window=window)


def _launch(q, k, v, q_seg, kv_seg, q_pos, kv_pos, count, idx, *, causal, window):
    """The bare launch behind :func:`flash_attention_fwd`, on inputs it has
    checked and live-tile lists from :func:`live_tile_lists` at
    :func:`kernel_blocks`.  Allocates the outputs, launches on the current
    stream, raises on a launch error, and counts the launch."""
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    rc = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
        kv_seg.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), count.data_ptr(),
        idx.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hkv, Tq, Tkv, D,
        idx.shape[1], idx.shape[2], int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
