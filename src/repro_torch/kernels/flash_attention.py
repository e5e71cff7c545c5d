"""Segment-aware flash attention, forward and backward: the CUDA kernels,
their plain PyTorch versions and the ``autograd.Function`` that joins
them (``repro.kernels.flash_attention`` in the port).

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
  bf16 runs in one of two modes (:func:`fwd_mode`): ``"packed"`` when a
  GQA group's ``H // Hkv * Tq`` query rows fit one tile (decode: one
  block per stream and KV head, K/V read once per group), else
  ``"tiled"``; fp32 is always tiled.
* :func:`flash_attention_bwd_plain` / :func:`flash_attention_bwd` -- the
  backward: ``delta = rowsum(do * o)`` in fp32, then dq from
  ``csrc/flash_bwd.cu``'s dq kernel (replaces ``_dq_kernel``, :226) and
  dk/dv from its dkv kernel (replaces ``_dkv_kernel``, :261).
* :class:`FlashAttention` -- the differentiable op: the kernels on CUDA
  tensors, the plain versions on CPU tensors; no gradient for seg/pos.

Block skipping: :func:`tile_stats` / :func:`live_tile_mask` are the JAX
package's interval rules, in torch.  The kernel wrapper evaluates them at
the kernel's own tile sizes and compacts each (stream, Q tile) row of the
mask into a list of live KV-tile indices plus a count, with device ops
only (no host sync), so the kernel walks live tiles and nothing else.
Every kernel has tiles of its own, per dtype, read from the built
library: :func:`kernel_blocks` for the forward (per mode;
:func:`fwd_tile_lists`), :func:`bwd_blocks` for the backward, where
:func:`bwd_tile_lists` makes the dq kernel's lists at dq's tiles and the
dkv kernel's at dkv's, transposed to one list of live Q tiles per
(stream, KV tile).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.utils import round_up

__all__ = [
    "FlashAttention",
    "NEG_INF",
    "bwd_blocks",
    "bwd_tile_lists",
    "count_live_tiles",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "flash_attention_plain",
    "fwd_mode",
    "fwd_tile_lists",
    "kernel_blocks",
    "live_tile_mask",
    "live_tile_lists",
    "make_segment_mask",
    "pad_head_dim",
    "padded_head_dim",
    "tile_skip_fraction",
    "tile_stats",
    "transpose_tile_lists",
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
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None):
    """Dense fp32 attention with the kernel's mask and zero rules; scores
    scaled by ``scale`` (default ``1 / sqrt(D)``).  One stream at a time,
    to bound the score matrices' memory.  Returns (out [B,H,Tq,D] in q's
    dtype, lse [B,H,Tq] fp32)."""
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    for b in range(B):
        qf = q[b].float().reshape(Hkv, g, Tq, D)
        s = torch.einsum("hgqd,hkd->hgqk", qf, k[b].float()) * scale
        mask = make_segment_mask(q_seg[b], kv_seg[b], q_pos[b], kv_pos[b], causal=causal,
                                 window=window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * mask
        l = p.sum(dim=-1)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        o = torch.einsum("hgqk,hkd->hgqd", p, v[b].float()) / l_safe[..., None]
        out[b] = o.reshape(H, Tq, D).to(q.dtype)
        lse[b] = torch.where(l > 0, m + torch.log(l_safe), torch.zeros_like(l)).reshape(H, Tq)
    return out, lse


def flash_attention_bwd_plain(q, k, v, do, out, lse, q_seg, kv_seg, q_pos, kv_pos, *,
                              causal: bool = True, window: int | None = None,
                              scale: float | None = None):
    """Dense fp32 backward with the kernels' rules: ``p = exp(s - lse)``
    on unmasked scores and exactly 0 elsewhere (fully-masked rows give
    zero gradients), ``delta = rowsum(do * o)``, ``ds = p (dp - delta)
    scale`` (``scale`` default ``1 / sqrt(D)``).  One stream at a time, to
    bound the score matrices' memory.  Returns (dq, dk, dv) in the dtypes
    of q, k, v."""
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    delta = (do.float() * out.float()).sum(-1)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        qf = q[b].float().reshape(Hkv, g, Tq, D)
        dof = do[b].float().reshape(Hkv, g, Tq, D)
        kf, vf = k[b].float(), v[b].float()
        mask = make_segment_mask(q_seg[b], kv_seg[b], q_pos[b], kv_pos[b],
                                 causal=causal, window=window)
        s = torch.einsum("hgqd,hkd->hgqk", qf, kf) * scale
        p = torch.where(mask, torch.exp(s - lse[b].reshape(Hkv, g, Tq, 1)),
                        torch.zeros_like(s))
        dp = torch.einsum("hgqd,hkd->hgqk", dof, vf)
        ds = p * (dp - delta[b].reshape(Hkv, g, Tq, 1)) * scale
        dq[b] = torch.einsum("hgqk,hkd->hgqd", ds, kf).reshape(H, Tq, D)
        dk[b] = torch.einsum("hgqk,hgqd->hkd", ds, qf)
        dv[b] = torch.einsum("hgqk,hgqd->hkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# CUDA kernel.
# ----------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def padded_head_dim(D: int) -> int:
    """The head dim the kernels run a head dim ``D`` at: the smallest
    instantiated size at or above it (32 -> 64; 80, 100, 120 -> 128).
    Zero columns are exact: padded q/k columns add 0 to every score,
    padded v columns give output columns that are sliced off, and the
    scale stays the true D's (the callers pass it).  Raises above 128."""
    for size in _HEAD_DIMS:
        if D <= size:
            return size
    raise ValueError(f"head_dim {D} above the kernels' largest, {_HEAD_DIMS[-1]}")


def pad_head_dim(tensors, *more: int) -> tuple[list[torch.Tensor], float]:
    """The kernels' operands for q/k/v (and dO) at their true head dim D
    (the last dim): each zero-padded to :func:`padded_head_dim` ``(D)``,
    ``more`` padding the outer dims as ``F.pad``'s pairs do, and the scale
    ``1 / sqrt(D)`` that every launch on the padded operands is given.
    The one place the rule lives: the flash backend's ``_flash`` and the
    smoke script's kernel cases both call it."""
    D = tensors[0].shape[-1]
    pad = (0, padded_head_dim(D) - D, *more)
    return [F.pad(t, pad) for t in tensors], 1.0 / math.sqrt(D)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load("flash_fwd.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [vp] * 11 + [i32] * 10 + [ctypes.c_float, i32, i32, vp]
    lib.flash_fwd_block_q.argtypes = lib.flash_fwd_block_kv.argtypes = [i32, i32]
    for fn in (lib.flash_fwd, lib.flash_fwd_block_q, lib.flash_fwd_block_kv):
        fn.restype = i32
    return lib


_FWD_MODES = ("tiled", "packed")


@functools.lru_cache(maxsize=None)
def kernel_blocks(dtype: torch.dtype) -> dict[str, tuple[int, int]]:
    """The forward kernel's own tiles for ``dtype``, read from the built
    library: ``{"tiled": (bq, bk), "packed": (rows, bk)}``, where
    ``rows`` is the most ``H // Hkv * Tq`` query rows of a GQA group one
    packed block holds (0: the dtype has no packed mode)."""
    lib, code = _lib(), _DTYPE_CODES[dtype]
    return {mode: (lib.flash_fwd_block_q(i, code), lib.flash_fwd_block_kv(i, code))
            for i, mode in enumerate(_FWD_MODES)}


def fwd_mode(H: int, Hkv: int, Tq: int, blocks: dict) -> str:
    """``"packed"`` when a GQA group's ``H // Hkv * Tq`` query rows fit one
    packed tile of ``blocks`` (:func:`kernel_blocks`): q and out are then
    viewed as ``[B * Hkv, g * Tq, D]`` and one block per (stream, KV head)
    reads its K/V once for the whole group.  Otherwise ``"tiled"``."""
    return "packed" if 0 < H // Hkv * Tq <= blocks["packed"][0] else "tiled"


def fwd_tile_lists(q_seg, kv_seg, q_pos, kv_pos, *, mode, blocks, causal, window):
    """The lists the forward walks in ``mode``: :func:`live_tile_lists` at
    the tiled mode's tiles, or, packed, at one Q tile of all Tq rows per
    stream (every head of a group shares the stream's seg/pos).  Device
    ops only."""
    bq = q_seg.shape[1] if mode == "packed" else blocks["tiled"][0]
    return live_tile_lists(q_seg, kv_seg, q_pos, kv_pos, block_q=bq,
                           block_kv=blocks[mode][1], causal=causal, window=window)


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
    return _compact(live)


def _compact(live: torch.Tensor):
    """[B, n, m] bool -> (count [B, n] int32, idx [B, n, m] int32): the
    True columns of each row in ascending order, padded with m."""
    m = live.shape[-1]
    cols = torch.arange(m, dtype=torch.int32, device=live.device)
    idx = torch.where(live, cols, m).sort(dim=-1).values
    return live.sum(dim=-1, dtype=torch.int32), idx.to(torch.int32).contiguous()


def transpose_tile_lists(idx):
    """The per-(stream, Q tile) lists of :func:`live_tile_lists` turned
    into per-(stream, KV tile) lists of live Q tiles: (count [B, nK],
    idx [B, nK, nQ]), the lists the dkv kernel walks.  The padding
    entries of ``idx`` (index nK) land in a column that is cut off."""
    B, nQ, nK = idx.shape
    live = torch.zeros((B, nQ, nK + 1), dtype=torch.bool, device=idx.device)
    live.scatter_(2, idx.long(), True)
    return _compact(live[..., :nK].transpose(1, 2))


def _check(name, q, k, v, ints, more=()):
    """The kernels' input contract: one CUDA device, contiguous, q/k/v
    (and ``more``, shaped like q) in one dtype of fp32/bf16, D in
    {64, 128}, seg/pos int32 [B, T]."""
    B, H, Tq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    Hkv, Tkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not a multiple of kv heads {Hkv}")
    tensors = (q, k, v, *more, *ints)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError(f"{name}: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         f"one of {list(_DTYPE_CODES)}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: do/out must have q's shape {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for label, t, T in zip(("q_seg", "kv_seg", "q_pos", "kv_pos"), ints,
                           (Tq, Tkv, Tq, Tkv)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, T):
            raise ValueError(f"{label} must be int32 [{B}, {T}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def _window_arg(window) -> int:
    return -1 if window is None else int(window)


def _scale_arg(scale, D) -> float:
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def flash_attention_fwd(q, k, v, q_seg, kv_seg, q_pos, kv_pos, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None):
    """Launch the CUDA kernel (``csrc/flash_fwd.cu``) on the current
    stream.  Same arguments and results as :func:`flash_attention_plain`;
    q/k/v contiguous, one dtype (fp32 or bf16), D in {64, 128} (other
    head dims arrive zero-padded, :func:`padded_head_dim`).  Picks
    the mode (:func:`fwd_mode`) and builds its lists from seg/pos.  Counts
    each launch in ``flash_attention_fwd.launches``."""
    ints = (q_seg, kv_seg, q_pos, kv_pos)
    _check("flash_attention_fwd", q, k, v, ints)
    blocks = kernel_blocks(q.dtype)
    mode = fwd_mode(q.shape[1], k.shape[1], q.shape[2], blocks)
    count, idx = fwd_tile_lists(*ints, mode=mode, blocks=blocks, causal=causal,
                                window=window)
    return _launch(q, k, v, *ints, count, idx, mode=mode, causal=causal, window=window,
                   scale=scale)


def _launch(q, k, v, q_seg, kv_seg, q_pos, kv_pos, count, idx, *, mode, causal, window,
            scale=None):
    """The bare launch behind :func:`flash_attention_fwd`, on inputs it has
    checked and the lists of :func:`fwd_tile_lists` in ``mode``.
    Allocates the outputs, launches on the current stream, raises on a
    launch error, and counts the launch."""
    B, H, Tq, D = q.shape
    Hkv, Tkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    rc = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
        kv_seg.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), count.data_ptr(),
        idx.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hkv, Tq, Tkv, D,
        idx.shape[1], idx.shape[2], int(causal), _window_arg(window),
        _scale_arg(scale, D), _FWD_MODES.index(mode), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


# ----------------------------------------------------------------------
# CUDA backward kernels (csrc/flash_bwd.cu).
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load("flash_bwd.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_bwd_dq.argtypes = [vp] * 13 + [i32] * 10 + [ctypes.c_float, i32, vp]
    lib.flash_bwd_dkv.argtypes = [vp] * 14 + [i32] * 10 + [ctypes.c_float, i32, vp]
    lib.flash_bwd_block_q.argtypes = lib.flash_bwd_block_kv.argtypes = [i32, i32]
    for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv, lib.flash_bwd_block_q,
               lib.flash_bwd_block_kv):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def bwd_blocks(dtype: torch.dtype) -> dict[str, tuple[int, int]]:
    """The backward kernels' own (query, KV) tile sizes for ``dtype``, read
    from the built library: ``{"dq": (bq, bk), "dkv": (bq, bk)}``."""
    lib, code = _bwd_lib(), _DTYPE_CODES[dtype]
    return {name: (lib.flash_bwd_block_q(i, code), lib.flash_bwd_block_kv(i, code))
            for i, name in enumerate(("dq", "dkv"))}


def bwd_tile_lists(q_seg, kv_seg, q_pos, kv_pos, *, dq_blocks, dkv_blocks, causal,
                   window):
    """The lists the backward kernels walk: ``(count, idx)`` of
    :func:`live_tile_lists` at the dq kernel's tiles ``dq_blocks``, and
    ``(t_count, t_idx)``, the :func:`transpose_tile_lists` of the lists at
    the dkv kernel's tiles ``dkv_blocks``.  Device ops only."""
    kw = dict(causal=causal, window=window)
    count, idx = live_tile_lists(q_seg, kv_seg, q_pos, kv_pos, block_q=dq_blocks[0],
                                 block_kv=dq_blocks[1], **kw)
    _, idx_kv = live_tile_lists(q_seg, kv_seg, q_pos, kv_pos, block_q=dkv_blocks[0],
                                block_kv=dkv_blocks[1], **kw)
    return count, idx, *transpose_tile_lists(idx_kv)


def _bwd_args(q, k, v, do, lse, delta, ints):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in ints))


def _bwd_dims(q, k, idx, causal, window, scale):
    B, H, Tq, D = q.shape
    return (B, H, k.shape[1], Tq, k.shape[2], D, idx.shape[1], idx.shape[2],
            int(causal), _window_arg(window), _scale_arg(scale, D),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_dq(q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos, count,
                       idx, *, causal, window, scale=None):
    """Launch the dq kernel on checked inputs, walking the per-(stream,
    Q tile) lists ``count``/``idx`` made at the dq kernel's tiles
    (:func:`bwd_tile_lists`); returns dq in q's dtype.  Counts each
    launch in ``flash_attention_dq.launches``."""
    dq = torch.empty_like(q)
    rc = _bwd_lib().flash_bwd_dq(
        *_bwd_args(q, k, v, do, lse, delta, (q_seg, kv_seg, q_pos, kv_pos)),
        count.data_ptr(), idx.data_ptr(), dq.data_ptr(),
        *_bwd_dims(q, k, idx, causal, window, scale))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed with cudaError {rc}")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos,
                        t_count, t_idx, *, causal, window, scale=None):
    """Launch the dkv kernel on checked inputs, walking the per-(stream,
    KV tile) lists ``t_count``/``t_idx`` made at the dkv kernel's tiles
    (:func:`bwd_tile_lists`); returns (dk, dv) in k's dtype, each KV
    head's GQA group summed in the block.  Counts each launch in
    ``flash_attention_dkv.launches``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_lib().flash_bwd_dkv(
        *_bwd_args(q, k, v, do, lse, delta, (q_seg, kv_seg, q_pos, kv_pos)),
        t_count.data_ptr(), t_idx.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_dims(q, k, t_idx.transpose(1, 2), causal, window, scale))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed with cudaError {rc}")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, do, out, lse, q_seg, kv_seg, q_pos, kv_pos, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None):
    """The CUDA backward.  Same arguments and results as
    :func:`flash_attention_bwd_plain`.  Builds each kernel's live-tile
    lists at its own tiles (:func:`bwd_blocks`) from seg/pos; ``delta``
    is computed in fp32 outside the kernels, as the JAX package does."""
    ints = (q_seg, kv_seg, q_pos, kv_pos)
    do = do.contiguous()
    _check("flash_attention_bwd", q, k, v, ints, more=(do, out))
    blocks = bwd_blocks(q.dtype)
    count, idx, t_count, t_idx = bwd_tile_lists(
        *ints, dq_blocks=blocks["dq"], dkv_blocks=blocks["dkv"], causal=causal,
        window=window)
    delta = (do.float() * out.float()).sum(-1)
    kw = dict(causal=causal, window=window, scale=scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, *ints, count, idx, **kw)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, *ints, t_count, t_idx, **kw)
    return dq, dk, dv


# ----------------------------------------------------------------------
# The differentiable op.
# ----------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """Segment flash attention with its backward: B1 forward, then the dq
    and dkv kernels on CUDA tensors; the plain versions on CPU tensors.
    Saves out and lse for the backward, which builds its own live-tile
    lists from seg/pos; seg/pos get no gradient.  ``scale`` None is
    ``1 / sqrt(D)``."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale=None):
        ints = (q_seg, kv_seg, q_pos, kv_pos)
        kw = dict(causal=causal, window=window, scale=scale)
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, *ints, **kw)
        elif q.device.type == "cuda":
            out, lse = flash_attention_fwd(q, k, v, *ints, **kw)
        else:
            raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
        ctx.save_for_backward(q, k, v, *ints, out, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, *ints, out, lse = ctx.saved_tensors  # unpack once (checkpoint recomputes)
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, do, out, lse, *ints, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None
