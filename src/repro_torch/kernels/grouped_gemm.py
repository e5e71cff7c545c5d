"""Grouped GEMM for MoE expert dispatch: the CUDA kernels, their plain
PyTorch versions and the ``autograd.Function`` that joins them
(``repro.kernels.grouped_gemm`` in the port).

Rows of ``x [M, K]`` are sorted by expert: row ``m`` belongs to expert
``e`` iff ``offsets[e] <= m < offsets[e + 1]`` (``offsets [E + 1]``
int32, ascending from 0, ``offsets[E] <= M``); rows at or beyond
``offsets[E]`` are padding and give exactly 0.

* :func:`grouped_matmul_plain` / :func:`tgmm_plain` -- fp32 math over
  each expert's row range.  The CPU path and the tests use them; on the
  card they are the yardstick the kernels are held against (they read the
  offsets back to the host, which the kernels never do).
* :func:`gmm` -- ``csrc/grouped_gemm.cu``'s gmm kernel, which replaces the
  Pallas ``_gmm_kernel`` (``src/repro/kernels/grouped_gemm.py:56``):
  ``out = x @ w[group]``, or with ``transpose_w`` ``x @ w[group]^T`` (the
  dx of the forward product).  CUDA tensors only.
* :func:`tgmm` -- its tgmm kernel, which replaces ``_tgmm_kernel``
  (:105): ``dw[e] = x[group e]^T @ dy[group e]``.
* :func:`gmm_tile_schedule` / :func:`tgmm_split_plan` -- the bf16
  kernels' schedules in plain Python: gmm's expert-aligned tiles and
  tgmm's split of an expert's row walk, as the kernels build them on the
  device from the offsets.
* :class:`GroupedMatmul` -- the differentiable product: the kernels on
  CUDA tensors, the plain versions on CPU tensors; no gradient for the
  offsets.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = [
    "GroupedMatmul",
    "check_grouped_args",
    "count_live_group_tiles",
    "gmm",
    "gmm_tile_schedule",
    "group_tile_skip_fraction",
    "grouped_matmul_plain",
    "kernel_block_m",
    "kernel_block_n",
    "tgmm",
    "tgmm_plain",
    "tgmm_split_plan",
    "tgmm_workspace_bytes",
    "tgmm_workspace_slots",
]


def check_grouped_args(x, w, offsets, *, block_m: int = 128, block_n: int = 128):
    """The JAX package's ``grouped_matmul`` checks: x [M, K], w [E, K, N],
    offsets [E + 1], and M, N multiples of the (clamped) blocks.  The
    CUDA kernel keeps its own tile sizes; the blocks are checked so that
    the two packages accept and refuse the same calls."""
    M, K = x.shape
    E, Kw, N = w.shape
    if Kw != K:
        raise ValueError(f"x K={K} != w K={Kw}")
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != ({E + 1},)")
    bm, bn = min(block_m, M), min(block_n, N)
    if M % bm or N % bn:
        raise ValueError(f"M={M} % {bm} or N={N} % {bn} != 0")


# ----------------------------------------------------------------------
# Plain versions.
# ----------------------------------------------------------------------
def grouped_matmul_plain(x, w, offsets, *, transpose_w: bool = False):
    """``out[m] = x[m] @ w[e]`` (``w[e]^T`` with ``transpose_w``) for every
    row of expert e, in fp32; padding rows 0.  Returns [M, N] in x's
    dtype."""
    bounds = offsets.tolist()
    N = w.shape[1] if transpose_w else w.shape[2]
    out = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if hi > lo:
            we = w[e].float()
            out[lo:hi] = x[lo:hi].float() @ (we.T if transpose_w else we)
    return out.to(x.dtype)


def tgmm_plain(x, dy, offsets, n_experts: int):
    """``dw[e] = x[rows of e]^T @ dy[rows of e]`` in fp32, empty experts
    0.  Returns [E, K, N] in x's dtype."""
    bounds = offsets.tolist()
    dw = torch.zeros((n_experts, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if hi > lo:
            dw[e] = x[lo:hi].float().T @ dy[lo:hi].float()
    return dw.to(x.dtype)


# ----------------------------------------------------------------------
# CUDA kernels.
# ----------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load("grouped_gemm.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gmm.argtypes = [vp] * 4 + [i32] * 6 + [vp]
    lib.tgmm.argtypes = [vp] * 5 + [i32] * 5 + [vp]
    lib.grouped_gemm_block_m.argtypes = [i32]
    lib.grouped_gemm_block_n.argtypes = [i32]
    lib.tgmm_workspace_bytes.argtypes = [i32] * 5
    for fn in (lib.gmm, lib.tgmm, lib.grouped_gemm_block_m, lib.grouped_gemm_block_n):
        fn.restype = i32
    lib.tgmm_workspace_bytes.restype = ctypes.c_longlong
    return lib


def kernel_block_m(dtype: torch.dtype) -> int:
    """Rows of the gmm kernel's m-tile for ``dtype``, read from the built
    library (the tile of :func:`group_tile_skip_fraction`)."""
    return _lib().grouped_gemm_block_m(_DTYPE_CODES[dtype])


def kernel_block_n(dtype: torch.dtype) -> int:
    """Columns of the kernels' output tile for ``dtype``, read from the
    built library."""
    return _lib().grouped_gemm_block_n(_DTYPE_CODES[dtype])


def tgmm_workspace_bytes(M: int, K: int, N: int, n_experts: int, dtype: torch.dtype) -> int:
    """Bytes of the workspace the tgmm kernel takes for these shapes on the
    current card, read from the built library (0 for fp32)."""
    return _lib().tgmm_workspace_bytes(M, K, N, n_experts, _DTYPE_CODES[dtype])


def _check_cuda(name, tensors, offsets):
    """The kernels' input contract: one CUDA device, contiguous, 16-byte
    aligned, one dtype of fp32/bf16, int32 offsets on the same device."""
    first = tensors[0]
    if not all(t.is_cuda and t.device == first.device for t in (*tensors, offsets)):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if first.dtype not in _DTYPE_CODES or any(t.dtype != first.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}: need one of "
                         f"{list(_DTYPE_CODES)}")
    if offsets.dtype != torch.int32:
        raise ValueError(f"{name}: offsets must be int32, got {offsets.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (*tensors, offsets)):
        raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gmm(x, w, offsets, *, transpose_w: bool = False):
    """Launch the gmm kernel on the current stream: x [M, K], w [E, K, N]
    (or, with ``transpose_w``, w [E, N, K] multiplied transposed),
    offsets [E + 1] int32 on the device.  Returns out [M, N] in x's
    dtype.  K and N multiples of 8.  Counts each launch in
    ``gmm.launches``."""
    _check_cuda("gmm", (x, w), offsets)
    M, K = x.shape
    E = w.shape[0]
    N, Kw = (w.shape[1], w.shape[2]) if transpose_w else (w.shape[2], w.shape[1])
    if Kw != K or tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)}, offsets "
                         f"{tuple(offsets.shape)} do not match")
    if K % 8 or N % 8:
        raise ValueError(f"gmm: K={K} and N={N} must be multiples of 8")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib().gmm(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), M, K,
                    N, E, int(transpose_w), _DTYPE_CODES[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"gmm launch failed with cudaError {rc}")
    gmm.launches += 1
    return out


def tgmm(x, dy, offsets, n_experts: int):
    """Launch the tgmm kernel on the current stream: x [M, K], dy [M, N],
    offsets [E + 1] int32 on the device.  Returns dw [E, K, N] in x's
    dtype.  Counts each launch in ``tgmm.launches``."""
    _check_cuda("tgmm", (x, dy), offsets)
    (M, K), N = x.shape, dy.shape[1]
    if dy.shape[0] != M or tuple(offsets.shape) != (n_experts + 1,):
        raise ValueError(f"tgmm: x {tuple(x.shape)}, dy {tuple(dy.shape)}, offsets "
                         f"{tuple(offsets.shape)} do not match")
    if K % 8 or N % 8:
        raise ValueError(f"tgmm: K={K} and N={N} must be multiples of 8")
    dw = torch.empty((n_experts, K, N), dtype=x.dtype, device=x.device)
    # fp32 partials of the pieces of split experts (bf16 only), sized from
    # the shapes alone: the split itself is decided on the device.
    ws_bytes = tgmm_workspace_bytes(M, K, N, n_experts, x.dtype)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device) if ws_bytes else None
    rc = _lib().tgmm(x.data_ptr(), dy.data_ptr(), offsets.data_ptr(), dw.data_ptr(),
                     None if ws is None else ws.data_ptr(), M, K, N, n_experts,
                     _DTYPE_CODES[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"tgmm launch failed with cudaError {rc}")
    tgmm.launches += 1
    return dw


gmm.launches = 0
tgmm.launches = 0


# ----------------------------------------------------------------------
# The differentiable op.
# ----------------------------------------------------------------------
class GroupedMatmul(torch.autograd.Function):
    """``out = x @ w[group]`` with its backward (the JAX package's
    ``_make_diff_gmm``): ``dx = gmm(dy, w^T)`` and ``dw = tgmm(x, dy)``,
    each cast back to its input's dtype; no gradient for the offsets."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        if x.device.type == "cpu":
            return grouped_matmul_plain(x, w, offsets)
        if x.device.type == "cuda":
            return gmm(x.contiguous(), w.contiguous(), offsets)
        raise ValueError(f"grouped matmul runs on cpu or cuda, not {x.device}")

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if x.device.type == "cpu":
            dx = grouped_matmul_plain(dy, w, offsets, transpose_w=True)
            dw = tgmm_plain(x, dy, offsets, w.shape[0])
        else:
            dy = dy.contiguous()
            dx = gmm(dy, w.contiguous(), offsets, transpose_w=True)
            dw = tgmm(x.contiguous(), dy, offsets, w.shape[0])
        return dx.to(x.dtype), dw.to(w.dtype), None


# ----------------------------------------------------------------------
# Host-side accounting (numpy over routing counts already on the host).
# ----------------------------------------------------------------------
def count_live_group_tiles(group_sizes, block_m: int) -> int:
    """Number of (m-tile, expert) cells that hold rows of their expert
    for the given per-expert row counts, against the dense ``n_m_tiles *
    E`` sweep.  Mirrors the kernel's intersection test."""
    sizes = np.asarray(group_sizes, np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    live = 0
    for e in range(len(sizes)):
        if sizes[e] == 0:
            continue
        live += (offs[e + 1] - 1) // block_m - offs[e] // block_m + 1
    return int(live)


def group_tile_skip_fraction(group_sizes, block_m: int) -> float:
    """Fraction of the dense ``n_m_tiles * E`` grid that holds no rows for
    its expert -- the cells the kernel's walk skips."""
    sizes = np.asarray(group_sizes, np.int64)
    total_rows = int(sizes.sum())
    if total_rows == 0 or len(sizes) == 0:
        return 0.0
    n_m = -(-total_rows // block_m)  # ceil
    total = n_m * len(sizes)
    return 1.0 - count_live_group_tiles(sizes, block_m) / total if total else 0.0


def gmm_tile_schedule(group_sizes, block_m: int, n_tiles: int = 1, m_rows=None):
    """The bf16 gmm kernel's expert-aligned tiles in the order its
    persistent blocks walk them: each expert's m-tiles in expert order,
    each starting at the expert's first row plus a multiple of
    ``block_m`` (no tile straddles two experts), n-tiles fastest; then the
    zero tiles of the padding rows ``[offsets[E], m_rows)``, reported with
    expert E.  Tile t is found as the kernel finds it: the last expert
    whose prefix count of tiles is <= t.  Returns ``[(expert, row_start,
    n_tile)]``; its length is the kernel's tile count."""
    sizes = np.asarray(group_sizes, np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    E, routed = len(sizes), int(offs[-1])
    m_rows = routed if m_rows is None else int(m_rows)
    prefix = np.concatenate([[0], np.cumsum(-(-sizes // block_m))]) * n_tiles
    live = int(prefix[-1])
    total = live + -(-(m_rows - routed) // block_m) * n_tiles
    tiles = []
    for t in range(total):
        if t < live:
            e = int(np.searchsorted(prefix[:E], t, side="right")) - 1
            j, nt = divmod(t - int(prefix[e]), n_tiles)
        else:
            e = E
            j, nt = divmod(t - live, n_tiles)
        tiles.append((e, int(offs[e]) + j * block_m, nt))
    return tiles


def tgmm_split_plan(group_sizes, units_kn: int, grid: int, chunk: int = 64):
    """How the bf16 tgmm kernel splits each expert's walk over its rows:
    ``T = routed * units_kn / (4 * grid)`` rounded up to whole ``chunk``s
    (``units_kn`` output tiles an expert, ``grid`` the card's SM count);
    an expert of n rows walks ``ceil(n / T)`` pieces (1 when empty), and
    each piece of a split expert takes a workspace slot.  Returns
    ``(T, pieces per expert, slots used)``."""
    sizes = np.asarray(group_sizes, np.int64)
    routed = int(sizes.sum())
    t = -(-routed * units_kn // (4 * grid))
    t = max(chunk, -(-t // chunk) * chunk)
    pieces = np.where(sizes > 0, -(-sizes // t), 1)
    return t, pieces, int(pieces[pieces > 1].sum())


def tgmm_workspace_slots(units_kn: int, grid: int) -> int:
    """Workspace slots (each an fp32 [K, N]) the tgmm wrapper allocates:
    a split expert has n > T rows and so fewer than 2n / T pieces, and all
    of them fewer than ``2 * routed / T <= 8 * grid / units_kn``."""
    return -(-8 * grid // units_kn)
