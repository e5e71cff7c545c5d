"""Mamba-1 selective scan, forward and backward: the CUDA kernels, their
plain PyTorch versions and the ``autograd.Function`` that joins them
(``repro.kernels.selective_scan`` in the port).

Per stream, with ``keep_t`` false where a segment starts (the segment id
changes, ``seg == 0``, or ``t == 0``)::

    h_t = keep_t * exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t
    y_t = <h_t, C_t> + D u_t

Shapes as in the JAX package, with the streams batched in front instead
of under ``vmap``: u, dt ``[..., T, di]``; A ``[di, N]`` fp32; B, C ``[...,
T, N]``; D ``[di]`` fp32; seg ``[..., T]`` int32.  The final state
``h_final [..., di, N]`` is fp32.

* :func:`selective_scan_plain` / :func:`selective_scan_bwd_plain` -- a
  sequential fp32 recurrence, and the reverse walk of the JAX module's
  backward formulas.  The CPU path and the tests use them; on the card
  they are the yardstick the kernels are held against.
* :func:`ssm_fwd` -- ``csrc/selective_scan.cu``'s forward kernel, which
  replaces the Pallas ``_fwd_kernel`` (``src/repro/kernels/
  selective_scan.py:50``): y, the state entering every 64-step chunk
  (``ckpt``) and h_final.  CUDA tensors only.
* :func:`ssm_bwd` -- its backward kernel, which replaces ``_bwd_kernel``
  (:87): du, ddt, dA, dB, dC, dD from the checkpoints.
* :class:`SelectiveScan` -- the differentiable op ``(y, h_final)``: the
  kernels on CUDA tensors, the plain versions on CPU tensors; no gradient
  for seg.
* :func:`selective_scan` -- the JAX package's entry point: refuses what it
  refuses (``di % block_d``, ``T % chunk``).  The CUDA kernels keep their
  own tiling (32 channels a block, a checkpoint every 64 steps); the
  blocks are checked so that the two packages accept and refuse the same
  calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "SelectiveScan",
    "scan_keep",
    "selective_scan",
    "selective_scan_bwd_plain",
    "selective_scan_plain",
    "ssm_bwd",
    "ssm_fwd",
]


def scan_keep(seg: torch.Tensor) -> torch.Tensor:
    """keep ``[..., T]`` bool: the state carries into step t unless a
    segment starts there (seg changes, seg == 0) or t == 0."""
    prev = torch.cat([seg[..., :1], seg[..., :-1]], dim=-1)
    keep = (seg > 0) & (seg == prev)
    keep[..., 0] = False
    return keep


# ----------------------------------------------------------------------
# Plain versions.
# ----------------------------------------------------------------------
def _states(u, dt, A, B, keep):
    """The post-step states ``[..., T, di, N]`` of the recurrence, in fp32
    (inputs already fp32)."""
    T, di = u.shape[-2:]
    h = torch.zeros(u.shape[:-2] + (di, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    hs = torch.empty(u.shape + (A.shape[1],), dtype=torch.float32, device=u.device)
    for t in range(T):
        dA = torch.exp(dt[..., t, :, None] * A)
        h = torch.where(keep[..., t, None, None], h, 0.0) * dA + (
            (dt[..., t, :] * u[..., t, :])[..., None] * B[..., t, None, :])
        hs[..., t, :, :] = h
    return hs


def selective_scan_plain(u, dt, A, B, C, D, seg):
    """Returns ``(y [..., T, di]`` in u's dtype, ``h_final [..., di, N]``
    fp32)."""
    uf = u.float()
    hs = _states(uf, dt.float(), A.float(), B.float(), scan_keep(seg))
    y = (hs * C.float()[..., None, :]).sum(-1) + D.float() * uf
    return y.to(u.dtype), hs[..., -1, :, :]


def selective_scan_bwd_plain(u, dt, A, B, C, D, seg, dy, dhf):
    """Gradients of ``(y, h_final)`` given their cotangents ``dy`` and
    ``dhf``, by the reverse walk of the JAX module docstring with the
    adjoint ``g_t = dy_t C_t + keep_{t+1} e^{dt_{t+1} A} g_{t+1}``.
    Returns ``(du, ddt)`` in u's and dt's dtypes and ``(dA [di, N], dB, dC
    [..., T, N], dD [di])`` in fp32, summed over the streams where the
    parameter is shared."""
    keep = scan_keep(seg)
    uf, df, Bf, Cf, Af = u.float(), dt.float(), B.float(), C.float(), A.float()
    dyf, Df = dy.float(), D.float()
    hs = _states(uf, df, Af, Bf, keep)
    T = u.shape[-2]
    g = dhf.float().clone()
    du, ddt = torch.empty_like(uf), torch.empty_like(df)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(g)
    for t in reversed(range(T)):
        dt_t, u_t, dy_t = df[..., t, :], uf[..., t, :], dyf[..., t, :]
        k_t = keep[..., t, None, None]
        h_prev = hs[..., t - 1, :, :] if t > 0 else torch.zeros_like(g)
        hm = torch.where(k_t, h_prev, 0.0)
        e = torch.exp(dt_t[..., None] * Af)
        g = dy_t[..., None] * Cf[..., t, None, :] + g
        gB = (g * Bf[..., t, None, :]).sum(-1)
        du[..., t, :] = dy_t * Df + dt_t * gB
        ghe = g * hm * e
        ddt[..., t, :] = (ghe * Af).sum(-1) + u_t * gB
        dA += ghe * dt_t[..., None]
        dB[..., t, :] = (g * (dt_t * u_t)[..., None]).sum(-2)
        dC[..., t, :] = (dy_t[..., None] * hs[..., t, :, :]).sum(-2)
        g = torch.where(k_t, e * g, 0.0)
    lead = tuple(range(u.dim() - 2))
    dD = (dyf * uf).sum(dim=lead + (u.dim() - 2,))
    dA = dA.sum(dim=lead) if lead else dA
    return du.to(u.dtype), ddt.to(dt.dtype), dA, dB, dC, dD


# ----------------------------------------------------------------------
# CUDA kernels.
# ----------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load("selective_scan.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssm_fwd.argtypes = [vp] * 10 + [i32] * 5 + [vp]
    lib.ssm_bwd.argtypes = [vp] * 16 + [i32] * 5 + [vp]
    for fn in (lib.ssm_fwd, lib.ssm_bwd, lib.ssm_chunk, lib.ssm_block_channels,
               lib.ssm_max_state):
        fn.restype = i32
    return lib


def _check_cuda(name, streams, params, seg, N):
    """The kernels' input contract: one CUDA device, contiguous; u/dt/B/C
    (and dy) of one dtype of fp32/bf16; A and D fp32; seg int32; N at most
    the kernels' largest state size."""
    first = streams[0]
    tensors = (*streams, *params, seg)
    if not all(t.is_cuda and t.device == first.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if first.dtype not in _DTYPE_CODES or any(t.dtype != first.dtype for t in streams):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in streams]}: need one of "
                         f"{list(_DTYPE_CODES)}")
    if any(t.dtype != torch.float32 for t in params) or seg.dtype != torch.int32:
        raise ValueError(f"{name}: A, D (and the state gradient) must be fp32 and seg "
                         f"int32, got {[t.dtype for t in params]}, {seg.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if not 1 <= N <= _lib().ssm_max_state():
        raise ValueError(f"{name}: state size N={N} outside 1..{_lib().ssm_max_state()}")


def _dims(u, A, B, C, D, seg):
    Bs, T, di = u.shape
    N = A.shape[1]
    if (tuple(A.shape) != (di, N) or tuple(B.shape) != (Bs, T, N)
            or tuple(C.shape) != (Bs, T, N) or tuple(D.shape) != (di,)
            or tuple(seg.shape) != (Bs, T)):
        raise ValueError(f"selective scan: u {tuple(u.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)}, seg "
                         f"{tuple(seg.shape)} do not match")
    return Bs, T, di, N


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ssm_fwd(u, dt, A, B, C, D, seg):
    """Launch the forward kernel on the current stream: u, dt [Bs, T, di]
    and B, C [Bs, T, N] of one dtype; A [di, N], D [di] fp32; seg [Bs, T]
    int32.  Returns ``(y [Bs, T, di]`` in u's dtype, ``ckpt [Bs,
    ceil(T / 64), di, N]``, ``h_final [Bs, di, N]`` fp32).  Counts each
    launch in ``ssm_fwd.launches``."""
    Bs, T, di, N = _dims(u, A, B, C, D, seg)
    _check_cuda("ssm_fwd", (u, dt, B, C), (A, D), seg, N)
    if tuple(dt.shape) != tuple(u.shape):
        raise ValueError(f"ssm_fwd: dt {tuple(dt.shape)} != u {tuple(u.shape)}")
    chunk = _lib().ssm_chunk()
    y = torch.empty_like(u)
    ckpt = torch.empty((Bs, -(-T // chunk), di, N), dtype=torch.float32, device=u.device)
    hf = torch.empty((Bs, di, N), dtype=torch.float32, device=u.device)
    rc = _lib().ssm_fwd(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                        C.data_ptr(), D.data_ptr(), seg.data_ptr(), y.data_ptr(),
                        ckpt.data_ptr(), hf.data_ptr(), Bs, T, di, N,
                        _DTYPE_CODES[u.dtype], _stream(u))
    if rc != 0:
        raise RuntimeError(f"ssm_fwd launch failed with cudaError {rc}")
    ssm_fwd.launches += 1
    return y, ckpt, hf


def ssm_bwd(u, dt, A, B, C, D, seg, ckpt, dy, dhf):
    """Launch the backward kernel on the current stream, with the forward's
    inputs and ``ckpt``, dy [Bs, T, di] in u's dtype and dhf [Bs, di, N]
    fp32.  Returns ``(du, ddt)`` in u's dtype and ``(dA [di, N], dB, dC
    [Bs, T, N], dD [di])`` fp32; the kernel writes per-block and per-stream
    partials of the sums over channels and streams, added here in a fixed
    order.  Counts each launch in ``ssm_bwd.launches``."""
    Bs, T, di, N = _dims(u, A, B, C, D, seg)
    _check_cuda("ssm_bwd", (u, dt, B, C, dy), (A, D, ckpt, dhf), seg, N)
    lib = _lib()
    if (tuple(dt.shape) != tuple(u.shape) or tuple(dy.shape) != tuple(u.shape)
            or tuple(dhf.shape) != (Bs, di, N)
            or tuple(ckpt.shape) != (Bs, -(-T // lib.ssm_chunk()), di, N)):
        raise ValueError(f"ssm_bwd: dt {tuple(dt.shape)}, dy {tuple(dy.shape)}, dhf "
                         f"{tuple(dhf.shape)}, ckpt {tuple(ckpt.shape)} do not match u "
                         f"{tuple(u.shape)}")
    f32 = dict(dtype=torch.float32, device=u.device)
    n_blk = -(-di // lib.ssm_block_channels())
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dA_part = torch.empty((Bs, di, N), **f32)
    dB_part = torch.empty((n_blk, Bs, T, N), **f32)
    dC_part = torch.empty((n_blk, Bs, T, N), **f32)
    dD_part = torch.empty((Bs, di), **f32)
    rc = lib.ssm_bwd(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                     D.data_ptr(), seg.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
                     dhf.data_ptr(), du.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(),
                     dB_part.data_ptr(), dC_part.data_ptr(), dD_part.data_ptr(), Bs, T, di,
                     N, _DTYPE_CODES[u.dtype], _stream(u))
    if rc != 0:
        raise RuntimeError(f"ssm_bwd launch failed with cudaError {rc}")
    ssm_bwd.launches += 1
    return du, ddt, dA_part.sum(0), dB_part.sum(0), dC_part.sum(0), dD_part.sum(0)


ssm_fwd.launches = 0
ssm_bwd.launches = 0


# ----------------------------------------------------------------------
# The differentiable op.
# ----------------------------------------------------------------------
class SelectiveScan(torch.autograd.Function):
    """``(y, h_final)`` of the scan over batched streams with its backward
    (the JAX package's ``_make_diff_scan``): each gradient cast back to its
    input's dtype; no gradient for seg."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, seg):
        if u.device.type == "cpu":
            (y, hf), ckpt = selective_scan_plain(u, dt, A, B, C, D, seg), None
        elif u.device.type == "cuda":
            y, ckpt, hf = ssm_fwd(u, dt, A, B, C, D, seg)
        else:
            raise ValueError(f"selective scan runs on cpu or cuda, not {u.device}")
        ctx.save_for_backward(u, dt, A, B, C, D, seg, ckpt)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        u, dt, A, B, C, D, seg, ckpt = ctx.saved_tensors
        dy, dhf = dy.to(u.dtype).contiguous(), dhf.float().contiguous()
        if u.device.type == "cpu":
            grads = selective_scan_bwd_plain(u, dt, A, B, C, D, seg, dy, dhf)
        else:
            grads = ssm_bwd(u, dt, A, B, C, D, seg, ckpt, dy, dhf)
        du, ddt, dA, dB, dC, dD = grads
        return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
                dC.to(C.dtype), dD.to(D.dtype), None)


def selective_scan(u, delta, A, B, C, D, seg, *, block_d: int = 128, chunk: int = 64,
                   return_state: bool = False):
    """u, delta ``[T, di]`` (or ``[Bs, T, di]``); A ``[di, N]``; B, C ``[T,
    N]``; D ``[di]``; seg ``[T]`` int.  Returns y, or ``(y, h_final [di,
    N])`` with ``return_state=True``.  Differentiable in every input but
    seg."""
    squeeze = u.dim() == 2
    if squeeze:
        u, delta, B, C, seg = (x[None] for x in (u, delta, B, C, seg))
    T, di = u.shape[-2:]
    bd, ct = min(block_d, di), min(chunk, T)
    if di % bd or T % ct:
        raise ValueError(f"di={di} % {bd} or T={T} % {ct} != 0")
    y, hf = SelectiveScan.apply(u.contiguous(), delta.contiguous(), A.contiguous(),
                                B.contiguous(), C.contiguous(), D.contiguous(),
                                seg.to(torch.int32).contiguous())
    if squeeze:
        y, hf = y[0], hf[0]
    return (y, hf) if return_state else y
