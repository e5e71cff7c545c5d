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
* :func:`selective_scan_chunked_plain` / :func:`selective_scan_chunked_bwd_plain`
  -- the kernels' decomposition in plain PyTorch: chunks, runs of steps
  composed as affine maps, the scan of the run totals across a chunk, the
  carry across chunks, exp2 with A prescaled, the reverse adjoint scan.
  Only the tests and ``chip_smoke.py`` call them.
* :func:`ssm_fwd` -- ``csrc/selective_scan.cu``'s forward kernel, which
  replaces the Pallas ``_fwd_kernel`` (``src/repro/kernels/
  selective_scan.py:50``): y, the state entering every chunk (``ckpt``)
  and h_final.  CUDA tensors only.
* :func:`ssm_bwd` -- its backward kernel, which replaces ``_bwd_kernel``
  (:87): du, ddt, dA, dB, dC, dD from the checkpoints.
* :class:`SelectiveScan` -- the differentiable op ``(y, h_final)``: the
  kernels on CUDA tensors, the plain versions on CPU tensors; no gradient
  for seg.
* :func:`selective_scan` -- the JAX package's entry point: refuses what it
  refuses (``di % block_d``, ``T % chunk``).  The CUDA kernels keep their
  own tiling (:func:`ssm_tiling`: 32 channels a block, a checkpoint every
  ``ssm_chunk()`` steps); the blocks are checked so that the two packages
  accept and refuse the same calls.
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
    "selective_scan_chunked_bwd_plain",
    "selective_scan_chunked_plain",
    "selective_scan_plain",
    "ssm_bwd",
    "ssm_bwd_kernel_call",
    "ssm_fwd",
    "ssm_partial_bytes",
    "ssm_tiling",
]

LOG2E = 1.4426950408889634  # A' = A log2(e): the kernels' exp2 operand


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
# The kernels' decomposition, in plain PyTorch.
# ----------------------------------------------------------------------
def _chunked_inputs(u, dt, A, B, C, seg, chunk, run):
    """fp32 inputs padded to whole chunks with identity steps (u = dt = B
    = C = 0, keep), and the per-step exponent bias (0 keep, -inf reset)."""
    if chunk % run or run % 2:
        raise ValueError(f"runs of {run} steps (two halves) do not tile a chunk of {chunk}")
    T = u.shape[-2]
    n_ck = -(-T // chunk)
    pad = n_ck * chunk - T

    def padded(x):
        x = x.float()
        return torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))], dim=-2)

    keep = torch.cat([scan_keep(seg), seg.new_ones(seg.shape[:-1] + (pad,), dtype=torch.bool)],
                     dim=-1)
    kb = torch.where(keep, 0.0, float("-inf")).float()
    a2 = A.float() * torch.tensor(LOG2E, dtype=torch.float32, device=A.device)
    return padded(u), padded(dt), padded(B), padded(C), kb, a2, n_ck


def _chunk_forward(uc, dc, Bc, kbc, a2, hin0, run):
    """One chunk of the forward decomposition.  uc, dc ``[..., chunk, di]``,
    Bc ``[..., chunk, N]``, kbc ``[..., chunk]``, hin0 ``[..., di, N]``.  A
    run of ``run`` steps is two halves composed side by side; the run's
    total joins them.  Returns a dict: ``a``, ``x``, ``hs`` (the state after
    each step) ``[..., W, run, di(, N)]``, ``hin`` (the state entering each
    run), ``pa`` / ``pb`` (each half's total from a zero state) ``[..., W,
    2, di, N]``."""
    lead, (chunk, di), N = uc.shape[:-2], uc.shape[-2:], a2.shape[1]
    W, half = chunk // run, run // 2
    dtr = dc.reshape(lead + (W, run, di))
    x = dtr * uc.reshape(lead + (W, run, di))
    kbr = kbc.reshape(lead + (W, run, 1, 1))
    a = torch.exp2(dtr[..., None] * a2 + kbr)
    bv = x[..., None] * Bc.reshape(lead + (W, run, 1, N))
    halves = lead + (W, 2, half, di, N)
    ah, bh = a.reshape(halves), bv.reshape(halves)
    pa = torch.ones(lead + (W, 2, di, N), device=uc.device)
    pb = torch.zeros(lead + (W, 2, di, N), device=uc.device)
    for j in range(half):  # each half's maps from a zero state
        pa = pa * ah[..., j, :, :]
        pb = ah[..., j, :, :] * pb + bh[..., j, :, :]
    run_a = pa[..., 0, :, :] * pa[..., 1, :, :]
    run_b = pa[..., 1, :, :] * pb[..., 0, :, :] + pb[..., 1, :, :]
    hin = [hin0]  # the scan of the run totals across the chunk
    for w in range(W - 1):
        hin.append(run_a[..., w, :, :] * hin[-1] + run_b[..., w, :, :])
    hin = torch.stack(hin, dim=-3)
    # each run walked again, its second half from the first half's total
    h = torch.stack([hin, pa[..., 0, :, :] * hin + pb[..., 0, :, :]], dim=-3)
    hs = []
    for j in range(half):
        h = ah[..., j, :, :] * h + bh[..., j, :, :]
        hs.append(h)
    hs = torch.stack(hs, dim=-3).reshape(lead + (W, run, di, N))
    return dict(a=a, x=x, hs=hs, hin=hin, pa=pa, pb=pb)


def selective_scan_chunked_plain(u, dt, A, B, C, D, seg, *, chunk: int, run: int):
    """The forward kernel's order of work, in fp32: chunks of ``chunk``
    steps, each split into runs of ``run`` steps.  Per run, the composed
    affine map of its steps (``a_t = keep_t 2^(dt_t A log2 e)``, ``b_t =
    dt_t u_t B_t``), by two halves side by side; the scan of the run totals
    from the state carried into the chunk; each run walked again from its
    incoming state.  Steps past T are identities.  Returns ``(y`` in u's
    dtype, ``ckpt [..., ceil(T / chunk), di, N]`` (the state entering each
    chunk), ``h_final)``."""
    T, di = u.shape[-2:]
    lead = u.shape[:-2]
    uf, df, Bf, Cf, kb, a2, n_ck = _chunked_inputs(u, dt, A, B, C, seg, chunk, run)
    W = chunk // run
    h = torch.zeros(lead + (di, A.shape[1]), device=u.device)
    ckpt = torch.empty(lead + (n_ck, di, A.shape[1]), device=u.device)
    ys = []
    for k in range(n_ck):
        sl = slice(k * chunk, (k + 1) * chunk)
        ckpt[..., k, :, :] = h
        hs = _chunk_forward(uf[..., sl, :], df[..., sl, :], Bf[..., sl, :], kb[..., sl], a2,
                            h, run)["hs"]
        cr = Cf[..., sl, :].reshape(lead + (W, run, 1, -1))
        ys.append(((hs * cr).sum(-1) + D.float() * uf[..., sl, :].reshape(lead + (W, run, di)))
                  .reshape(lead + (chunk, di)))
        h = hs[..., -1, -1, :, :]
    y = torch.cat(ys, dim=-2)[..., :T, :]
    return y.to(u.dtype), ckpt, h


def selective_scan_chunked_bwd_plain(u, dt, A, B, C, D, seg, ckpt, dy, dhf, *, chunk: int,
                                     run: int):
    """The backward kernel's order of work, in fp32: chunks last first,
    each recomputing its forward scan from its checkpoint as
    :func:`selective_scan_chunked_plain` does, then the adjoint as a
    reverse affine scan: a run maps the message m entering its last step to
    ``a_first (dy C + ... a_last (dy C + m))`` (by halves, as forward), the
    run totals are scanned from the last run to the first, starting from
    the message of the later chunks (``dL/dh_final`` at the end), and each
    run walked again.
    Returns as :func:`selective_scan_bwd_plain`."""
    T, di = u.shape[-2:]
    lead = u.shape[:-2]
    N = A.shape[1]
    uf, df, Bf, Cf, kb, a2, n_ck = _chunked_inputs(u, dt, A, B, C, seg, chunk, run)
    dyf = torch.cat([dy.float(), dy.new_zeros(lead + (n_ck * chunk - T, di)).float()], dim=-2)
    W = chunk // run
    m = dhf.float()
    dA = torch.zeros(lead + (di, N), device=u.device)
    du, ddt, dB, dC = [None] * n_ck, [None] * n_ck, [None] * n_ck, [None] * n_ck
    half = run // 2
    for k in reversed(range(n_ck)):
        sl = slice(k * chunk, (k + 1) * chunk)
        f = _chunk_forward(uf[..., sl, :], df[..., sl, :], Bf[..., sl, :], kb[..., sl], a2,
                           ckpt[..., k, :, :].float(), run)
        a, x, hs, hin, pa = f["a"], f["x"], f["hs"], f["hin"], f["pa"]
        br = Bf[..., sl, :].reshape(lead + (W, run, 1, N))
        cdy = dyf[..., sl, :].reshape(lead + (W, run, di, 1)) * Cf[..., sl, :].reshape(
            lead + (W, run, 1, N))
        halves = lead + (W, 2, half, di, N)
        ah, ch = a.reshape(halves), cdy.reshape(halves)
        mr = torch.zeros(lead + (W, 2, di, N), device=u.device)
        for j in reversed(range(half)):  # each half's reverse map from a zero message
            mr = ah[..., j, :, :] * (ch[..., j, :, :] + mr)
        run_a = pa[..., 0, :, :] * pa[..., 1, :, :]
        run_m = pa[..., 0, :, :] * mr[..., 1, :, :] + mr[..., 0, :, :]
        m_in = [m]  # the scan of the reverse totals, last run first
        for w in reversed(range(1, W)):
            m_in.append(run_a[..., w, :, :] * m_in[-1] + run_m[..., w, :, :])
        mm = torch.stack(m_in[::-1], dim=-3)
        # each run walked in reverse, its first half from the second's total
        ms = torch.stack([pa[..., 1, :, :] * mm + mr[..., 1, :, :], mm], dim=-3)
        gs = [None] * half
        for j in reversed(range(half)):
            gs[j] = ch[..., j, :, :] + ms
            ms = ah[..., j, :, :] * gs[j]
        m = ms[..., 0, 0, :, :]  # the message leaving the chunk's first step
        g = torch.stack(gs, dim=-3).reshape(lead + (W, run, di, N))
        hprev = torch.cat([hin[..., None, :, :], hs[..., :-1, :, :]], dim=-3)
        ghe = (a * g) * hprev
        dtr = df[..., sl, :].reshape(lead + (W, run, di))
        gB = (g * br).sum(-1)
        dyr = dyf[..., sl, :].reshape(lead + (W, run, di))
        du[k] = (D.float() * dyr + dtr * gB).reshape(lead + (chunk, di))
        ddt[k] = ((ghe * A.float()).sum(-1) + uf[..., sl, :].reshape(lead + (W, run, di)) * gB
                  ).reshape(lead + (chunk, di))
        dA = dA + (ghe * dtr[..., None]).sum(dim=(-4, -3))
        dB[k] = (g * x[..., None]).sum(-2).reshape(lead + (chunk, N))
        dC[k] = (dyr[..., None] * hs).sum(-2).reshape(lead + (chunk, N))
    cat = lambda parts: torch.cat(parts, dim=-2)[..., :T, :]  # noqa: E731
    lead_dims = tuple(range(len(lead)))
    dD = (dy.float() * u.float()).sum(dim=lead_dims + (len(lead),))
    dA = dA.sum(dim=lead_dims) if lead else dA
    return (cat(du).to(u.dtype), cat(ddt).to(dt.dtype), dA, cat(dB), cat(dC), dD)


# ----------------------------------------------------------------------
# CUDA kernels.
# ----------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    return bind(load("selective_scan.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a scan library's C functions
    (also for a candidate source built by ``tools/kernel_ab.py``)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssm_fwd.argtypes = [vp] * 10 + [i32] * 5 + [vp]
    lib.ssm_bwd.argtypes = [vp] * 17 + [i32] * 5 + [vp]
    lib.ssm_tiling.argtypes = [vp, i32, i32]
    for fn in (lib.ssm_fwd, lib.ssm_bwd, lib.ssm_chunk, lib.ssm_partial_channels,
               lib.ssm_max_state, lib.ssm_tiling):
        fn.restype = i32
    return lib


_TILING_KEYS = ("block_channels", "fwd_warps", "fwd_run", "bwd_warps", "bwd_run", "chunk",
                "fwd_stages", "bwd_stages", "chain", "fwd_blocks_per_sm", "bwd_blocks_per_sm")


def ssm_tiling(N: int, dtype: torch.dtype, lib: ctypes.CDLL | None = None) -> dict:
    """The kernels' tiling at state size N: channels a block; warps and
    steps a run (forward, backward); the chunk; the ring stages a launch
    takes; the blocks one dB/dC group partial sums; the blocks of each
    kernel an SM holds (this queries the card)."""
    out = (ctypes.c_int * len(_TILING_KEYS))()
    (lib or _lib()).ssm_tiling(ctypes.addressof(out), N, _DTYPE_CODES[dtype])
    return dict(zip(_TILING_KEYS, out))


def ssm_partial_bytes(Bs: int, T: int, di: int, N: int, lib: ctypes.CDLL | None = None) -> int:
    """Bytes of the dB and dC partials the backward kernel writes to device
    memory (fp32, one ``[Bs, T, N]`` slab per group of channels summed on
    chip)."""
    groups = -(-di // (lib or _lib()).ssm_partial_channels())
    return 2 * groups * Bs * T * N * 4


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


def _launch_fwd(lib, u, dt, A, B, C, D, seg):
    """Allocate the forward's outputs and launch ``lib``'s kernel; counts
    the launch in ``ssm_fwd.launches``."""
    Bs, T, di = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    ckpt = torch.empty((Bs, -(-T // lib.ssm_chunk()), di, N), dtype=torch.float32,
                       device=u.device)
    hf = torch.empty((Bs, di, N), dtype=torch.float32, device=u.device)
    rc = lib.ssm_fwd(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                     D.data_ptr(), seg.data_ptr(), y.data_ptr(), ckpt.data_ptr(), hf.data_ptr(),
                     Bs, T, di, N, _DTYPE_CODES[u.dtype], _stream(u))
    if rc != 0:
        raise RuntimeError(f"ssm_fwd launch failed with cudaError {rc}")
    ssm_fwd.launches += 1
    return y, ckpt, hf


def ssm_fwd(u, dt, A, B, C, D, seg):
    """Launch the forward kernel on the current stream: u, dt [Bs, T, di]
    and B, C [Bs, T, N] of one dtype; A [di, N], D [di] fp32; seg [Bs, T]
    int32.  Returns ``(y [Bs, T, di]`` in u's dtype, ``ckpt [Bs,
    ceil(T / ssm_chunk()), di, N]``, ``h_final [Bs, di, N]`` fp32).  Counts
    each launch in ``ssm_fwd.launches``."""
    _, _, _, N = _dims(u, A, B, C, D, seg)
    _check_cuda("ssm_fwd", (u, dt, B, C), (A, D), seg, N)
    if tuple(dt.shape) != tuple(u.shape):
        raise ValueError(f"ssm_fwd: dt {tuple(dt.shape)} != u {tuple(u.shape)}")
    return _launch_fwd(_lib(), u, dt, A, B, C, D, seg)


def ssm_bwd_kernel_call(u, dt, A, B, C, D, seg, ckpt, dy, dhf, lib=None):
    """The backward kernel alone: allocates its outputs (du, ddt and the
    fp32 partials dA ``[Bs, di, N]``, dB/dC ``[groups, Bs, T, N]``, dD
    ``[Bs, di]``) and the int32 turns of its chained dB/dC sums, and
    returns ``(launch, outputs)``, where ``launch()`` zeroes the turns and
    launches ``lib``'s kernel (the tree's by default) into the outputs,
    counting it in ``ssm_bwd.launches``.  :func:`ssm_bwd` sums the
    partials."""
    lib = lib or _lib()
    Bs, T, di = u.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=u.device)
    groups = -(-di // lib.ssm_partial_channels())
    outs = (torch.empty_like(u), torch.empty_like(u), torch.empty((Bs, di, N), **f32),
            torch.empty((groups, Bs, T, N), **f32), torch.empty((groups, Bs, T, N), **f32),
            torch.empty((Bs, di), **f32))
    turns = torch.empty((groups, Bs, -(-T // lib.ssm_chunk())), dtype=torch.int32,
                        device=u.device)
    args = [t.data_ptr() for t in (u, dt, A, B, C, D, seg, ckpt, dy, dhf, *outs, turns)]
    stream = _stream(u)

    def launch():
        turns.zero_()
        rc = lib.ssm_bwd(*args, Bs, T, di, N, _DTYPE_CODES[u.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"ssm_bwd launch failed with cudaError {rc}")
        ssm_bwd.launches += 1

    return launch, outs


def ssm_bwd(u, dt, A, B, C, D, seg, ckpt, dy, dhf):
    """Launch the backward kernel on the current stream, with the forward's
    inputs and ``ckpt``, dy [Bs, T, di] in u's dtype and dhf [Bs, di, N]
    fp32.  Returns ``(du, ddt)`` in u's dtype and ``(dA [di, N], dB, dC
    [Bs, T, N], dD [di])`` fp32; the kernel sums dB/dC over each group of
    256 channels and writes one partial a group, and dA/dD per stream;
    those are added here in a fixed order.  Counts each launch in
    ``ssm_bwd.launches``."""
    Bs, T, di, N = _dims(u, A, B, C, D, seg)
    _check_cuda("ssm_bwd", (u, dt, B, C, dy), (A, D, ckpt, dhf), seg, N)
    if (tuple(dt.shape) != tuple(u.shape) or tuple(dy.shape) != tuple(u.shape)
            or tuple(dhf.shape) != (Bs, di, N)
            or tuple(ckpt.shape) != (Bs, -(-T // _lib().ssm_chunk()), di, N)):
        raise ValueError(f"ssm_bwd: dt {tuple(dt.shape)}, dy {tuple(dy.shape)}, dhf "
                         f"{tuple(dhf.shape)}, ckpt {tuple(ckpt.shape)} do not match u "
                         f"{tuple(u.shape)}")
    launch, (du, ddt, dA_part, dB_part, dC_part, dD_part) = ssm_bwd_kernel_call(
        u, dt, A, B, C, D, seg, ckpt, dy, dhf)
    launch()
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
