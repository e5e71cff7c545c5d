"""Selective-state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2)
(``repro.models.ssm`` in PyTorch).

Segment-aware for packed post-balanced streams: the recurrent state
resets at example boundaries (seg change), so balancing rearrangements
stay consequence-invariant for SSMs too.

Training path, two backends behind ``mamba1_scan``/``mamba2_scan``
(``backend=``):

  "scan"    chunked sequential scan -- a loop over chunks carries only
            the small state; each chunk's body is checkpointed
            (``torch.utils.checkpoint``, not reentrant), so backward keeps
            per-chunk states instead of per-step residuals.
  "pallas"  the selective-scan op (``kernels/selective_scan.py``): the
            hand-written CUDA kernels on the card, their plain versions on
            the CPU.  Mamba-2's per-head scalar decay maps onto the same
            kernel by broadcasting head quantities over the head dim (the
            broadcasts sit outside the op's ``autograd.Function``, so their
            gradient reductions are plain autograd).

Where the JAX package ``vmap``s a single-stream scan over the batch, the
port's scans take the streams as leading dims of every per-step input
(``u [..., T, di]``, ``seg [..., T]``).

Decode path: O(1) per-token state update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import selective_scan_op
from repro_torch.kernels.selective_scan import scan_keep

__all__ = [
    "causal_conv1d",
    "mamba1_scan",
    "mamba2_scan",
    "mamba1_block",
    "mamba2_block",
    "mamba1_decode_step",
    "mamba2_decode_step",
]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, segment-aware.  x [B,T,C]; w [K,C]; seg [B,T]."""
    K, T = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]
        sseg = F.pad(seg, (i, 0))[:, :T]
        ok = (sseg == seg) & (seg > 0)
        out = out + shifted * ok[..., None] * w[K - 1 - i]
    return out


def _chunked_scan(step_fn, state0, xs, chunk: int):
    """Loop over chunks of the time axis, each chunk's step loop
    checkpointed; ``xs`` is a tuple of tensors ``[T, ...]``.  Returns
    (final state, stacked step outputs ``[T, ...]``).  As in the JAX
    package, a ragged last chunk is padded with zero inputs (keep false),
    so the final state is that of the padded stream."""
    T = xs[0].shape[0]
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    xs = tuple(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) if pad else a
               for a in xs)

    def body(state, *chunk_xs):
        ys = []
        for t in range(chunk_xs[0].shape[0]):
            state, y = step_fn(state, tuple(a[t] for a in chunk_xs))
            ys.append(y)
        return state, torch.stack(ys)

    state, outs = state0, []
    for c in range(n_chunks):
        part = tuple(a[c * chunk:(c + 1) * chunk] for a in xs)
        state, ys = checkpoint(body, state, *part, use_reentrant=False)
        outs.append(ys)
    return state, torch.cat(outs)[:T]


def _fit_block(size: int, target: int) -> int:
    """Largest block <= target dividing size (kernel divisibility)."""
    for b in range(min(target, size), 0, -1):
        if size % b == 0:
            return b
    return 1


def mamba1_scan(u, delta, A, B, C, D, seg, *, chunk: int = 256, h0=None,
                backend: str = "scan", block_d: int = 128):
    """Selective scan.  Shapes: u, delta [..., T, di]; A [di, N]; B, C
    [..., T, N]; D [di]; seg [..., T].  Returns (y [..., T, di], h_final
    [..., di, N])."""
    if backend == "pallas":
        if h0 is not None:
            raise ValueError("pallas selective scan starts from h=0 "
                             "(h0 is a scan-backend knob)")
        T, di = u.shape[-2:]
        return selective_scan_op(u, delta, A, B, C, D, seg,
                                 block_d=_fit_block(di, block_d),
                                 chunk=_fit_block(T, chunk), return_state=True)
    if backend != "scan":
        raise ValueError(f"unknown ssm backend {backend!r}")
    keep = scan_keep(seg)

    def step(h, inp):
        u_t, d_t, B_t, C_t, k_t = inp
        dA = torch.exp(d_t[..., None] * A)  # [..., di, N]
        h = torch.where(k_t[..., None, None], h, 0.0) * dA + (
            (d_t * u_t)[..., None] * B_t[..., None, :])
        y = (h * C_t[..., None, :]).sum(-1) + D * u_t
        return h, y

    if h0 is None:
        h0 = torch.zeros(u.shape[:-2] + (u.shape[-1], A.shape[1]), dtype=torch.float32,
                         device=u.device)
    xs = (u.float().movedim(-2, 0), delta.float().movedim(-2, 0), B.float().movedim(-2, 0),
          C.float().movedim(-2, 0), keep.movedim(-1, 0))
    hf, y = _chunked_scan(step, h0, xs, chunk)
    return y.movedim(0, -2).to(u.dtype), hf


def mamba2_scan(x, delta, A_log, B, C, D, seg, *, chunk: int = 256, h0=None,
                backend: str = "scan", block_d: int = 128):
    """Mamba-2 SSD (scalar decay per head).  Shapes: x [..., T, H, P],
    delta [..., T, H], A_log [H], B, C [..., T, N], D [H], seg [..., T].
    Returns (y [..., T, H, P], h_final [..., H, P, N])."""
    A = -torch.exp(A_log.float())  # [H]
    if backend == "pallas":
        if h0 is not None:
            raise ValueError("pallas selective scan starts from h=0 "
                             "(h0 is a scan-backend knob)")
        T, H, P = x.shape[-3:]
        N = B.shape[-1]
        # Broadcast per-head scalars over the head dim: channel (h, p)
        # runs the mamba1 recurrence with dt/A/D of head h.
        u2 = x.reshape(x.shape[:-2] + (H * P,))
        d2 = delta.repeat_interleave(P, dim=-1)
        A2 = A.repeat_interleave(P)[:, None].expand(H * P, N)
        D2 = D.repeat_interleave(P)
        y, hf = selective_scan_op(u2, d2, A2, B, C, D2, seg,
                                  block_d=_fit_block(H * P, block_d),
                                  chunk=_fit_block(T, chunk), return_state=True)
        return y.reshape(x.shape), hf.reshape(hf.shape[:-2] + (H, P, N))
    if backend != "scan":
        raise ValueError(f"unknown ssm backend {backend!r}")
    keep = scan_keep(seg)

    def step(h, inp):
        x_t, d_t, B_t, C_t, k_t = inp  # [...,H,P], [...,H], [...,N], [...,N], [...]
        dA = torch.exp(d_t * A)  # [..., H]
        h = torch.where(k_t[..., None, None, None], h, 0.0) * dA[..., None, None] + (
            (d_t[..., None] * x_t)[..., None] * B_t[..., None, None, :])
        y = (h * C_t[..., None, None, :]).sum(-1) + D[:, None] * x_t
        return h, y

    H, P, N = x.shape[-2], x.shape[-1], B.shape[-1]
    if h0 is None:
        h0 = torch.zeros(x.shape[:-3] + (H, P, N), dtype=torch.float32, device=x.device)
    xs = (x.float().movedim(-3, 0), delta.float().movedim(-2, 0), B.float().movedim(-2, 0),
          C.float().movedim(-2, 0), keep.movedim(-1, 0))
    hf, y = _chunked_scan(step, h0, xs, chunk)
    return y.movedim(0, -3).to(x.dtype), hf


# ----------------------------------------------------------------------
# Full blocks (projections + conv + scan + gate), matching the parameter
# layout of the JAX package's model.
# ----------------------------------------------------------------------
def mamba1_block(p, x, seg, *, ssm_state: int, chunk: int = 256,
                 backend: str = "scan", block_d: int = 128):
    """x [B,T,d] -> [B,T,d].  p: dict of this block's params."""
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # [B,T,di] each
    xi = F.silu(causal_conv1d(xi, p["conv_w"], seg))
    dt_rank = p["dt_proj"].shape[0]
    dt, Bm, Cm = (xi @ p["x_proj"]).split([dt_rank, ssm_state, ssm_state], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, _ = mamba1_scan(xi, delta, A, Bm, Cm, p["D"], seg, chunk=chunk, backend=backend,
                       block_d=block_d)
    return (y * F.silu(z)) @ p["out_proj"]


def mamba2_block(p, x, seg, *, ssm_state: int, headdim: int, chunk: int = 256,
                 backend: str = "scan", block_d: int = 128):
    """x [B,T,d] -> [B,T,d] (Mamba-2, n_groups=1)."""
    di = p["out_proj"].shape[0]
    H = di // headdim
    z, xi, Bm, Cm, dt = (x @ p["in_proj"]).split(
        [di, di, ssm_state, ssm_state, H], dim=-1)
    xi = F.silu(causal_conv1d(xi, p["conv_w"], seg))
    delta = F.softplus(dt + p["dt_bias"])  # [B,T,H]
    xh = xi.reshape(xi.shape[0], xi.shape[1], H, headdim)
    y, _ = mamba2_scan(xh, delta, p["A_log"], Bm, Cm, p["D"], seg, chunk=chunk,
                       backend=backend, block_d=block_d)
    y = y.reshape(x.shape[0], x.shape[1], di)
    return (y * F.silu(z)) @ p["out_proj"]


# ----------------------------------------------------------------------
# Decode: O(1) state update per new token.
# ----------------------------------------------------------------------
def _conv_step(p, xi, conv):
    """Append xi [B,di] to the conv window [B,K-1,di] (in the promoted
    dtype, as the JAX package's concatenation promotes); returns the conv
    output and the new window."""
    dt = torch.promote_types(conv.dtype, xi.dtype)
    conv_in = torch.cat([conv.to(dt), xi[:, None, :].to(dt)], dim=1)  # [B,K,di]
    return (conv_in * p["conv_w"][None]).sum(dim=1), conv_in[:, 1:]


def mamba1_decode_step(p, x_t, state, *, ssm_state: int):
    """x_t [B,d]; state dict {conv: [B,K-1,di], h: [B,di,N]}."""
    xi, z = (x_t @ p["in_proj"]).chunk(2, dim=-1)
    xi, new_conv = _conv_step(p, xi, state["conv"])
    xi = F.silu(xi)
    dt_rank = p["dt_proj"].shape[0]
    dt, Bm, Cm = (xi @ p["x_proj"]).split([dt_rank, ssm_state, ssm_state], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(delta[..., None] * A[None])  # [B,di,N]
    h = state["h"] * dA + (delta * xi)[..., None] * Bm[:, None, :]
    y = (h * Cm[:, None, :]).sum(-1) + p["D"] * xi
    y = y * F.silu(z)
    out = y.to(x_t.dtype) @ p["out_proj"]
    return out, {"conv": new_conv, "h": h}


def mamba2_decode_step(p, x_t, state, *, ssm_state: int, headdim: int):
    di = p["out_proj"].shape[0]
    H = di // headdim
    z, xi, Bm, Cm, dt = (x_t @ p["in_proj"]).split(
        [di, di, ssm_state, ssm_state, H], dim=-1)
    xi, new_conv = _conv_step(p, xi, state["conv"])
    xi = F.silu(xi)
    delta = F.softplus(dt + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(delta * A[None])  # [B,H]
    xh = xi.reshape(-1, H, headdim)
    h = state["h"] * dA[..., None, None] + (
        (delta[..., None] * xh)[..., None] * Bm[:, None, None, :])
    y = (h * Cm[:, None, None, :]).sum(-1) + p["D"][None, :, None] * xh
    y = y.reshape(-1, di) * F.silu(z)
    out = y.to(x_t.dtype) @ p["out_proj"]
    return out, {"conv": new_conv, "h": h}
