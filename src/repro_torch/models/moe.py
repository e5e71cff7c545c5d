"""Mixture-of-Experts FFN (``repro.models.moe`` in PyTorch; grok-1: 8
experts top-2, granite: 40 experts top-8).

Two dispatch backends behind ``moe_ffn(backend=...)`` share one routing
prologue: fp32 router logits, softmax, top-k, renormalised gate values;
invalid (padding) tokens get zero gate weight and their assignments go
to a sentinel expert ``E`` that sorts past every real expert, so they
never take a capacity slot or a row of work.

  "dense"    the legacy sort + scatter into an ``[E, capacity, d]``
             buffer: static shapes, pays ``E * capacity`` rows of product
             and drops assignments past capacity (counted in the aux
             metrics).
  "grouped"  drop-free sorted dispatch: assignments sorted by expert form
             contiguous row groups, and the three expert products run
             through the grouped-GEMM op (``kernels/grouped_gemm.py``),
             whose offsets stay on the device.

Both return ``(out, aux)`` with the Switch-style load-balance loss over
all top-k slots, the realised per-expert load fractions and the dropped
fraction (0 on "grouped").  Nothing here reads routing counts back to the
host.

``expert_shard_plan`` bins experts onto expert-parallel shards from
measured loads with the port's copy of the chunked-exact LPT engine.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import grouped_matmul_op

__all__ = ["expert_shard_plan", "moe_ffn", "router_load_balance_loss"]


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25, valid=None, backend: str = "dense",
            block_m: int = 128, block_n: int = 128):
    """x [B, T, d]; router_w [d, E]; w_gate/w_up [E, d, f]; w_down [E, f, d];
    ``valid`` [B, T] bool (padding tokens are routed to the sentinel).

    Returns ``(out [B, T, d] in x's dtype, aux)`` with aux keys
    ``lb_loss`` (scalar), ``expert_load`` ([E]) and ``dropped_frac``
    (scalar), all fp32."""
    if backend not in ("dense", "grouped"):
        raise ValueError(f"unknown moe backend {backend!r}")
    B, T, d = x.shape
    E = router_w.shape[-1]
    n = B * T
    xf = x.reshape(n, d)
    vflat = None if valid is None else valid.reshape(n)

    logits = xf.float() @ router_w.float()
    if vflat is not None:
        logits = torch.where(vflat[:, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_ids = select_experts(probs, top_k)  # [n, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    if vflat is not None:
        gate_vals = gate_vals * vflat[:, None]

    # Flatten assignments; invalid tokens go to the sentinel expert E.
    # (Each token's k slots by expand, not repeat_interleave, which may
    # read its size back from the device.)
    flat_e = gate_ids.reshape(-1)
    if vflat is not None:
        flat_e = torch.where(vflat[:, None].expand(n, top_k).reshape(-1), flat_e,
                             torch.full_like(flat_e, E))
    flat_tok = torch.arange(n, device=x.device)[:, None].expand(n, top_k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e, sorted_tok = flat_e[order], flat_tok[order]

    counts = torch.zeros(E + 1, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    n_routed = counts[:E].sum().clamp(min=1).float()
    expert_load = counts[:E].float() / n_routed

    if backend == "grouped":
        expert_out, dropped = _grouped_dispatch(
            xf, w_gate, w_up, w_down, sorted_tok, counts, n, top_k,
            block_m=block_m, block_n=block_n)
    else:
        expert_out, dropped = _dense_dispatch(
            xf, w_gate, w_up, w_down, sorted_e, sorted_tok, counts, n, top_k, E,
            capacity_factor)

    # Back to assignment order: inv is the inverse permutation of order.
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(n * top_k,
                                                                  device=x.device))
    expert_out = expert_out.index_select(0, inv).reshape(n, top_k, d)
    combined = (expert_out.float() * gate_vals.float()[..., None]).sum(1)

    aux = {
        "lb_loss": router_load_balance_loss(probs, gate_ids, E, vflat, top_k=top_k),
        "expert_load": expert_load,
        "dropped_frac": dropped.float() / n_routed,
    }
    return combined.reshape(B, T, d).to(x.dtype), aux


def select_experts(probs, top_k: int):
    """The top-k experts of each token and their probabilities.  The one
    discontinuous step of routing: at a near-tie between the k-th and the
    (k+1)-th probability, two fp32 paths that round differently pick
    different experts.  A module-level function, so that an agreement
    check can replace it with one that replays another run's choice."""
    return torch.topk(probs, top_k, dim=-1)


def _dense_dispatch(xf, w_gate, w_up, w_down, sorted_e, sorted_tok, counts, n, top_k,
                    E, capacity_factor):
    """Legacy capacity-buffer path.  Returns outputs in sorted assignment
    order [n*k, d] and the dropped-assignment count.  The JAX package's
    ``mode="drop"`` scatter is an explicit sink row past the buffer."""
    d = xf.shape[1]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * top_k, device=xf.device) - starts[sorted_e]

    capacity = int(max(1, round(n * top_k / E * capacity_factor)))
    keep = (rank < capacity) & (sorted_e < E)
    dropped = counts[:E].sum() - keep.sum()
    sink = E * capacity
    slot = torch.where(keep, sorted_e * capacity + rank, torch.full_like(rank, sink))

    buf = xf.new_zeros((sink + 1, d)).index_put((slot,), xf[sorted_tok])
    buf = buf[:-1].reshape(E, capacity, d)
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    out_buf = torch.bmm(F.silu(g) * u, w_down).reshape(sink, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)
    return out_buf[slot], dropped  # a dropped slot reads the zero row


def _grouped_dispatch(xf, w_gate, w_up, w_down, sorted_tok, counts, n, top_k, *,
                      block_m, block_n):
    """Drop-free grouped path.  Returns outputs in sorted assignment order
    [n*k, d] and a dropped count of 0.  The offsets are a device cumsum
    of the counts; the sentinel rows sort last and give 0."""
    d = xf.shape[1]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:-1], 0)]).to(torch.int32)
    xs = xf[sorted_tok]  # [n*k, d] sorted by expert; sentinel rows last
    M = n * top_k
    bm = min(block_m, M)
    pad = (-M) % bm
    if pad:
        xs = torch.cat([xs, xs.new_zeros((pad, d))])
    g = grouped_matmul_op(xs, w_gate, offsets, block_m=bm,
                          block_n=_divisor_block(w_gate.shape[-1], block_n))
    u = grouped_matmul_op(xs, w_up, offsets, block_m=bm,
                          block_n=_divisor_block(w_up.shape[-1], block_n))
    out = grouped_matmul_op(F.silu(g) * u, w_down, offsets, block_m=bm,
                            block_n=_divisor_block(d, block_n))
    return out[:M], torch.zeros((), dtype=torch.int32, device=xf.device)


def _divisor_block(size: int, target: int) -> int:
    """Largest block <= target that divides size."""
    for b in range(min(target, size), 0, -1):
        if size % b == 0:
            return b
    return 1


def router_load_balance_loss(probs, gate_ids, n_experts: int, valid=None, *,
                             top_k: int | None = None):
    """Switch-style aux loss ``E * sum_e fraction_slots_e * mean_prob_e``
    over all top-k slots (normalised by k); balanced-uniform routing gives
    exactly 1.0 for any k.  ``valid`` [n] bool masks padding tokens."""
    n, k = gate_ids.shape
    if top_k is not None and top_k != k:
        raise ValueError(f"top_k={top_k} != gate_ids k={k}")
    slots = torch.zeros((n, n_experts), dtype=torch.float32, device=probs.device)
    slots = slots.scatter_add_(1, gate_ids, torch.ones_like(gate_ids, dtype=torch.float32))
    slots = slots / k
    if valid is not None:
        vf = valid.float()
        slots = slots * vf[:, None]
        denom = vf.sum().clamp(min=1.0)
        mean_p = (probs * vf[:, None]).sum(0) / denom
    else:
        denom = float(n)
        mean_p = probs.mean(0)
    frac = slots.sum(0) / denom
    return n_experts * (frac * mean_p).sum()


def expert_shard_plan(expert_load, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side planner: bin experts onto ``n_shards`` expert-parallel
    shards balancing measured load (e.g. the ``expert_load`` aux metric,
    or raw token counts) with the port's LPT engine.  Returns
    ``(assignment [E] int, shard_loads [n_shards] float)``."""
    from repro_torch.core.balancing_vec import lpt_assign

    loads = np.asarray(expert_load, np.float64)
    if loads.ndim != 1 or n_shards < 1:
        raise ValueError(f"bad plan inputs: {loads.shape}, {n_shards}")
    order = np.argsort(-loads, kind="stable")
    assign_sorted, _, shard_loads = lpt_assign(loads[order], n_shards)
    assignment = np.empty(loads.size, np.int64)
    assignment[order] = assign_sorted
    return assignment, shard_loads
