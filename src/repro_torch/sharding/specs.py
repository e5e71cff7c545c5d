"""Placements (``repro.sharding.specs``): the DP shard of a batch and the
pipeline stage partition.  Parameters are replicated on every DP rank;
the FSDP/TP placements of ``param_specs`` are not ported yet."""
from __future__ import annotations

import numpy as np

__all__ = ["shard_batch", "stage_partition"]


def shard_batch(batch: dict, rank: int, d: int) -> dict:
    """DP rank ``rank``'s shard of an orchestrator batch (the port's form
    of ``batch_specs``: every array is ``[d, ...]`` on its leading axis,
    so a rank keeps ``[rank:rank+1]``).  Slot indices are per stream and
    stay as they are; ``global_gather`` holds flat indices into the
    all-gathered ``[d * cap_in]`` buffer, which only the ``allgather``
    exchange reads, and is sliced the same way.  Works on numpy arrays
    and tensors alike."""
    if not 0 <= rank < d:
        raise ValueError(f"rank {rank} outside a DP group of {d}")
    bad = {k: tuple(v.shape) for k, v in batch.items() if v.shape[:1] != (d,)}
    if bad:
        raise ValueError(f"batch arrays must lead with the DP axis of {d}: {bad}")
    return {k: v[rank:rank + 1] for k, v in batch.items()}


def stage_partition(n_layers: int, pp: int,
                    layer_costs=None) -> tuple[int, ...]:
    """Contiguous partition of ``n_layers`` into ``pp`` pipeline stages.

    Minimizes the max per-stage cost over contiguous splits (activations
    only flow between adjacent stages, so stages must be contiguous).
    ``layer_costs`` is an optional per-layer cost vector -- e.g. the
    calibrated per-layer LLM cost from the telemetry fits -- defaulting
    to uniform layers, where the split is the balanced floor/ceil one.
    Returns layers-per-stage (len ``pp``, sums to ``n_layers``); every
    stage gets at least one layer.
    """
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if pp > n_layers:
        raise ValueError(f"pp={pp} exceeds n_layers={n_layers}")
    if pp == 1:
        return (n_layers,)
    if layer_costs is None:
        base, extra = divmod(n_layers, pp)
        # Heavier stages FIRST: warmup bubbles shrink toward the tail,
        # so front-loading keeps the steady-state critical path tight.
        return tuple(base + (1 if s < extra else 0) for s in range(pp))
    costs = np.asarray(layer_costs, dtype=np.float64)
    if costs.shape != (n_layers,):
        raise ValueError(f"layer_costs must have shape ({n_layers},)")
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def feasible(cap: float) -> tuple[int, ...] | None:
        """Greedy: longest prefix per stage under ``cap``; leave enough
        layers so every remaining stage can take at least one."""
        out, lo = [], 0
        for s in range(pp):
            hi_max = n_layers - (pp - 1 - s)
            hi = int(np.searchsorted(prefix, prefix[lo] + cap, side="right")) - 1
            hi = min(max(hi, lo + 1), hi_max)
            out.append(hi - lo)
            lo = hi
        return tuple(out) if lo == n_layers else None

    # Binary search the min-max stage cost over the distinct candidates.
    lo_cap, hi_cap = float(costs.max()), float(costs.sum())
    best = feasible(hi_cap)
    for _ in range(64):
        mid = 0.5 * (lo_cap + hi_cap)
        got = feasible(mid)
        if got is not None:
            best, hi_cap = got, mid
        else:
            lo_cap = mid
    assert best is not None
    return best
