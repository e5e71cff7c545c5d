"""Vectorized NumPy engine for the Batch Post-Balancing algorithms.

(A copy of ``repro.core.balancing_vec``, with the port's imports.)

Array-at-once reformulations of the four algorithms in
:mod:`repro.core.balancing`, exactly equivalent to the per-item heapq
reference path (``backend="python"``) but ~1-2 orders of magnitude
faster at production sizes (n ~ 10^4 items, d ~ 10^2-10^3 instances).

The core engine is :func:`lpt_assign`: LPT greedy ("pop the batch with
the smallest running load") executed in *chunks*.  Per chunk we sort the
d running loads once, speculate that the next c descending items land on
the c smallest loads in order, and accept the longest prefix for which
the speculation provably matches the heap execution:

    item j may take the j-th smallest load  iff  loads_sorted[j] is
    STRICTLY below every load updated earlier in the chunk,

i.e. ``loads_sorted[j] < min_{k<j}(loads_sorted[k] + w_k)``.  Under that
condition the heap's (load, idx) minimum at step j is exactly the j-th
smallest pre-chunk load (stable argsort = the heap's index tie-break),
so the assignment is identical item by item -- not just in objective.
Ties (equality) are rejected and re-resolved next iteration, where the
first speculation step is the literal argmin and always exact.  Both the
early regime (flat loads) and the late regime (load spread below the
item scale) accept full chunks, so the per-item python overhead
amortizes away; the degenerate staircase case falls back to correct
per-item behavior.

Algorithm 2's first-fit packer needs no per-item work at all: with
ascending lengths the incoming item is the running max, so item j fits a
batch starting at s iff ``s >= m[j] = j + 1 - bound // l[j]``, and m is
monotone -- each bound probe builds a jump table ``jump[s] = first j
with m[j] > s`` from one bincount/cumsum and hops batch to batch.
Algorithm 4's bounded descending packer jumps whole batches at a time
(the first, largest item fixes the batch's max, hence its capacity
``bound // max``).

Destination slots are tracked *during* assignment (each batch's items
arrive in processed order), so no final per-item sort is needed; the
:class:`~repro.core.rearrangement.Rearrangement` is assembled from flat
gathers only.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.rearrangement import Rearrangement

__all__ = [
    "items_to_arrays",
    "arrays_from_instance_lengths",
    "lpt_assign",
    "nopad_vec",
    "pad_vec",
    "quad_vec",
    "conv_vec",
]


def items_to_arrays(
    items: Sequence[tuple[int, int, int]]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src_inst, src_slot, length) tuples -> three int64 arrays."""
    if not len(items):
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    arr = np.asarray(items, dtype=np.int64)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def arrays_from_instance_lengths(
    lengths_per_instance: Sequence[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized :func:`repro.core.balancing.flatten_instance_lengths`."""
    lens = [np.asarray(x, dtype=np.int64).ravel() for x in lengths_per_instance]
    if not lens:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    counts = np.array([x.size for x in lens], dtype=np.int64)
    n = int(counts.sum())
    inst = np.repeat(np.arange(len(lens), dtype=np.int64), counts)
    starts = np.cumsum(counts) - counts
    slot = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    length = np.concatenate(lens) if n else np.zeros(0, np.int64)
    return inst, slot, length


def _build(
    inst: np.ndarray,
    slot: np.ndarray,
    length: np.ndarray,
    dst_inst: np.ndarray,
    dst_slot: np.ndarray,
    d: int,
) -> Rearrangement:
    """Assemble a Rearrangement from flat per-item arrays (any order)."""
    return Rearrangement(
        d=d,
        orig_inst=inst,
        orig_slot=slot,
        src_inst=inst.copy(),
        src_slot=slot.copy(),
        dst_inst=dst_inst.astype(np.int64, copy=False),
        dst_slot=dst_slot.astype(np.int64, copy=False),
        lengths=length,
    )


def _slots_for_blocks(sizes: np.ndarray) -> np.ndarray:
    """dst_slot for items laid out as consecutive blocks of `sizes`."""
    n = int(sizes.sum())
    starts = np.cumsum(sizes) - sizes
    return np.arange(n, dtype=np.int64) - np.repeat(starts, sizes)


# ----------------------------------------------------------------------
# Chunked-exact LPT engine (Alg 1, Alg 3 effective weights, Alg 4 tail).
# ----------------------------------------------------------------------
def lpt_assign(
    weights_desc: np.ndarray,
    d: int,
    init_loads: np.ndarray | None = None,
    init_counts: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact LPT greedy over pre-sorted descending weights.

    Equivalent to: heapify d (load, idx) pairs, pop-min / push per item.
    Returns (assign, slots, final_loads) where slots[k] is item k's
    append position within its batch (continuing from ``init_counts``).
    Float weights accumulate in the same per-batch order as the heap
    path, so loads are bit-identical to the reference.
    """
    n = weights_desc.size
    assign = np.empty(n, dtype=np.int64)
    slots = np.empty(n, dtype=np.int64)
    loads = (np.zeros(d, dtype=np.float64) if init_loads is None
             else np.asarray(init_loads, dtype=np.float64).copy())
    counts = (np.zeros(d, dtype=np.int64) if init_counts is None
              else np.asarray(init_counts, dtype=np.int64).copy())
    i = 0
    while i < n:
        c = min(d, n - i)
        order = np.argsort(loads, kind="stable")
        if c < d:
            order = order[:c]
        ls = loads[order]
        new = ls + weights_desc[i : i + c]
        # Speculation j is exact iff ls[j] is strictly below every load
        # already updated in this chunk (prefix-min of `new`).
        ok = ls[1:] < np.minimum.accumulate(new)[:-1] if c > 1 else None
        if ok is None or ok.all():
            k = c
            sel = order
        else:
            k = int(np.argmin(ok)) + 1  # first False, offset for item 0
            sel = order[:k]
            new = new[:k]
        assign[i : i + k] = sel
        slots[i : i + k] = counts[sel]
        counts[sel] += 1
        loads[sel] = new
        i += k
    return assign, slots, loads


def _desc_order(length: np.ndarray) -> np.ndarray:
    """Stable descending sort = the reference `sorted(key=-len)`.

    numpy's kind="stable" is timsort for int64 (3-4x slower than
    introsort here), so when the values fit we pack (length, reversed
    index) into one int64 key and introsort that: ascending on the key
    then a reversal yields descending lengths with ties in original
    order.
    """
    n = length.size
    if n == 0:
        return np.zeros(0, np.int64)
    bits = int(n - 1).bit_length() if n > 1 else 1
    lmax = int(length.max())
    if lmax < (1 << (62 - bits)):
        key = (length << bits) | (n - 1 - np.arange(n, dtype=np.int64))
        return np.argsort(key)[::-1]
    return np.argsort(-length, kind="stable")


def _asc_order(length: np.ndarray) -> np.ndarray:
    """Stable ascending sort via the same packed-key trick."""
    n = length.size
    if n == 0:
        return np.zeros(0, np.int64)
    bits = int(n - 1).bit_length() if n > 1 else 1
    lmax = int(length.max())
    if lmax < (1 << (62 - bits)):
        key = (length << bits) | np.arange(n, dtype=np.int64)
        return np.argsort(key)
    return np.argsort(length, kind="stable")


# ----------------------------------------------------------------------
# Algorithm 1: LPT greedy without paddings.
# ----------------------------------------------------------------------
def nopad_vec(
    inst: np.ndarray, slot: np.ndarray, length: np.ndarray, d: int
) -> Rearrangement:
    order = _desc_order(length)
    desc = length[order]
    assign, slots, _ = lpt_assign(desc.astype(np.float64), d)
    return _build(inst[order], slot[order], desc, assign, slots, d)


# ----------------------------------------------------------------------
# Algorithm 2: binary search + first-fit with paddings.
# ----------------------------------------------------------------------
def _pad_jump_table(asc: np.ndarray, bound: int) -> np.ndarray:
    """jump[s] = index of the first item NOT fitting a batch started at
    item s (ascending first-fit under padded-batch-length `bound`).

    Item j fits a batch starting at s iff (j - s + 1) * asc[j] <= bound
    (ascending: the newcomer is the running max), i.e. s >= m[j] with
    m[j] = j + 1 - bound // asc[j].  m is monotone (capacity clamped to
    n keeps it so through zero-length items, which always fit), so
    jump[s] = #{j : m[j] <= s} falls out of one histogram + cumsum.
    """
    n = asc.size
    cap = np.full(n, n, dtype=np.int64)
    pos = asc > 0
    np.floor_divide(bound, asc, out=cap, where=pos)
    np.minimum(cap, n, out=cap)
    m = np.arange(1, n + 1, dtype=np.int64) - cap
    return np.cumsum(np.bincount(np.clip(m, 0, n), minlength=n + 1))


def _pad_batch_starts(asc: np.ndarray, bound: int, limit: int) -> list[int]:
    """First-fit batch start indices, stopping once more than `limit`
    batches are needed."""
    n = asc.size
    jump = _pad_jump_table(asc, bound)
    starts: list[int] = []
    s = 0
    while s < n:
        starts.append(s)
        if len(starts) > limit:
            break
        s = int(jump[s])
    return starts


def pad_vec(
    inst: np.ndarray, slot: np.ndarray, length: np.ndarray, d: int
) -> Rearrangement:
    order = _asc_order(length)  # ascending, stable
    asc = length[order]
    n = asc.size
    if n == 0:
        z = np.zeros(0, np.int64)
        return _build(inst, slot, length, z, z.copy(), d)
    # Bracket: a batch must fit the longest item alone; conversely every
    # feasible bound covers the per-batch token total, so >= ceil(sum/d).
    lo = max(int(asc[-1]), -(-int(asc.sum()) // d))
    hi = int(asc[-1]) * (n // d + 1)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(_pad_batch_starts(asc, mid, d)) <= d:
            hi = mid
        else:
            lo = mid + 1
    starts = np.asarray(_pad_batch_starts(asc, lo, d), dtype=np.int64)
    sizes = np.diff(np.append(starts, n))
    assign = np.repeat(np.arange(starts.size, dtype=np.int64), sizes)
    return _build(inst[order], slot[order], asc, assign, _slots_for_blocks(sizes), d)


# ----------------------------------------------------------------------
# Algorithm 3: quadratic objective, LPT on effective weights.
# ----------------------------------------------------------------------
def quad_vec(
    inst: np.ndarray, slot: np.ndarray, length: np.ndarray, d: int,
    *, lam: float = 0.0,
) -> Rearrangement:
    order = _desc_order(length)
    desc = length[order]
    lens = desc.astype(np.float64)
    weights = lens + lam * (lens * lens)  # parenthesized: bit-matches the
    # reference path's `l + lam * float(l) ** 2` accumulation
    assign, slots, _ = lpt_assign(weights, d)
    return _build(inst[order], slot[order], desc, assign, slots, d)


# ----------------------------------------------------------------------
# Algorithm 4: ConvTransformer objective.
# ----------------------------------------------------------------------
def conv_vec(
    inst: np.ndarray, slot: np.ndarray, length: np.ndarray, d: int
) -> Rearrangement:
    order = _desc_order(length)
    desc = length[order]
    n = desc.size
    if n == 0:
        z = np.zeros(0, np.int64)
        return _build(inst, slot, length, z, z.copy(), d)

    # Bound = Alg 1's objective value (max batch token sum).
    _, _, loads1 = lpt_assign(desc.astype(np.float64), d)
    bound = int(loads1.max())

    # Phase 1: pack descending under the bound; the batch's first (and
    # largest) item fixes its padded row, so the batch holds exactly
    # max(1, bound // max) items -- whole batches jump at a time.
    sizes: list[int] = []
    s = 0
    while s < n and len(sizes) < d:
        m = int(desc[s])
        size = n - s if m == 0 else min(max(1, bound // m), n - s)
        sizes.append(size)
        s += size
    consumed = s
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    assign = np.empty(n, dtype=np.int64)
    slots = np.empty(n, dtype=np.int64)
    assign[:consumed] = np.repeat(np.arange(sizes_arr.size, dtype=np.int64), sizes_arr)
    slots[:consumed] = _slots_for_blocks(sizes_arr)

    # Phase 2: LPT remainder on running token sums.
    if consumed < n:
        init_loads = np.bincount(
            assign[:consumed], weights=desc[:consumed].astype(np.float64),
            minlength=d,
        )
        init_counts = np.bincount(assign[:consumed], minlength=d)
        tail, tail_slots, _ = lpt_assign(
            desc[consumed:].astype(np.float64), d,
            init_loads=init_loads, init_counts=init_counts,
        )
        assign[consumed:] = tail
        slots[consumed:] = tail_slots
    return _build(inst[order], slot[order], desc, assign, slots, d)
