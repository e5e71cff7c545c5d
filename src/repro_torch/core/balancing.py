"""Batch Post-Balancing Algorithms (paper S5.1, Alg 1-2; App. A, Alg 3-4).

(A copy of ``repro.core.balancing``, with the port's imports.)

All algorithms take the flat list of examples -- each identified by its
(source instance, source slot, length) -- and return ``d`` new batches
minimizing (approximately) ``max_i f(S'_i)`` for the phase's cost model.

  - :func:`post_balance_nopad`   Alg 1: LPT greedy, 4/3-approx, O(n log n)
  - :func:`post_balance_pad`     Alg 2: binary search + first-fit, O(n log nC)
  - :func:`post_balance_quad`    Alg 3: quadratic objective (beta not << alpha)
  - :func:`post_balance_conv`    Alg 4: ConvTransformer objective
  - :func:`post_balance`         policy dispatch from a :class:`CostModel`
  - :func:`brute_force_oracle`   exact minimizer for tests (tiny n, d)

Two backends implement the same algorithms:

  - ``backend="python"``     the per-item heapq loops below -- the
    readable reference path, kept for equivalence testing;
  - ``backend="vectorized"`` the chunked NumPy engine in
    :mod:`repro.core.balancing_vec`, exactly equivalent (same
    assignments, not just the same objective) and 10-100x faster at
    production sizes.  This is the default.

The returned object is a :class:`~repro.core.rearrangement.Rearrangement`.
"""
from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np

from repro_torch.core import balancing_vec as _vec
from repro_torch.core.cost_model import CostModel
from repro_torch.core.rearrangement import Rearrangement

__all__ = [
    "flatten_instance_lengths",
    "post_balance_nopad",
    "post_balance_pad",
    "post_balance_quad",
    "post_balance_conv",
    "post_balance",
    "select_algorithm",
    "brute_force_oracle",
    "BACKENDS",
]

BACKENDS = ("python", "vectorized")

Item = tuple[int, int, int]  # (src_inst, src_slot, length)


def flatten_instance_lengths(lengths_per_instance: Sequence[np.ndarray]) -> list[Item]:
    items: list[Item] = []
    for i, lens in enumerate(lengths_per_instance):
        for j, l in enumerate(np.asarray(lens)):
            items.append((i, j, int(l)))
    return items


def _sorted_desc(items: Sequence[Item]) -> list[Item]:
    return sorted(items, key=lambda it: -it[2])


def _sorted_asc(items: Sequence[Item]) -> list[Item]:
    return sorted(items, key=lambda it: it[2])


def _to_rearrangement(batches: list[list[Item]], d: int) -> Rearrangement:
    batches = batches + [[] for _ in range(d - len(batches))]
    return Rearrangement.from_batches(batches, d)


# ----------------------------------------------------------------------
# Algorithm 1: Post-Balancing without paddings (LPT greedy).
# ----------------------------------------------------------------------
def post_balance_nopad(items: Sequence[Item], d: int, *,
                       backend: str = "python") -> Rearrangement:
    """Paper Algorithm 1.  Sort descending, push each onto the batch with
    the smallest running token sum (priority queue).  4/3-approximation
    of the makespan objective ``min max_i L'_i``."""
    if backend == "vectorized":
        return _vec.nopad_vec(*_vec.items_to_arrays(items), d)
    heap: list[tuple[int, int]] = [(0, i) for i in range(d)]  # (sum, batch_idx)
    heapq.heapify(heap)
    batches: list[list[Item]] = [[] for _ in range(d)]
    for it in _sorted_desc(items):
        total, idx = heapq.heappop(heap)
        batches[idx].append(it)
        heapq.heappush(heap, (total + it[2], idx))
    return _to_rearrangement(batches, d)


# ----------------------------------------------------------------------
# Algorithm 2: Post-Balancing with paddings (binary search + first-fit).
# ----------------------------------------------------------------------
def _least_batches_under_bound(sorted_asc: list[Item], bound: int) -> list[list[Item]]:
    """GetLeastBatches(b): pack ascending; a batch's padded length is
    (count * running-max); open a new batch when adding would exceed the
    bound.  Ascending order makes the incoming item the running max."""
    batches: list[list[Item]] = [[]]
    for it in sorted_asc:
        if (len(batches[-1]) + 1) * it[2] > bound and batches[-1]:
            batches.append([])
        batches[-1].append(it)
    return batches


def post_balance_pad(items: Sequence[Item], d: int, *,
                     backend: str = "python") -> Rearrangement:
    """Paper Algorithm 2: binary-search the smallest padded-batch-length
    bound for which first-fit packing needs <= d batches."""
    if backend == "vectorized":
        return _vec.pad_vec(*_vec.items_to_arrays(items), d)
    if not items:
        return _to_rearrangement([], d)
    asc = _sorted_asc(items)
    n = len(asc)
    lo = asc[-1][2]  # must fit the longest sequence alone
    hi = asc[-1][2] * (n // d + 1)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(_least_batches_under_bound(asc, mid)) <= d:
            hi = mid
        else:
            lo = mid + 1
    batches = _least_batches_under_bound(asc, lo)
    return _to_rearrangement(batches, d)


# ----------------------------------------------------------------------
# Algorithm 3 (App. A): tolerance-interval greedy for beta not << alpha.
# Objective: min max_i  L'_i + lambda * sum_j l'_{i,j}^2
# ----------------------------------------------------------------------
class _QuadBatch:
    __slots__ = ("idx", "lsum", "sqsum", "tol")

    def __init__(self, idx: int, tol: float):
        self.idx = idx
        self.lsum = 0
        self.sqsum = 0
        self.tol = tol

    def __lt__(self, other: "_QuadBatch") -> bool:  # paper CMP
        if abs(self.lsum - other.lsum) < self.tol:
            return self.sqsum < other.sqsum
        return self.lsum < other.lsum


def post_balance_quad(
    items: Sequence[Item],
    d: int,
    *,
    tolerance: float | None = None,
    lam: float = 0.0,
    method: str = "effective",
    backend: str = "python",
) -> Rearrangement:
    """Paper Algorithm 3 ('Post-Balancing Algorithm 3rd').

    Objective: min max_i  L'_i + lam * sum_j l'_{i,j}^2.

    ``method="effective"`` (default) is LPT greedy on the *effective
    weight* w = l + lam*l^2: assigning an item raises its batch's
    objective by exactly w, so greedy-on-resulting-cost IS plain LPT on
    w -- the clean reduction the paper's tolerance comparator
    approximates.  ``method="tolerance"`` keeps the paper-faithful heap
    CMP (balance L first, break near-ties by sum of squares);
    ``tolerance`` is its manually-set interval v, defaulting to a
    mean-length heuristic.  Passing ``tolerance`` explicitly selects
    the tolerance method (it has no meaning for the effective method).
    Only the effective method has a vectorized backend.
    """
    if tolerance is not None and method == "effective":
        method = "tolerance"
    if method == "effective":
        if backend == "vectorized":
            return _vec.quad_vec(*_vec.items_to_arrays(items), d, lam=lam)
        heap: list[tuple[float, int]] = [(0.0, i) for i in range(d)]
        heapq.heapify(heap)
        batches: list[list[Item]] = [[] for _ in range(d)]
        for it in _sorted_desc(items):
            # Precompute w so float accumulation order matches the
            # vectorized engine exactly (loads stay bit-identical).
            w = it[2] + lam * float(it[2]) ** 2
            total, idx = heapq.heappop(heap)
            batches[idx].append(it)
            heapq.heappush(heap, (total + w, idx))
        return _to_rearrangement(batches, d)
    if method != "tolerance":
        raise ValueError(f"unknown quad method {method!r}")
    if not items:
        return _to_rearrangement([], d)
    if tolerance is None:
        mean_len = float(np.mean([it[2] for it in items]))
        tolerance = max(1.0, mean_len * (0.5 if lam > 0 else 0.1))
    theap = [_QuadBatch(i, tolerance) for i in range(d)]
    heapq.heapify(theap)
    tbatches: list[list[Item]] = [[] for _ in range(d)]
    for it in _sorted_desc(items):
        top = heapq.heappop(theap)
        tbatches[top.idx].append(it)
        top.lsum += it[2]
        top.sqsum += it[2] * it[2]
        heapq.heappush(theap, top)
    return _to_rearrangement(tbatches, d)


# ----------------------------------------------------------------------
# Algorithm 4 (App. A): ConvTransformer objective.
# Objective: min max_i  L'_i + lambda * b_i * max_j(l'_{i,j})^2
# ----------------------------------------------------------------------
def post_balance_conv(items: Sequence[Item], d: int, *,
                      backend: str = "python") -> Rearrangement:
    """Paper Algorithm 4 ('Post-Balancing Algorithm 4th').

    First bound the padded term: pack descending under the bound given by
    Alg 1's objective value (so the conv-attention padded cost of each
    batch stays near the balanced linear cost), stopping once d batches
    are open; then distribute the remainder LPT-style by running sums.
    """
    if backend == "vectorized":
        return _vec.conv_vec(*_vec.items_to_arrays(items), d)
    if not items:
        return _to_rearrangement([], d)
    desc = _sorted_desc(items)
    # Bound = objective value of Algorithm 1 (max batch token sum).
    alg1 = post_balance_nopad(items, d)
    bound = max((int(l.sum()) for l in alg1.dest_lengths()), default=0)

    batches: list[list[Item]] = [[]]
    consumed = 0
    for k, it in enumerate(desc):
        cur = batches[-1]
        cur_max = cur[0][2] if cur else it[2]  # descending: first item is max
        if cur and (len(cur) + 1) * cur_max > bound:
            if len(batches) >= d:
                break
            batches.append([])
        batches[-1].append(it)
        consumed = k + 1
    batches += [[] for _ in range(d - len(batches))]

    # Remainder: LPT greedy on running sums.
    heap = [(sum(x[2] for x in b), i) for i, b in enumerate(batches)]
    heapq.heapify(heap)
    for it in desc[consumed:]:
        total, idx = heapq.heappop(heap)
        batches[idx].append(it)
        heapq.heappush(heap, (total + it[2], idx))
    return _to_rearrangement(batches, d)


# ----------------------------------------------------------------------
# Policy dispatch + exact oracle.
# ----------------------------------------------------------------------
def select_algorithm(cost_model: CostModel, lmax: int) -> str:
    """The balance policy (paper S5.1/S7 'selected according to the
    specified balance policy'):

      conv_attention -> Alg 4;  padding -> Alg 2;
      quadratic term material for the longest example
      (lambda * l_max >= 0.05) -> Alg 3;  else -> Alg 1.

    The length-aware threshold is a refinement over a fixed lambda
    cutoff: with heavy-tailed lengths, beta*l^2 of a single long example
    dominates its bin even when beta/alpha is tiny.
    """
    if cost_model.conv_attention:
        return "conv"
    if cost_model.padding:
        return "pad"
    return "quad" if cost_model.lam * lmax >= 0.05 else "nopad"


def post_balance(
    lengths_per_instance: Sequence[np.ndarray],
    d: int,
    cost_model: CostModel,
    *,
    algorithm: str | None = None,
    backend: str = "vectorized",
) -> Rearrangement:
    """Select and run the Post-Balancing algorithm for a phase.

    ``algorithm`` overrides the policy (see :func:`select_algorithm`):
    one of {"nopad", "pad", "quad", "conv"}.  ``backend`` picks the
    implementation: "vectorized" (default) or the "python" heapq
    reference.  Both produce identical rearrangements.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "vectorized":
        inst, slot, length = _vec.arrays_from_instance_lengths(lengths_per_instance)
        if algorithm is None:
            lmax = int(length.max()) if length.size else 0
            algorithm = select_algorithm(cost_model, lmax)
        if algorithm == "nopad":
            return _vec.nopad_vec(inst, slot, length, d)
        if algorithm == "pad":
            return _vec.pad_vec(inst, slot, length, d)
        if algorithm == "quad":
            return _vec.quad_vec(inst, slot, length, d, lam=cost_model.lam)
        if algorithm == "conv":
            return _vec.conv_vec(inst, slot, length, d)
        raise ValueError(f"unknown balancing algorithm {algorithm!r}")
    items = flatten_instance_lengths(lengths_per_instance)
    if algorithm is None:
        lmax = max((it[2] for it in items), default=0)
        algorithm = select_algorithm(cost_model, lmax)
    if algorithm == "nopad":
        return post_balance_nopad(items, d)
    if algorithm == "pad":
        return post_balance_pad(items, d)
    if algorithm == "quad":
        return post_balance_quad(items, d, lam=cost_model.lam)
    if algorithm == "conv":
        return post_balance_conv(items, d)
    raise ValueError(f"unknown balancing algorithm {algorithm!r}")


def brute_force_oracle(
    lengths_per_instance: Sequence[np.ndarray],
    d: int,
    cost_model: CostModel,
    *,
    chunk: int = 1 << 15,
) -> float:
    """Exact optimal max-cost via exhaustive assignment (tests only).

    Enumerates all d^n assignments in mixed-radix chunks and prices each
    chunk with the batched objective evaluator
    (:meth:`CostModel.assignment_costs`) -- one bincount per chunk
    instead of d^n * d python ``cost()`` calls.
    """
    items = flatten_instance_lengths(lengths_per_instance)
    n = len(items)
    if n > 12:
        raise ValueError("oracle is exponential; use n <= 12")
    if n == 0:
        return 0.0
    total = d**n
    if total > 10**8:
        raise ValueError(f"oracle would enumerate {total} assignments; shrink n or d")
    lens = np.array([it[2] for it in items], dtype=np.float64)
    radix = d ** np.arange(n, dtype=np.int64)
    best = np.inf
    for start in range(0, total, chunk):
        codes = np.arange(start, min(start + chunk, total), dtype=np.int64)
        assigns = (codes[:, None] // radix) % d
        costs = cost_model.assignment_costs(lens, assigns, d)
        best = min(best, float(costs.max(axis=1).min()))
    return float(best)
