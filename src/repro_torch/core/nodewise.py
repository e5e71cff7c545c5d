"""Node-wise Rearrangement Algorithm (paper S5.2.2, Algorithm 3).

(A copy of ``repro.core.nodewise``, with the port's imports.)

Given a solved rearrangement Pi, any permutation of the *destination
batch indices* leaves the balancing objective unchanged but changes the
communication matrix's column order -- and therefore how much traffic
crosses the slow inter-node (TPU: inter-pod / DCI) links.

The paper formulates an ILP: assign the d destination batches to d/c
nodes (c instances per node), each node receiving exactly c batches,
minimizing the max over nodes of the volume its instances send to
batches placed on OTHER nodes:

    min max_g  sum_{i in node g} sum_{j : batch j not on node g} V[i, j]

We implement it three ways:
  * :func:`solve_ilp` -- exact, via scipy.optimize.milp (HiGHS), for
    moderate d (the paper used CVXPY+CBC).
  * :func:`solve_greedy` -- greedy + pairwise-swap local search for
    large d where exact ILP is impractical.
  * plus the beyond-paper refinement :func:`assign_within_node`:
    a per-node Hungarian assignment (linear_sum_assignment) of batches
    to *specific instances*, maximizing self-traffic (bytes that never
    leave the shard at all).  The paper stops at node granularity.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.rearrangement import Rearrangement

try:  # scipy is available in this environment; keep a soft dependency anyway.
    from scipy.optimize import LinearConstraint, linear_sum_assignment, milp
    from scipy.optimize import Bounds

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

__all__ = [
    "node_cost_matrix",
    "internode_objective",
    "solve_ilp",
    "solve_greedy",
    "assign_within_node",
    "nodewise_rearrange",
]


def node_cost_matrix(pi: Rearrangement) -> np.ndarray:
    """cost_matrix[i][j] = volume instance i sends to destination batch j
    (paper Alg 3 lines 1-4)."""
    V = np.zeros((pi.d, pi.d), dtype=np.int64)
    np.add.at(V, (pi.src_inst, pi.dst_inst), pi.lengths)
    return V


def internode_objective(V: np.ndarray, batch_to_node: np.ndarray, c: int) -> int:
    """max over nodes g of sum_{i in g} sum_{j not on g} V[i, j]."""
    d = V.shape[0]
    n_nodes = d // c
    worst = 0
    for g in range(n_nodes):
        rows = range(g * c, (g + 1) * c)
        off_node = batch_to_node != g
        worst = max(worst, int(V[list(rows)][:, off_node].sum()))
    return worst


def solve_ilp(V: np.ndarray, c: int, *, time_limit: float = 10.0) -> np.ndarray | None:
    """Exact ILP via HiGHS.  Returns batch_to_node (d,) or None on failure.

    Variables: x[j, g] in {0,1} (batch j -> node g), plus t = max cost.
    Constraints: sum_g x[j,g] = 1; sum_j x[j,g] = c;
                 for each g: sum_{i in g} sum_j V[i,j]*(1 - x[j,g]) <= t.
    """
    if not _HAVE_SCIPY:
        return None
    d = V.shape[0]
    n_nodes = d // c
    nx = d * n_nodes
    nvar = nx + 1  # + t

    def xi(j: int, g: int) -> int:
        return j * n_nodes + g

    cons = []
    # Each batch to exactly one node.
    A = np.zeros((d, nvar))
    for j in range(d):
        for g in range(n_nodes):
            A[j, xi(j, g)] = 1.0
    cons.append(LinearConstraint(A, 1.0, 1.0))
    # Each node gets exactly c batches.
    A = np.zeros((n_nodes, nvar))
    for g in range(n_nodes):
        for j in range(d):
            A[g, xi(j, g)] = 1.0
    cons.append(LinearConstraint(A, float(c), float(c)))
    # Max-cost epigraph: row_g . (1 - x[:,g]) - t <= 0
    A = np.zeros((n_nodes, nvar))
    ub = np.zeros(n_nodes)
    for g in range(n_nodes):
        rows = V[g * c : (g + 1) * c].sum(axis=0).astype(float)  # volume per dest batch
        total = rows.sum()
        # total_g - sum_j rows[j]*x[j,g] - t <= 0   <=>   -rows.x - t <= -total_g
        for j in range(d):
            A[g, xi(j, g)] = -rows[j]
        A[g, nx] = -1.0
        ub[g] = -total
    cons.append(LinearConstraint(A, -np.inf, ub))

    objective = np.zeros(nvar)
    objective[nx] = 1.0
    integrality = np.ones(nvar)
    integrality[nx] = 0
    bounds = Bounds(lb=np.zeros(nvar), ub=np.concatenate([np.ones(nx), [np.inf]]))
    res = milp(
        c=objective,
        constraints=cons,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit},
    )
    if res is None or res.x is None:
        return None
    x = res.x[:nx].reshape(d, n_nodes)
    batch_to_node = x.argmax(axis=1)
    # Validate feasibility (rounding can break counts).
    if not all((batch_to_node == g).sum() == c for g in range(n_nodes)):
        return None
    return batch_to_node.astype(np.int64)


def solve_greedy(V: np.ndarray, c: int, *, swap_rounds: int = 4) -> np.ndarray:
    """Greedy seed + pairwise swap local search on the minimax objective.

    Seed: for each node g (in order of total outgoing volume, desc),
    pick the c unassigned batches that receive the most volume *from g's
    instances* (affinity), so that volume stays on-node.
    """
    d = V.shape[0]
    n_nodes = d // c
    node_rows = np.stack([V[g * c : (g + 1) * c].sum(axis=0) for g in range(n_nodes)])
    batch_to_node = -np.ones(d, dtype=np.int64)
    order = np.argsort(-node_rows.sum(axis=1))
    taken = np.zeros(d, dtype=bool)
    for g in order:
        aff = np.where(taken, -1, node_rows[g])
        pick = np.argsort(-aff)[:c]
        batch_to_node[pick] = g
        taken[pick] = True

    def cost(assign: np.ndarray) -> int:
        return internode_objective(V, assign, c)

    best = cost(batch_to_node)
    for _ in range(swap_rounds):
        improved = False
        for j in range(d):
            for k in range(j + 1, d):
                if batch_to_node[j] == batch_to_node[k]:
                    continue
                batch_to_node[j], batch_to_node[k] = batch_to_node[k], batch_to_node[j]
                new = cost(batch_to_node)
                if new < best:
                    best = new
                    improved = True
                else:
                    batch_to_node[j], batch_to_node[k] = batch_to_node[k], batch_to_node[j]
        if not improved:
            break
    return batch_to_node


def assign_within_node(V: np.ndarray, batch_to_node: np.ndarray, c: int) -> np.ndarray:
    """Beyond-paper: inside each node, assign its c batches to specific
    instances maximizing self-traffic V[i, j] for batch j on instance i.
    Returns perm (d,): destination batch j is placed on instance perm[j].
    """
    d = V.shape[0]
    n_nodes = d // c
    perm = np.empty(d, dtype=np.int64)
    for g in range(n_nodes):
        insts = np.arange(g * c, (g + 1) * c)
        batches = np.where(batch_to_node == g)[0]
        # Maximize sum V[inst, batch] -> minimize negative.
        if _HAVE_SCIPY:
            costm = -V[np.ix_(insts, batches)].astype(float)
            r, col = linear_sum_assignment(costm)
            for ri, ci in zip(r, col):
                perm[batches[ci]] = insts[ri]
        else:  # pragma: no cover
            for bi, b in enumerate(batches):
                perm[b] = insts[bi]
    return perm


def nodewise_rearrange(
    pi: Rearrangement,
    instances_per_node: int,
    *,
    method: str = "auto",
    within_node: bool = True,
) -> Rearrangement:
    """Paper Algorithm 3 + beyond-paper within-node assignment.

    Permutes ``pi``'s destination batch indices so inter-node traffic is
    minimized; objective-invariant for the balancing problem.
    """
    c = instances_per_node
    d = pi.d
    if d % c != 0:
        raise ValueError(f"d={d} not divisible by instances_per_node={c}")
    if c == d:
        return pi  # single node: nothing to do
    V = node_cost_matrix(pi)
    batch_to_node: np.ndarray | None = None
    if method in ("auto", "ilp") and d * (d // c) <= 4096:
        batch_to_node = solve_ilp(V, c)
    if batch_to_node is None:
        if method == "ilp":
            raise RuntimeError("ILP solve failed")
        batch_to_node = solve_greedy(V, c)
    if within_node:
        perm = assign_within_node(V, batch_to_node, c)
    else:
        perm = np.empty(d, dtype=np.int64)
        slots = {g: list(range(g * c, (g + 1) * c)) for g in range(d // c)}
        for j in range(d):
            perm[j] = slots[int(batch_to_node[j])].pop()
    return pi.permute_destinations(perm)
