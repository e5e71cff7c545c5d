"""Batch Post-Balancing Dispatcher (paper S5).

(A copy of ``repro.core.dispatcher``, with the port's imports.)

The dispatcher is the per-phase unit that
  1. collects sequence *lengths* from every DP instance (in torch this is
     an All-Gather of scalars; under JAX's global-program model the host
     pipeline already sees all lengths -- we keep the accounting so the
     benchmarks can price the strawman vs. the paper's communicator),
  2. runs the Post-Balancing algorithm selected by the balance policy,
  3. optionally applies the Node-wise Rearrangement Algorithm,
  4. emits a :class:`DispatchPlan` -- everything the device-side
     communicator needs to perform the payload all-to-all with STATIC
     shapes (per-shard token capacity), plus bookkeeping for
     EXPERIMENTS.md-style accounting.

Plan-ahead mode (paper S6, 'computation overhead overlapping'): the
dispatcher computation needs only lengths, which are known as soon as
mini-batches are sampled -- so :meth:`submit` hands the solve to a
background worker (bounded queue, one worker per dispatcher, mirroring
the paper's one-dispatcher-per-modality concurrency) and returns a
:class:`PlanTicket`; the caller collects ``ticket.result()`` a step
later, after the forward pass has hidden the host time.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core.balancing import post_balance
from repro_torch.core.cost_model import CostModel, _segment_max
from repro_torch.core.nodewise import nodewise_rearrange
from repro_torch.core.rearrangement import Rearrangement, identity_rearrangement
from repro_torch.utils import round_up as _round_up

__all__ = ["DispatchPlan", "PlanTicket", "BatchPostBalancingDispatcher"]


@dataclasses.dataclass
class DispatchPlan:
    """Host-side plan for one phase of one iteration.

    The device-side communicator consumes the token-level arrays; the
    orchestrator consumes ``pi`` for composition.
    """

    pi: Rearrangement
    d: int
    # Static per-shard token capacity for this phase (multiple of `pad_to`).
    token_capacity: int
    # Per destination shard: ordered example lengths (ragged).
    dest_lengths: list[np.ndarray]
    # Accounting:
    costs: np.ndarray  # f(S'_i) per destination shard
    utilization: float  # mean/max of costs
    solve_ms: float  # dispatcher computation time (paper Table 2 analog)
    # Per-shard feature vectors [L, L^2/b, sum l^2, b*max^2], shape
    # (d, 4): the telemetry calibrator pairs these with measured phase
    # times (costs == cost_model.cost_from_features(features)).
    features: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4)))
    # Pipeline mode: per-(stage, shard) cost matrix, shape (pp, d) --
    # stage cost = stage_fraction (calibrated per-layer cost x
    # layers-on-stage, normalized) x the shard's f(S).  Empty when the
    # dispatcher has no stage_fractions attached (pp = 1).
    stage_costs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))

    @property
    def max_cost(self) -> float:
        return float(self.costs.max()) if self.costs.size else 0.0


class PlanTicket:
    """Handle for a plan computed on the dispatcher's worker thread."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._plan: DispatchPlan | None = None
        self._error: BaseException | None = None

    def _set(self, plan: DispatchPlan | None, error: BaseException | None) -> None:
        self._plan = plan
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> DispatchPlan:
        if not self._done.wait(timeout):
            raise TimeoutError("dispatcher plan not ready")
        if self._error is not None:
            raise self._error
        assert self._plan is not None
        return self._plan


class BatchPostBalancingDispatcher:
    """One dispatcher per phase (paper Fig. 4).

    Args:
      d: number of DP instances (= size of pod*data mesh axes).
      cost_model: the phase's f.
      algorithm: override the balance policy (see core.balancing).
      instances_per_node: node size c for Node-wise Rearrangement; ``None``
        disables the node-wise step (e.g. single-node microbenchmarks).
      pad_to: round per-shard token capacity up to this multiple
        (TPU lane alignment; 128 aligns the MXU).
      balance: False -> identity plan (the paper's 'OrchMLLM w/o balance'
        baseline).
      backend: "vectorized" (default) or "python" post-balancing engine.
      queue_depth: bound on in-flight plan-ahead submissions.
      stage_fractions: pipeline mode -- per-stage share of this phase's
        cost (layers-on-stage x per-layer cost, normalized to sum 1);
        plans then carry a (pp, d) ``stage_costs`` matrix so the
        orchestrator's microbatch scheduler balances per-STAGE loads.
    """

    def __init__(
        self,
        d: int,
        cost_model: CostModel,
        *,
        algorithm: str | None = None,
        instances_per_node: int | None = None,
        nodewise_method: str = "auto",
        within_node: bool = True,
        pad_to: int = 128,
        balance: bool = True,
        backend: str = "vectorized",
        queue_depth: int = 2,
        stage_fractions: Sequence[float] | np.ndarray | None = None,
    ) -> None:
        self.d = d
        self.cost_model = cost_model
        self.stage_fractions = (None if stage_fractions is None
                                else np.asarray(stage_fractions, np.float64))
        self.algorithm = algorithm
        self.instances_per_node = instances_per_node
        self.nodewise_method = nodewise_method
        self.within_node = within_node
        self.pad_to = pad_to
        self.balance = balance
        self.backend = backend
        self.queue_depth = queue_depth
        self._work: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def plan(self, lengths_per_instance: Sequence[np.ndarray]) -> DispatchPlan:
        t0 = time.perf_counter()
        if self.balance:
            pi = post_balance(
                lengths_per_instance, self.d, self.cost_model,
                algorithm=self.algorithm, backend=self.backend,
            )
            if self.instances_per_node and self.instances_per_node < self.d:
                pi = nodewise_rearrange(
                    pi,
                    self.instances_per_node,
                    method=self.nodewise_method,
                    within_node=self.within_node,
                )
        else:
            pi = identity_rearrangement(lengths_per_instance, self.d)

        # Batched accounting: per-shard sums/counts/maxima in O(n) numpy
        # instead of a python loop over d ragged arrays.  Features are
        # kept on the plan so telemetry can regress measured phase times
        # onto them.
        lens = np.asarray(pi.lengths, dtype=np.float64)
        ids = pi.dst_inst
        features = self.cost_model.segment_features(lens, ids, self.d)
        costs = self.cost_model.cost_from_features(features)
        if self.cost_model.padding or self.cost_model.conv_attention:
            cnt = np.bincount(ids, minlength=self.d)
            bmax = _segment_max(lens, ids, self.d)
            per_shard_max = int((cnt * bmax).max()) if cnt.size else 0
        else:
            bsum = np.bincount(ids, weights=lens, minlength=self.d)
            per_shard_max = int(bsum.max()) if bsum.size else 0
        cap = _round_up(per_shard_max or self.pad_to, self.pad_to)
        maxc = costs.max() if costs.size else 0.0
        util = float(costs.mean() / maxc) if maxc > 0 else 1.0
        solve_ms = (time.perf_counter() - t0) * 1e3
        stage_costs = (np.outer(self.stage_fractions, costs)
                       if self.stage_fractions is not None
                       else np.zeros((0, 0)))
        return DispatchPlan(
            pi=pi,
            d=self.d,
            token_capacity=cap,
            dest_lengths=pi.dest_lengths(),
            costs=costs,
            utilization=util,
            solve_ms=solve_ms,
            features=features,
            stage_costs=stage_costs,
        )

    # -- plan-ahead mode ------------------------------------------------
    def _drain(self, work: queue.Queue) -> None:
        while True:
            item = work.get()
            if item is None:
                return
            lengths, ticket = item
            try:
                ticket._set(self.plan(lengths), None)
            except BaseException as e:  # propagate to result()
                ticket._set(None, e)

    def submit(self, lengths_per_instance: Sequence[np.ndarray]) -> PlanTicket:
        """Enqueue a plan computation on the background worker.

        Blocks only when ``queue_depth`` submissions are already in
        flight (bounded queue = backpressure, same discipline as the
        prefetching loader).
        """
        ticket = PlanTicket()
        # Enqueue under the lock so close()'s shutdown sentinel is always
        # the queue's last item -- a ticket can never land behind it and
        # hang.  The worker drains without the lock, so a blocking put
        # here (queue full) still makes progress.
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._work = queue.Queue(maxsize=self.queue_depth)
                self._worker = threading.Thread(
                    target=self._drain, args=(self._work,),
                    name="dispatcher-plan", daemon=True,
                )
                self._worker.start()
            self._work.put((list(lengths_per_instance), ticket))
        return ticket

    def close(self) -> None:
        """Stop the plan-ahead worker (idempotent)."""
        with self._lock:
            work, self._work, self._worker = self._work, None, None
            if work is not None:
                work.put(None)
