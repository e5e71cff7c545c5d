"""1F1B pipeline schedule + encoder bubble-fill (ROADMAP item 1).

(A copy of ``repro.core.pipeline``, with the port's imports.)

The paper's headline regime (84B on 2560 GPUs) trains with pipeline
parallelism, where a 1F1B schedule leaves warm-up/cool-down *bubbles* of
``(f+b) * pp * (pp-1)`` idle device time per rank per step.  Optimus
(arxiv 2408.03505) and DIP (arxiv 2504.14145) fill those bubbles with
the MLLM's *encoder* microbatches -- compute that has no dependency on
the LLM stage being idle -- and that composes directly with Batch
Post-Balancing: the per-phase dispatchers equalize per-rank cost, this
module splits each rank's batch into microbatches (LPT, so the max
microbatch cost is minimized -- per-STAGE balancing, since stage cost =
stage_fraction * microbatch cost) and then places encoder chunks into
the simulated schedule's idle windows under real dependency bounds:

  * an encoder FORWARD chunk feeding microbatch ``i`` must END before
    ``F(0, i)`` starts (stage 0 consumes the connector outputs);
  * an encoder BACKWARD chunk for microbatch ``i`` is RELEASED by the
    end of ``B(0, i)`` (the connector grads come out of stage 0's
    backward).

Placement is earliest-deadline-first over each stage's idle windows;
chunks are divisible (an encoder microbatch is many layers).  In steady
state a second, volume-bound pass models the DIP "dual interleaved"
trick: cool-down bubbles absorb the NEXT iteration's encoder forward
(its inputs are already prefetched -- lengths-only planning runs a
step ahead) and warm-up bubbles absorb the PREVIOUS iteration's encoder
backward, so leftover chunks whose own-iteration bound cannot be met
still fill bubbles as long as per-stage volume allows.  Whatever
remains runs as a prologue (before the pipeline flush starts) or
epilogue (after the drain) -- which is exactly the *whole* encoder
cost in the no-fill baseline, so the two schedules are compared on
identical work.

Costs are abstract forward-compute units on ONE scale: LLM costs come
from the (possibly calibrated) LLM ``CostModel`` directly; encoder
phase costs are rescaled by :func:`repro.core.cost_model.
phase_flops_per_unit` ratios so a vision cost unit and an LLM cost unit
mean the same FLOPs.  Backward compute is ``bwd_ratio`` (default 2.0)
times forward.  Everything here is host-side planning over lengths --
the same dry-run contract as the dispatcher -- consumed by the
orchestrator, the gap waterfall (``pipeline_bubble_s{k}`` components),
the ledger, the Perfetto timeline, and ``benchmarks/pipeline_bubbles``.

See docs/pipeline.md for a worked schedule diagram.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.cost_model import CostModel, phase_flops_per_unit
from repro_torch.sharding.specs import stage_partition

__all__ = [
    "BWD_RATIO",
    "PipelinePlan",
    "ScheduleEvent",
    "plan_pipeline",
    "split_microbatches",
]

# Backward ≈ 2x forward FLOPs (grad wrt activations + grad wrt weights).
BWD_RATIO = 2.0


@dataclasses.dataclass(frozen=True)
class ScheduleEvent:
    """One simulated span on one stage's device (times in cost units)."""

    kind: str  # "F" | "B" | "encF" | "encB"
    stage: int
    micro: int
    start: float
    end: float


def split_microbatches(lengths: np.ndarray, n_micro: int,
                       model: CostModel) -> tuple[np.ndarray, np.ndarray]:
    """LPT split of one rank's examples into ``n_micro`` microbatches.

    Minimizing the max microbatch cost minimizes the max per-stage load
    simultaneously (stage cost = stage_fraction * microbatch cost), so
    this IS the per-stage post-balancing step.  Returns
    ``(assign, micro_costs)``: per-example microbatch index and the
    (n_micro,) cost vector.  Single-example cost is ``alpha*l +
    beta*l^2`` for every f(S) variant.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    assign = np.zeros(lengths.size, dtype=np.int64)
    costs = np.zeros(n_micro, dtype=np.float64)
    if lengths.size == 0:
        return assign, costs
    w = model.alpha * lengths + model.beta * lengths * lengths
    order = np.argsort(-w, kind="stable")
    for k in order:  # exact LPT greedy (n is small: one rank's batch)
        i = int(np.argmin(costs))
        assign[k] = i
        costs[i] += w[k]
    return assign, costs


# ----------------------------------------------------------------------
# 1F1B simulation (one DP rank).
# ----------------------------------------------------------------------
def _simulate_1f1b(fwd: np.ndarray, bwd: np.ndarray):
    """Event-driven non-interleaved 1F1B over ``fwd/bwd`` of shape
    (pp, m).  Stage s runs ``min(pp-1-s, m)`` warm-up forwards, then
    strict 1F1B alternation, then cool-down backwards.  Returns
    ``(f_start, f_end, b_start, b_end, makespan)`` each (pp, m)."""
    pp, m = fwd.shape
    f_s = np.zeros((pp, m)); f_e = np.full((pp, m), -1.0)
    b_s = np.zeros((pp, m)); b_e = np.full((pp, m), -1.0)
    ops: list[list[tuple[str, int]]] = []
    for s in range(pp):
        w = min(pp - 1 - s, m)
        seq = [("F", i) for i in range(w)]
        for i in range(w, m):
            seq += [("F", i), ("B", i - w)]
        seq += [("B", i) for i in range(max(m - w, 0), m)]
        ops.append(seq)
    ptr = [0] * pp
    clock = np.zeros(pp)
    remaining = 2 * pp * m
    while remaining:
        progressed = False
        for s in range(pp):
            while ptr[s] < len(ops[s]):
                kind, i = ops[s][ptr[s]]
                if kind == "F":
                    if s > 0 and f_e[s - 1, i] < 0:
                        break
                    dep = f_e[s - 1, i] if s > 0 else 0.0
                    t0 = max(clock[s], dep)
                    f_s[s, i], f_e[s, i] = t0, t0 + fwd[s, i]
                else:
                    if s < pp - 1 and b_e[s + 1, i] < 0:
                        break
                    dep = b_e[s + 1, i] if s < pp - 1 else 0.0
                    t0 = max(clock[s], dep, f_e[s, i])
                    b_s[s, i], b_e[s, i] = t0, t0 + bwd[s, i]
                clock[s] = max(f_e[s, i], b_e[s, i], clock[s])
                ptr[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:  # pragma: no cover - schedule is acyclic
            raise RuntimeError("1F1B simulation deadlocked")
    return f_s, f_e, b_s, b_e, float(clock.max())


def _idle_windows(f_s, f_e, b_s, b_e, makespan: float) -> list[list[list[float]]]:
    """Per-stage idle windows [t0, t1] in the bare 1F1B schedule,
    including leading idle before the first op and trailing idle."""
    pp = f_s.shape[0]
    out: list[list[list[float]]] = []
    for s in range(pp):
        spans = sorted(
            [(float(a), float(b)) for a, b in zip(f_s[s], f_e[s])]
            + [(float(a), float(b)) for a, b in zip(b_s[s], b_e[s])])
        windows: list[list[float]] = []
        cur = 0.0
        for a, b in spans:
            if a > cur + 1e-12:
                windows.append([cur, a])
            cur = max(cur, b)
        if makespan > cur + 1e-12:
            windows.append([cur, makespan])
        out.append(windows)
    return out


def _edf_fill(windows: list[list[float]], sizes: np.ndarray,
              bounds: np.ndarray, *, deadline: bool, stage: int,
              kind: str, events: list[ScheduleEvent]):
    """Place divisible chunks into idle ``windows`` (mutated in place).

    ``deadline=True``: chunk i may only occupy time < ``bounds[i]``
    (encoder forward -- must finish before F(0, i)); chunks arrive in
    deadline order.  ``deadline=False``: chunk i may only occupy time
    >= ``bounds[i]`` (encoder backward -- released by B(0, i)).
    Returns (placed_total, leftover_per_chunk_sum).
    """
    placed = 0.0
    leftover = 0.0
    for i, size in enumerate(sizes):
        need = float(size)
        bound = float(bounds[i])
        for w in windows:
            if need <= 1e-12:
                break
            a, b = w
            if deadline:
                hi = min(b, bound)
                take = min(need, max(hi - a, 0.0))
                if take > 1e-12:
                    events.append(ScheduleEvent(kind, stage, i, a, a + take))
                    w[0] = a + take
            else:
                lo = max(a, bound)
                take = min(need, max(b - lo, 0.0))
                if take > 1e-12:
                    events.append(ScheduleEvent(kind, stage, i, lo, lo + take))
                    w[0] = lo + take
            need -= max(take, 0.0)
        placed += float(size) - need
        leftover += need
    return placed, leftover


def _volume_fill(windows: list[list[float]], amount: float, *, stage: int,
                 kind: str, events: list[ScheduleEvent]) -> float:
    """Steady-state cross-iteration pass: fill remaining window capacity
    with ``amount`` of adjacent-iteration encoder work (no per-chunk
    bound -- the previous iteration's backward / next iteration's
    forward are both schedulable anywhere).  Returns the placed total.
    """
    placed = 0.0
    for w in windows:
        if amount - placed <= 1e-12:
            break
        a, b = w
        take = min(amount - placed, max(b - a, 0.0))
        if take > 1e-12:
            events.append(ScheduleEvent(kind, stage, -1, a, a + take))
            w[0] = a + take
            placed += take
    return placed


# ----------------------------------------------------------------------
@dataclasses.dataclass
class PipelinePlan:
    """Per-iteration pipeline schedule plan across all DP ranks.

    All times are abstract LLM-forward cost units (the waterfall's
    online cost->ms calibration puts them on the wall clock).
    """

    pp: int
    n_micro: int
    d: int
    partition: tuple[int, ...]
    stage_fractions: np.ndarray        # (pp,)
    micro_assign: list[np.ndarray]     # per rank: example -> microbatch
    micro_costs: np.ndarray            # (d, n_micro) full-model fwd cost
    enc_cost: np.ndarray               # (d,) encoder fwd cost, LLM units
    bubble_fill: bool
    # Simulation results:
    makespan_1f1b: np.ndarray          # (d,) bare LLM pipeline makespan
    bubble_total: np.ndarray           # (d,) theoretical 1F1B bubble time
    filled: np.ndarray                 # (d,) encoder compute placed in bubbles
    stage_busy: np.ndarray             # (d, pp) useful compute per stage
    stage_idle: np.ndarray             # (d, pp) unfilled idle per stage
    rank_total: np.ndarray             # (d,) prologue + makespan + epilogue
    rank_total_nofill: np.ndarray      # (d,) same schedule, no bubble fill
    useful: np.ndarray                 # (d,) total useful compute (LLM + enc)
    solve_ms: float = 0.0
    critical_rank: int = 0
    events: list[ScheduleEvent] = dataclasses.field(default_factory=list)

    # -- headline metrics ----------------------------------------------
    @property
    def fill_fraction(self) -> float:
        """Filled fraction of the theoretical 1F1B bubble time."""
        tot = float(self.bubble_total.sum())
        return float(self.filled.sum()) / tot if tot > 0 else 0.0

    @property
    def projected_mfu(self) -> float:
        t = float(self.rank_total.max())
        return (float(self.useful.sum()) / (self.d * self.pp * t)
                if t > 0 else 0.0)

    @property
    def projected_mfu_nofill(self) -> float:
        t = float(self.rank_total_nofill.max())
        return (float(self.useful.sum()) / (self.d * self.pp * t)
                if t > 0 else 0.0)

    @property
    def mfu_uplift(self) -> float:
        return self.projected_mfu - self.projected_mfu_nofill

    def waterfall_inputs(self) -> dict:
        """The ``pipeline=`` payload for :meth:`GapWaterfall.observe`."""
        return {
            "stages": self.pp,
            "stage_bubble": self.stage_idle.mean(axis=0),
            "rank_totals": self.rank_total,
            "useful_per_device": float(self.useful.mean()) / self.pp,
            "critical_cost": float(self.rank_total.max()),
        }

    def to_dict(self) -> dict:
        return {
            "pp": self.pp,
            "n_micro": self.n_micro,
            "d": self.d,
            "partition": list(self.partition),
            "bubble_fill": self.bubble_fill,
            "fill_fraction": self.fill_fraction,
            "bubble_total": float(self.bubble_total.sum()),
            "filled": float(self.filled.sum()),
            "projected_mfu": self.projected_mfu,
            "projected_mfu_nofill": self.projected_mfu_nofill,
            "mfu_uplift": self.mfu_uplift,
            "solve_ms": self.solve_ms,
        }


def plan_pipeline(
    cfg,
    llm_model: CostModel,
    dest_lengths: Sequence[np.ndarray],
    enc_costs: Mapping[str, np.ndarray] | None = None,
    *,
    pp: int,
    n_micro: int = 0,
    bubble_fill: bool = True,
    layer_costs: np.ndarray | None = None,
    bwd_ratio: float = BWD_RATIO,
    keep_events: bool = True,
) -> PipelinePlan:
    """Build the per-iteration pipeline plan for all DP ranks.

    ``dest_lengths`` is the post-balanced per-rank LLM length layout
    (``DispatchPlan.dest_lengths``); ``enc_costs[name]`` the (d,)
    per-rank cost vector of encoder phase ``name`` in its OWN cost
    units (``DispatchPlan.costs``) -- rescaled here onto the LLM unit
    via :func:`phase_flops_per_unit`.  ``n_micro=0`` defaults to
    ``2*pp`` (enough microbatches to saturate the steady state).
    ``layer_costs`` optionally drives a cost-weighted
    :func:`stage_partition` (calibrated per-layer costs).
    """
    t0 = time.perf_counter()
    d = len(dest_lengths)
    if pp < 2:
        raise ValueError(f"plan_pipeline needs pp >= 2, got {pp}")
    n_micro = int(n_micro) or 2 * pp
    partition = stage_partition(cfg.n_layers, pp, layer_costs)
    frac = np.asarray(partition, dtype=np.float64) / float(cfg.n_layers)

    flops = phase_flops_per_unit(cfg)
    enc_costs = enc_costs or {}
    enc_fwd = np.zeros(d)
    for name, costs in enc_costs.items():
        enc_fwd += (flops[name] / flops["llm"]) * np.asarray(costs, np.float64)

    micro_assign: list[np.ndarray] = []
    micro_costs = np.zeros((d, n_micro))
    for r in range(d):
        assign, costs = split_microbatches(dest_lengths[r], n_micro, llm_model)
        micro_assign.append(assign)
        micro_costs[r] = costs

    makespan_1f1b = np.zeros(d)
    bubble_total = np.zeros(d)
    filled = np.zeros(d)
    stage_busy = np.zeros((d, pp))
    stage_idle = np.zeros((d, pp))
    rank_total = np.zeros(d)
    rank_total_nofill = np.zeros(d)
    useful = np.zeros(d)
    events_by_rank: list[list[ScheduleEvent]] = []

    for r in range(d):
        fwd = np.outer(frac, micro_costs[r])          # (pp, m)
        bwd = bwd_ratio * fwd
        f_s, f_e, b_s, b_e, makespan = _simulate_1f1b(fwd, bwd)
        makespan_1f1b[r] = makespan
        llm_busy = fwd.sum(axis=1) + bwd.sum(axis=1)  # (pp,)
        bubble_total[r] = pp * makespan - float(llm_busy.sum())
        useful[r] = float(llm_busy.sum()) + (1.0 + bwd_ratio) * enc_fwd[r]

        ev: list[ScheduleEvent] = []
        if keep_events:
            for s in range(pp):
                for i in range(n_micro):
                    if fwd[s, i] > 0:
                        ev.append(ScheduleEvent("F", s, i, f_s[s, i], f_e[s, i]))
                        ev.append(ScheduleEvent("B", s, i, b_s[s, i], b_e[s, i]))

        # Encoder work: each stage owns a 1/pp slice of the encoder
        # stack (same sharding rule as the LLM layers), one chunk per
        # microbatch.  Forward chunks are deadline-bound by F(0, i),
        # backward chunks released by B(0, i).
        enc_f_chunk = np.full(n_micro, enc_fwd[r] / (pp * n_micro))
        enc_b_chunk = bwd_ratio * enc_f_chunk
        pro = np.zeros(pp)
        epi = np.zeros(pp)
        for s in range(pp):
            if bubble_fill and enc_fwd[r] > 0:
                windows = _idle_windows(f_s[s:s + 1], f_e[s:s + 1],
                                        b_s[s:s + 1], b_e[s:s + 1],
                                        makespan)[0]
                pf, lf = _edf_fill(windows, enc_f_chunk, f_s[0],
                                   deadline=True, stage=s, kind="encF",
                                   events=ev if keep_events else [])
                pb, lb = _edf_fill(windows, enc_b_chunk, b_e[0],
                                   deadline=False, stage=s, kind="encB",
                                   events=ev if keep_events else [])
                # Steady-state cross-iteration fill: leftover backward
                # rides in the next step's warm-up bubbles, leftover
                # forward (of the next, prefetched step) in this step's
                # cool-down bubbles -- volume-bound per stage.
                xb = _volume_fill(windows, lb, stage=s, kind="encB",
                                  events=ev if keep_events else [])
                xf = _volume_fill(windows, lf, stage=s, kind="encF",
                                  events=ev if keep_events else [])
                filled[r] += pf + pb + xb + xf
                pro[s], epi[s] = lf - xf, lb - xb
            else:
                pro[s] = float(enc_f_chunk.sum())
                epi[s] = float(enc_b_chunk.sum())
        prologue, epilogue = float(pro.max()), float(epi.max())
        rank_total[r] = prologue + makespan + epilogue
        rank_total_nofill[r] = makespan + float(
            enc_f_chunk.sum() + enc_b_chunk.sum())
        stage_busy[r] = llm_busy + (1.0 + bwd_ratio) * enc_fwd[r] / pp
        stage_idle[r] = rank_total[r] - stage_busy[r]
        events_by_rank.append(ev)

    critical = int(np.argmax(rank_total)) if d else 0
    return PipelinePlan(
        pp=pp, n_micro=n_micro, d=d, partition=partition,
        stage_fractions=frac, micro_assign=micro_assign,
        micro_costs=micro_costs, enc_cost=enc_fwd,
        bubble_fill=bubble_fill, makespan_1f1b=makespan_1f1b,
        bubble_total=bubble_total, filled=filled, stage_busy=stage_busy,
        stage_idle=stage_idle, rank_total=rank_total,
        rank_total_nofill=rank_total_nofill, useful=useful,
        solve_ms=(time.perf_counter() - t0) * 1e3,
        critical_rank=critical,
        events=events_by_rank[critical] if (keep_events and d) else [],
    )
