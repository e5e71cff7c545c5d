"""MLLM Global Orchestrator (paper S6).

(A copy of ``repro.core.orchestrator``, with the port's imports.)

Takes the per-DP-instance sampled example mini-batches and produces the
fully post-balanced device batch for one iteration:

  1. one Batch Post-Balancing Dispatcher per encoder phase (vision:
     packed / Alg 1; audio: padded / Alg 2 + conv cost model) -> Pi_Ek
  2. the global dispatcher for the LLM backbone, keyed on the
     INTERLEAVED sequence length (subsequences assembly, S6) -> Pi_M
  3. Rearrangement Composition: Pi_M o Pi_Ek^{-1} compiled into ONE
     communicator plan per encoder (halving all-to-all traffic)
  4. packed/padded stream assembly (tokens, segments, positions, labels,
     scatter indices) with static capacities

The dispatcher *computation* (steps 1-3) is pure host work with only
lengths as input, so the data pipeline overlaps it with the forward pass
via prefetching (repro.data.pipeline), exactly as S6 prescribes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.communicator import CommPlan, build_comm_plan
from repro_torch.core.cost_model import encoder_cost_model, llm_cost_model
from repro_torch.core.dispatcher import BatchPostBalancingDispatcher, DispatchPlan
from repro_torch.core.pipeline import PipelinePlan, plan_pipeline
from repro_torch.core.rearrangement import Rearrangement, compose
from repro_torch.sharding.specs import stage_partition
from repro_torch.data.packing import pack_padded_stream, pack_stream
from repro_torch.data.synthetic import Example
from repro_torch.utils import round_up as _round_up


def _ex_rng(seed: int, sid: int, tag: str) -> np.random.Generator:
    """Per-example deterministic content: the SAME example yields the
    same tokens/embeddings wherever the rearrangement places it.  This
    is what makes consequence-invariance (paper S3.3) *testable*: loss
    and gradients must be bit-identical under any balancing choice."""
    return np.random.default_rng(abs(hash((seed, sid, tag))) % (2**63))

__all__ = [
    "Capacities",
    "PhasePlans",
    "PlanAheadHandle",
    "OrchestratorReport",
    "MLLMGlobalOrchestrator",
    "llm_cost_model",
    "encoder_cost_model",
]


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Static per-shard token capacities (fixed across steps for jit).

    Post-balancing is what makes small capacities *safe*: the dispatcher
    minimizes the max per-shard cost, so the margin over the mean can be
    tight (this is the TPU static-shape payoff of the paper's idea)."""

    llm: int
    text: int
    enc_in: dict[str, int]
    enc_out: dict[str, int]
    enc_row: dict[str, int]  # padded phases: row length; 0 = packed
    chunk: dict[str, int]  # dense-a2a static per-peer chunk capacity


@dataclasses.dataclass
class OrchestratorReport:
    """Per-iteration accounting for benchmarks / EXPERIMENTS.md."""

    phase_utilization: dict[str, float]
    phase_max_cost: dict[str, float]
    phase_costs: dict[str, np.ndarray]
    comm_volume: dict[str, dict[str, int]]
    internode_volume: dict[str, int]
    solve_ms: float
    # Per-phase dispatcher host time (paper Table 2 analog), keyed by
    # phase name plus "compose" for the composition/comm-plan step.
    phase_solve_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    # Plan-ahead accounting, filled by the pipeline/harness: host time
    # the consumer actually waited on this plan (~0 when the previous
    # step's forward pass hid it), and whether it was overlapped.
    exposed_ms: float = 0.0
    overlapped: bool = False
    # Telemetry: per-phase per-shard feature vectors (d, 4) -- the
    # consumer pairs them with measured phase times and feeds them back
    # through observe_phase_times -- plus the adaptive-coefficient
    # version the plans were computed under and whether a stale
    # plan-ahead plan had to be re-planned (drift / coefficient swap).
    phase_features: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    coeff_version: int = -1
    replanned: bool = False
    # Pipeline mode (pp > 1): the simulated 1F1B + bubble-fill schedule
    # for this iteration (None when DP-only).
    pipeline: PipelinePlan | None = None


@dataclasses.dataclass
class PhasePlans:
    """Steps 1-3 of an iteration: every phase's dispatch plan plus the
    composed communicator plans.  Pure host work, computable from
    lengths alone -- this is the unit plan-ahead mode overlaps with the
    previous step's forward pass."""

    llm_plan: DispatchPlan
    enc_plans: dict[str, DispatchPlan]
    pi_es: dict[str, Rearrangement]
    composed: dict[str, Rearrangement]
    comm_plans: dict[str, CommPlan]
    phase_solve_ms: dict[str, float]
    solve_ms: float
    # Adaptive-coefficient version the plans were solved under (-1 when
    # no AdaptiveOrchestration is attached); plan_and_pack re-plans when
    # the version moved on (drift / calibration swap-in) before packing.
    coeff_version: int = -1
    # Pipeline mode: 1F1B microbatch schedule + encoder bubble fill.
    pipeline: PipelinePlan | None = None

    @property
    def features(self) -> dict[str, np.ndarray]:
        """Per-phase (d, 4) feature matrices for telemetry calibration."""
        out = {"llm": self.llm_plan.features}
        for name, plan in self.enc_plans.items():
            out[name] = plan.features
        return out


class PlanAheadHandle:
    """Future-like handle for a :meth:`plan_phases` running in the
    background; ``result()`` also reports how long the caller blocked
    (the *exposed* dispatcher latency)."""

    def __init__(self, thread: "threading.Thread", box: dict) -> None:
        self._thread = thread
        self._box = box

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: float | None = None) -> tuple[PhasePlans, float]:
        t0 = time.perf_counter()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("plan-ahead not finished")
        exposed_ms = (time.perf_counter() - t0) * 1e3
        if "error" in self._box:
            raise self._box["error"]
        return self._box["plans"], exposed_ms


class MLLMGlobalOrchestrator:
    def __init__(
        self,
        cfg: ModelConfig,
        d: int,
        *,
        instances_per_node: int | None = None,
        balance: bool = True,
        balance_encoders: bool = True,  # False = Pre-Balancing baseline (Fig 10)
        llm_algorithm: str | None = None,
        encoder_algorithm_override: str | None = None,  # Fig 11 rigid-algo ablation
        vocab: int | None = None,
        backend: str = "vectorized",
        concurrent_dispatch: bool = False,
        adaptive=None,
        metrics=None,
        pp: int | None = None,
        microbatches: int | None = None,
        bubble_fill: bool | None = None,
    ) -> None:
        self.cfg = cfg
        self.d = d
        # Pipeline mode (docs/pipeline.md): pp > 1 partitions the LLM
        # backbone into stages and every plan_phases() additionally
        # solves a 1F1B microbatch schedule with encoder bubble fill.
        # None falls back to the config's pp_* knobs.
        self.pp = int(pp if pp is not None else getattr(cfg, "pp_stages", 1))
        self.microbatches = int(
            microbatches if microbatches is not None
            else getattr(cfg, "pp_microbatches", 0))
        self.bubble_fill = bool(
            bubble_fill if bubble_fill is not None
            else getattr(cfg, "pp_bubble_fill", True))
        self.stage_fractions = None
        if self.pp > 1:
            part = stage_partition(cfg.n_layers, self.pp)
            self.stage_fractions = (
                np.asarray(part, np.float64) / float(cfg.n_layers))
        # Observability: an optional MetricsRegistry (repro.obs.registry)
        # receives per-phase solve-time histograms and plan/replan
        # counters.  None keeps the orchestrator dependency-free; the
        # StepLedger still gets everything via OrchestratorReport.
        self.metrics = metrics
        if metrics is not None:
            self._h_solve = metrics.histogram(
                "orch_plan_solve_ms", "dispatcher solve time per phase",
                labels=("phase",))
            self._c_plans = metrics.counter(
                "orch_plans", "phase-plan solves by mode",
                labels=("mode",))
        else:
            self._h_solve = self._c_plans = None
        self.vocab = vocab or cfg.vocab_size
        self.data_seed = 0
        self.instances_per_node = instances_per_node
        self.downsample = {e.name: e.downsample for e in cfg.encoders}
        # One dispatcher per modality runs on its own worker when
        # concurrent_dispatch is set (paper Fig. 4: per-phase dispatchers
        # are independent).
        self.concurrent_dispatch = concurrent_dispatch
        # Telemetry: an AdaptiveOrchestration (repro.telemetry.adaptive)
        # supplies each phase's cost model -- analytic prior until the
        # online fit is confident, calibrated coefficients after.  The
        # dispatchers are refreshed from it before every solve, and the
        # consumer feeds measured phase times back through
        # :meth:`observe_phase_times`.
        self.adaptive = adaptive
        self.replans = 0  # stale plan-ahead plans re-planned (drift/swap)
        self.llm_dispatcher = BatchPostBalancingDispatcher(
            d, adaptive.cost_model("llm") if adaptive else llm_cost_model(cfg),
            algorithm=llm_algorithm,
            instances_per_node=instances_per_node,
            balance=balance,
            backend=backend,
            stage_fractions=self.stage_fractions,
        )
        self.enc_dispatchers: dict[str, BatchPostBalancingDispatcher] = {}
        for e in cfg.encoders:
            self.enc_dispatchers[e.name] = BatchPostBalancingDispatcher(
                d,
                adaptive.cost_model(e.name) if adaptive
                else encoder_cost_model(e),
                algorithm=encoder_algorithm_override,
                instances_per_node=instances_per_node,
                balance=balance and balance_encoders,
                backend=backend,
            )

    # ------------------------------------------------------------------
    def default_capacities(
        self, examples_per_instance: Sequence[Sequence[Example]], *, margin: float = 1.5
    ) -> Capacities:
        """Derive static capacities from a (first) batch with headroom."""
        cfg = self.cfg
        all_ex = [ex for insts in examples_per_instance for ex in insts]
        tot_llm = sum(ex.total_len(self.downsample) for ex in all_ex)
        tot_text = sum(ex.text_len for ex in all_ex)
        # Probe plan: observed per-peer volumes size the static a2a chunk
        # (planning is cheap host work; a fixed d-based heuristic under-
        # provisions when a better-balanced plan concentrates one pair).
        probe_peer_max: dict[str, int] = {}
        if cfg.encoders and any(dd.balance for dd in self.enc_dispatchers.values()):
            probe = self.plan_phases(examples_per_instance)
            for name, comp in probe.composed.items():
                probe_peer_max[name] = int(comp.comm_matrix().max())
        llm = _round_up(int(tot_llm / self.d * margin) + 8, 128)
        text = _round_up(int(max(tot_text / self.d * margin, 1)) + 8, 128)
        enc_in, enc_out, enc_row, chunk = {}, {}, {}, {}
        for e in cfg.encoders:
            metas = [getattr(ex, f"{e.name}_meta") for ex in all_ex]
            metas = [m for m in metas if m > 0]
            if e.padded:
                # Rows must fit the largest POSSIBLE example, not just the
                # probe batch's max (static shapes across steps).
                row = _round_up(max(metas + [e.tokens_per_example_max]),
                                e.downsample * 8)
                rows_per_shard = max(1, int(np.ceil(len(metas) / self.d * margin)) + 1)
                cin = row * rows_per_shard
            else:
                row = 0
                cin = _round_up(int(max(sum(metas) / self.d * margin, 128)),
                                e.downsample * 128)
            cout = _round_up(cin // e.downsample, 128)
            enc_in[e.name], enc_out[e.name], enc_row[e.name] = cin, cout, row
            # Balanced plans send ~cout/d per peer (2x margin for skew)
            # and at least 2x the probe plan's observed peer max; one
            # example's tokens move to one peer atomically so the chunk
            # must also fit the largest example.  Unbalanced baselines
            # keep whole batches on one pair.
            max_ex_out = -(-max(metas + [e.tokens_per_example_max]) // e.downsample)
            if self.enc_dispatchers[e.name].balance:
                chunk[e.name] = _round_up(
                    max(cout * 2 // max(self.d, 1),
                        2 * probe_peer_max.get(e.name, 0), max_ex_out, 16), 8)
            else:
                chunk[e.name] = _round_up(cout, 8)
        return Capacities(llm=llm, text=text, enc_in=enc_in, enc_out=enc_out,
                          enc_row=enc_row, chunk=chunk)

    # ------------------------------------------------------------------
    def plan_phases(
        self,
        examples_per_instance: Sequence[Sequence[Example]],
        caps: Capacities | None = None,
    ) -> PhasePlans:
        """Steps 1-3: per-phase post-balancing plans + composition.

        Needs only example *lengths* -- no payloads -- so plan-ahead mode
        runs it for step k+1 while step k's forward pass is on device.
        With ``concurrent_dispatch`` every phase's solve runs on its
        dispatcher's own worker thread (NumPy releases the GIL in the
        sort/scan kernels, and one dispatcher per modality is exactly the
        paper's Fig. 4 layout).  Without ``caps`` the communicator plans
        are skipped (plan-only accounting, e.g. the overhead benchmark).
        """
        cfg = self.cfg
        t0 = time.perf_counter()
        phase_ms: dict[str, float] = {}
        coeff_version = -1
        if self.adaptive is not None:
            # Refresh every dispatcher's f(S) from the adaptive models
            # and stamp the plans with the coefficient version, so a
            # plan computed ahead under stale coefficients is detected
            # (and re-planned) at consumption time.
            coeff_version = self.adaptive.version
            self.llm_dispatcher.cost_model = self.adaptive.cost_model("llm")
            for name, disp in self.enc_dispatchers.items():
                disp.cost_model = self.adaptive.cost_model(name)

        # ---- LLM backbone plan (interleaved lengths, S6). -------------
        key = "text" if cfg.family == "audio" else "total"
        llm_lengths = [
            np.array(
                [ex.text_len if key == "text" else ex.total_len(self.downsample)
                 for ex in insts], np.int64)
            for insts in examples_per_instance
        ]
        enc_lengths = {
            e.name: [
                np.array([getattr(ex, f"{e.name}_meta") for ex in insts
                          if getattr(ex, f"{e.name}_meta") > 0], np.int64)
                for insts in examples_per_instance
            ]
            for e in cfg.encoders
        }

        enc_plans: dict[str, DispatchPlan] = {}
        if self.concurrent_dispatch and cfg.encoders:
            tickets = {
                name: self.enc_dispatchers[name].submit(lens)
                for name, lens in enc_lengths.items()
            }
            llm_plan = self.llm_dispatcher.plan(llm_lengths)
            for name, ticket in tickets.items():
                enc_plans[name] = ticket.result()
        else:
            llm_plan = self.llm_dispatcher.plan(llm_lengths)
            for name, lens in enc_lengths.items():
                enc_plans[name] = self.enc_dispatchers[name].plan(lens)
        phase_ms["llm"] = llm_plan.solve_ms
        for name, plan in enc_plans.items():
            phase_ms[name] = plan.solve_ms
        pi_m = llm_plan.pi

        # ---- Composition + communicator plans. -------------------------
        tc = time.perf_counter()
        pi_es: dict[str, Rearrangement] = {}
        composed: dict[str, Rearrangement] = {}
        comm_plans: dict[str, CommPlan] = {}
        for e in cfg.encoders:
            plan = enc_plans[e.name]
            # pi_e's orig_slot indexes the SUBSET of modality-bearing
            # examples; remap to full example slots so composition joins.
            pi_e = _remap_subset_slots(plan.pi, examples_per_instance, e.name)
            pi_es[e.name] = pi_e
            comp = compose(pi_m, pi_e)
            # Payload lengths after the connector downsample.
            comp = dataclasses.replace(
                comp, lengths=np.ceil(comp.lengths / e.downsample).astype(np.int64)
            )
            composed[e.name] = comp
            if caps is not None:
                src_starts = _encoder_out_starts(pi_e, caps.enc_row[e.name],
                                                 e.downsample)
                comm_plans[e.name] = build_comm_plan(
                    comp,
                    caps.enc_in[e.name] // e.downsample,
                    caps.enc_out[e.name],
                    src_starts=src_starts,
                    chunk_cap=caps.chunk[e.name],
                )
        phase_ms["compose"] = (time.perf_counter() - tc) * 1e3

        # ---- Pipeline schedule (pp > 1): 1F1B microbatch split over
        # the post-balanced per-rank batches + encoder bubble fill. ----
        pipeline = None
        if self.pp > 1:
            pipeline = plan_pipeline(
                cfg,
                self.llm_dispatcher.cost_model,
                llm_plan.dest_lengths,
                {name: plan.costs for name, plan in enc_plans.items()},
                pp=self.pp,
                n_micro=self.microbatches,
                bubble_fill=self.bubble_fill,
            )
            phase_ms["pipeline"] = pipeline.solve_ms

        if self.adaptive is not None:
            self.adaptive.record_plan_spans(phase_ms)
        if self._h_solve is not None:
            for name, ms in phase_ms.items():
                self._h_solve.observe(ms, phase=name)
        return PhasePlans(
            llm_plan=llm_plan,
            enc_plans=enc_plans,
            pi_es=pi_es,
            composed=composed,
            comm_plans=comm_plans,
            phase_solve_ms=phase_ms,
            solve_ms=(time.perf_counter() - t0) * 1e3,
            coeff_version=coeff_version,
            pipeline=pipeline,
        )

    def plan_ahead(
        self,
        examples_per_instance: Sequence[Sequence[Example]],
        caps: Capacities,
    ) -> PlanAheadHandle:
        """Run :meth:`plan_phases` on a background thread; the returned
        handle's ``result()`` reports the latency that was actually
        exposed to the caller."""
        box: dict = {}

        def run() -> None:
            try:
                box["plans"] = self.plan_phases(examples_per_instance, caps)
            except BaseException as e:
                box["error"] = e

        thread = threading.Thread(target=run, name="orch-plan-ahead", daemon=True)
        thread.start()
        return PlanAheadHandle(thread, box)

    # ------------------------------------------------------------------
    def plan_and_pack(
        self,
        examples_per_instance: Sequence[Sequence[Example]],
        caps: Capacities,
        rng: np.random.Generator,
        plans: PhasePlans | None = None,
        *,
        exposed_ms: float | None = None,
    ) -> tuple[dict[str, np.ndarray], OrchestratorReport]:
        cfg = self.cfg
        overlapped = plans is not None
        replanned = False
        if (plans is not None and self.adaptive is not None
                and plans.coeff_version != self.adaptive.version):
            # The coefficients moved (calibration swap-in or drift)
            # after this plan was computed ahead: the plan is still
            # *correct* (any rearrangement is), but it balances against
            # a stale f(S) -- re-plan with the current coefficients.
            # The synchronous re-solve is genuinely exposed latency, so
            # it is charged to exposed_ms and the step loses its
            # overlapped flag.
            plans = None
            replanned = True
            overlapped = False
            self.replans += 1
            if self._c_plans is not None:
                self._c_plans.inc(mode="replanned")
        if plans is None:
            t_replan = time.perf_counter()
            plans = self.plan_phases(examples_per_instance, caps)
            if replanned:
                exposed_ms = ((exposed_ms or 0.0)
                              + (time.perf_counter() - t_replan) * 1e3)
        llm_plan, enc_plans = plans.llm_plan, plans.enc_plans
        pi_m = llm_plan.pi
        pi_es, composed, comm_plans = plans.pi_es, plans.composed, plans.comm_plans
        solve_ms = plans.solve_ms

        # Global example ids (segment ids shared across phases).
        ex_id = {}
        nid = 1
        for i, insts in enumerate(examples_per_instance):
            for j, _ in enumerate(insts):
                ex_id[(i, j)] = nid
                nid += 1

        # ---- Pack device arrays. ---------------------------------------
        if cfg.family == "audio":
            batch = self._pack_encdec(examples_per_instance, ex_id, pi_m,
                                      pi_es, composed, comm_plans, caps, rng)
        elif cfg.encoders:
            batch = self._pack_multimodal(examples_per_instance, ex_id, pi_m,
                                          pi_es, composed, comm_plans, caps, rng)
        else:
            batch = self._pack_text(examples_per_instance, ex_id, pi_m, caps, rng)

        report = self._report(
            llm_plan, enc_plans, composed, solve_ms,
            phase_solve_ms=plans.phase_solve_ms,
            exposed_ms=exposed_ms if exposed_ms is not None else solve_ms,
            overlapped=overlapped,
        )
        report.phase_features = plans.features
        report.coeff_version = plans.coeff_version
        report.replanned = replanned
        report.pipeline = plans.pipeline
        if self._c_plans is not None:
            self._c_plans.inc(mode="overlapped" if overlapped else "sync")
        return batch, report

    # ------------------------------------------------------------------
    def observe_phase_times(
        self,
        times_by_phase,
        *,
        plans: PhasePlans | None = None,
        report: OrchestratorReport | None = None,
        step: int | None = None,
    ) -> dict[str, bool]:
        """Feed measured per-phase execution times back to calibration.

        ``times_by_phase[p]`` is a per-shard wall-time vector aligned
        with the phase's (d, 4) feature matrix, or a scalar synchronous
        step time (attributed to the straggler shard).  Features come
        from ``plans`` or ``report`` (whichever the caller kept).
        ``step`` defaults to the AdaptiveOrchestration's own counter.
        Returns per-phase drift flags; after a drift or a confident
        calibration swap the NEXT plan consumes the new coefficients
        (and a stale plan-ahead plan is re-planned in plan_and_pack)."""
        if self.adaptive is None:
            raise ValueError("orchestrator has no AdaptiveOrchestration "
                             "attached (pass adaptive= at construction)")
        if (plans is None) == (report is None):
            raise ValueError("pass exactly one of plans= / report=")
        features = plans.features if plans is not None else report.phase_features
        return self.adaptive.observe(features, times_by_phase, step=step)

    # ------------------------------------------------------------------
    def _pack_text(self, examples, ex_id, pi_m, caps, rng):
        dest_lengths = pi_m.dest_lengths()
        seg_ids = _dest_seg_ids(pi_m, ex_id)
        seg, pos, starts = pack_stream(dest_lengths, caps.llm, seg_ids=seg_ids)
        tokens = np.zeros(seg.shape, np.int32)
        for i in range(self.d):
            for j, l in enumerate(np.asarray(dest_lengths[i], np.int64)):
                sid = int(seg_ids[i][j])
                s0 = int(starts[i][j])
                tokens[i, s0 : s0 + l] = _ex_rng(self.data_seed, sid, "tok").integers(
                    1, self.vocab, int(l), dtype=np.int32
                )
        # Next-token labels within the same example.
        nxt_same = (np.roll(seg, -1, axis=1) == seg) & (seg > 0)
        nxt_same[:, -1] = False
        labels = np.where(nxt_same, np.roll(tokens, -1, axis=1), -1).astype(np.int32)
        return {"tokens": tokens, "labels": labels, "seg": seg, "pos": pos}

    # ------------------------------------------------------------------
    def _pack_multimodal(self, examples, ex_id, pi_m, pi_es, composed,
                         comm_plans, caps, rng):
        cfg = self.cfg
        d = self.d
        get_ex = lambda k: examples[int(pi_m.orig_inst[k])][int(pi_m.orig_slot[k])]
        order_k = np.lexsort((pi_m.dst_slot, pi_m.dst_inst))
        per_shard: list[list[int]] = [[] for _ in range(d)]
        for k in order_k:
            per_shard[int(pi_m.dst_inst[k])].append(int(k))

        llm_seg = np.zeros((d, caps.llm), np.int32)
        llm_pos = np.zeros((d, caps.llm), np.int32)
        llm_labels = np.full((d, caps.llm), -1, np.int32)
        tokens = np.zeros((d, caps.text), np.int32)
        text_dst = np.full((d, caps.text), caps.llm, np.int32)
        # pi_m entry k, modality -> llm stream slot where its subsequence starts.
        subseq_start: dict[tuple[int, str], int] = {}

        for t in range(d):
            off = 0
            toff = 0
            for k in per_shard[t]:
                ex = get_ex(k)
                sid = ex_id[(int(pi_m.orig_inst[k]), int(pi_m.orig_slot[k]))]
                L = ex.total_len(self.downsample)
                if off + L > caps.llm:
                    raise ValueError(f"llm cap {caps.llm} overflow on shard {t}")
                llm_seg[t, off : off + L] = sid
                llm_pos[t, off : off + L] = np.arange(L)

                text_parts = max(1, sum(1 for m in ex.order if m == "text"))
                tpart = ex.text_len // text_parts
                ex_tokens = _ex_rng(self.data_seed, sid, "tok").integers(
                    1, self.vocab, max(ex.text_len, 1), dtype=np.int32
                )
                is_text = np.zeros(L, bool)
                tok_at = np.zeros(L, np.int32)
                cur = off
                ti = 0
                seen_text = 0
                for m in ex.order:
                    if m == "text":
                        n_t = (ex.text_len - tpart * (text_parts - 1)
                               if seen_text == text_parts - 1 else tpart)
                        if toff + n_t > caps.text:
                            raise ValueError(f"text cap {caps.text} overflow")
                        tokens[t, toff : toff + n_t] = ex_tokens[ti : ti + n_t]
                        text_dst[t, toff : toff + n_t] = np.arange(cur, cur + n_t)
                        is_text[cur - off : cur - off + n_t] = True
                        tok_at[cur - off : cur - off + n_t] = ex_tokens[ti : ti + n_t]
                        toff += n_t
                        ti += n_t
                        seen_text += 1
                        cur += n_t
                    else:
                        subseq_start[(k, m)] = cur
                        cur += ex.subseq_len(m, self.downsample)
                nxt_text = np.roll(is_text, -1)
                nxt_text[-1] = False
                llm_labels[t, off : off + L] = np.where(
                    nxt_text, np.roll(tok_at, -1), -1
                )
                off += L

        batch = {
            "tokens": tokens,
            "text_dst": text_dst,
            "llm_seg": llm_seg,
            "llm_pos": llm_pos,
            "llm_labels": llm_labels,
        }
        # pi_m entry lookup for composed plans (keyed by orig example).
        pim_idx = {
            (int(a), int(b)): k
            for k, (a, b) in enumerate(zip(pi_m.orig_inst, pi_m.orig_slot))
        }
        for e in cfg.encoders:
            batch.update(self._pack_encoder_stream(
                e, pi_es[e.name], composed[e.name], comm_plans[e.name],
                caps, rng, ex_id, subseq_start, pim_idx,
            ))
        return batch

    def _pack_encoder_stream(self, e, pi_e, comp, comm_plan, caps, rng,
                             ex_id, subseq_start, pim_idx):
        d = self.d
        cap_in = caps.enc_in[e.name]
        row = caps.enc_row[e.name]
        dest_lengths = pi_e.dest_lengths()
        seg_ids = _dest_seg_ids(pi_e, ex_id)
        if e.padded:
            seg, pos, starts = pack_padded_stream(dest_lengths, cap_in, row,
                                                  seg_ids=seg_ids)
        else:
            seg, pos, starts = pack_stream(dest_lengths, cap_in, seg_ids=seg_ids,
                                           align=e.downsample)
        embeds = _fill_embeds(dest_lengths, starts, seg_ids, cap_in,
                              e.embed_dim, self.data_seed, e.name)

        # enc_dst: composed plan delivers tokens packed at dest (dst_starts);
        # map each token to its llm-stream slot.
        cap_out = caps.enc_out[e.name]
        enc_dst = np.full((d, cap_out), caps.llm, np.int32)
        for k in range(comp.n):
            t = int(comp.dst_inst[k])
            start = int(comm_plan.dst_starts[k])
            l = int(comp.lengths[k])
            m_entry = pim_idx[(int(comp.orig_inst[k]), int(comp.orig_slot[k]))]
            slot0 = subseq_start[(m_entry, e.name)]
            enc_dst[t, start : start + l] = np.arange(slot0, slot0 + l)
        return {
            f"enc_{e.name}_embeds": embeds,
            f"enc_{e.name}_seg": seg,
            f"enc_{e.name}_pos": pos,
            f"enc_{e.name}_dst": enc_dst,
            **_plan_arrays(e.name, comm_plan),
        }

    # ------------------------------------------------------------------
    def _pack_encdec(self, examples, ex_id, pi_m, pi_es, composed,
                     comm_plans, caps, rng):
        """Whisper-style: decoder text streams + encoder stream; the
        composed plan moves encoder OUTPUTS to the decoder's shard, where
        cross-attention pairs them by segment id."""
        e = self.cfg.encoders[0]
        base = self._pack_text(examples, ex_id, pi_m, caps, rng)
        pi_e, comp, comm_plan = pi_es[e.name], composed[e.name], comm_plans[e.name]
        cap_in = caps.enc_in[e.name]
        row = caps.enc_row[e.name]
        seg_ids = _dest_seg_ids(pi_e, ex_id)
        dest_lengths = pi_e.dest_lengths()
        seg, pos, starts = pack_padded_stream(dest_lengths, cap_in, row, seg_ids=seg_ids)
        embeds = _fill_embeds(dest_lengths, starts, seg_ids, cap_in,
                              e.embed_dim, self.data_seed, e.name)
        # Post-exchange layout at the decoder shard: packed by dst_slot.
        cap_out = caps.enc_out[e.name]
        seg_out = np.zeros((self.d, cap_out), np.int32)
        pos_out = np.zeros((self.d, cap_out), np.int32)
        for k in range(comp.n):
            t = int(comp.dst_inst[k])
            start = int(comm_plan.dst_starts[k])
            l = int(comp.lengths[k])
            sid = ex_id[(int(comp.orig_inst[k]), int(comp.orig_slot[k]))]
            seg_out[t, start : start + l] = sid
            pos_out[t, start : start + l] = np.arange(l)
        return {
            **base,
            f"enc_{e.name}_embeds": embeds,
            f"enc_{e.name}_seg": seg,
            f"enc_{e.name}_pos": pos,
            f"enc_{e.name}_seg_out": seg_out,
            f"enc_{e.name}_pos_out": pos_out,
            **_plan_arrays(e.name, comm_plan),
        }

    def _report(self, llm_plan, enc_plans, composed, solve_ms,
                phase_solve_ms=None, exposed_ms=None, overlapped=False):
        util = {"llm": llm_plan.utilization}
        maxc = {"llm": llm_plan.max_cost}
        costs = {"llm": llm_plan.costs}
        comm, inter = {}, {}
        for name, plan in enc_plans.items():
            util[name] = plan.utilization
            maxc[name] = plan.max_cost
            costs[name] = plan.costs
        for name, comp in composed.items():
            V = comp.comm_matrix()
            comm[name] = {"total": int(V.sum()), "self": int(np.trace(V))}
            if self.instances_per_node:
                inter[name] = int(comp.internode_volume(self.instances_per_node).max())
        return OrchestratorReport(
            phase_utilization=util,
            phase_max_cost=maxc,
            phase_costs=costs,
            comm_volume=comm,
            internode_volume=inter,
            solve_ms=solve_ms,
            phase_solve_ms=dict(phase_solve_ms or {}),
            exposed_ms=solve_ms if exposed_ms is None else exposed_ms,
            overlapped=overlapped,
        )


def _fill_embeds(dest_lengths, starts, seg_ids, cap_in, embed_dim, seed, tag):
    d = len(dest_lengths)
    embeds = np.zeros((d, cap_in, embed_dim), np.float32)
    for i in range(d):
        for j, l in enumerate(np.asarray(dest_lengths[i], np.int64)):
            sid = int(seg_ids[i][j])
            s0 = int(starts[i][j])
            embeds[i, s0 : s0 + l] = _ex_rng(seed, sid, tag).standard_normal(
                (int(l), embed_dim)
            ).astype(np.float32)
    return embeds


def _plan_arrays(name: str, plan: CommPlan) -> dict[str, np.ndarray]:
    return {
        f"enc_{name}_plan_pre_gather_dense": plan.pre_gather_dense,
        f"enc_{name}_plan_post_gather_dense": plan.post_gather_dense,
        f"enc_{name}_plan_post_mask": plan.post_mask,
        f"enc_{name}_plan_global_gather": plan.global_gather,
    }


def _remap_subset_slots(pi: Rearrangement, examples, modality: str) -> Rearrangement:
    """pi's orig_slot counts only modality-bearing examples per instance;
    remap to the instance's FULL example slots so composition joins."""
    mapping: dict[tuple[int, int], int] = {}
    for i, insts in enumerate(examples):
        sub = 0
        for j, ex in enumerate(insts):
            if getattr(ex, f"{modality}_meta") > 0:
                mapping[(i, sub)] = j
                sub += 1
    new_slot = np.array(
        [mapping[(int(a), int(b))] for a, b in zip(pi.orig_inst, pi.orig_slot)],
        np.int64,
    )
    return dataclasses.replace(pi, orig_slot=new_slot)


def _encoder_out_starts(pi_e: Rearrangement, row: int, ds: int) -> np.ndarray:
    """Token start of each example's CONNECTOR OUTPUT in its encoder-dest
    shard's output stream (flat, aligned with pi_e / composed entries)."""
    starts = np.zeros(pi_e.n, np.int64)
    for i in range(pi_e.d):
        sel = np.where(pi_e.dst_inst == i)[0]
        sel = sel[np.argsort(pi_e.dst_slot[sel])]
        off = 0
        for j, k in enumerate(sel):
            if row:  # padded rows: fixed stride (row already ds-aligned)
                starts[k] = j * (row // ds)
            else:
                starts[k] = off
                in_len = _round_up(int(pi_e.lengths[k]), ds)
                off += in_len // ds
    return starts


def _dest_seg_ids(pi: Rearrangement, ex_id):
    out = []
    for i in range(pi.d):
        sel = np.where(pi.dst_inst == i)[0]
        sel = sel[np.argsort(pi.dst_slot[sel])]
        out.append(np.array(
            [ex_id[(int(pi.orig_inst[k]), int(pi.orig_slot[k]))] for k in sel],
            np.int64,
        ))
    return out
