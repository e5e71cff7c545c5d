"""Continuous-batching engine loop: schedule -> prefill -> decode
(``repro.serving.engine.engine``'s ``Engine`` in PyTorch).

``Engine.step()`` asks the :class:`~repro_torch.serving.engine.scheduler.
Scheduler` for a :class:`StepPlan` under the token budget, runs the
admitted prompts through the chunked-prefill step
(``serving.serve_step.make_prefill_step``), runs the running sequences
through one paged decode call (``make_serve_step(paged=True)``), and
streams the greedy tokens into each request.  Sequences join and leave
the decode batch every step (iteration-level scheduling).

Exactness: prefill is a loop of the very same paged decode step, so
every request's greedy output stream is what feeding it token by token
through the decode step gives -- preemption included (recompute
teacher-forces the tokens generated so far).

``EngineReport`` carries throughput, TTFT, ITL, pool occupancy, budget
utilization, a padded-compute ``token_slots`` account and the phase
wall times.  On a CUDA device every phase timing synchronizes the device
before it reads the host clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core.cost_model import ServingCostModel
from repro_torch.obs.registry import QuantileSketch
from repro_torch.serving.engine.kv_pool import PagedKVPool
from repro_torch.serving.engine.request import Request, RequestState, SequenceState
from repro_torch.serving.engine.scheduler import Scheduler, StepPlan, serving_cost_model
from repro_torch.serving.serve_step import make_prefill_step, make_serve_step
from repro_torch.utils import resolve_device, round_up

__all__ = ["Engine", "EngineReport", "StepTiming", "build_report"]


@dataclasses.dataclass
class StepTiming:
    """One engine step's wall-time breakdown (host clock, device
    synchronized).  ``prefill_ms`` covers all prefill sub-batches of the
    step, ``decode_ms`` the one decode batch, ``schedule_ms`` the
    scheduler's host time."""

    step: int
    schedule_ms: float
    prefill_ms: float
    decode_ms: float
    n_prefill_seqs: int
    prefill_tokens: int  # tokens prefilled this step (recompute included)
    n_decode_seqs: int
    n_preempted: int = 0
    recompute_tokens: int = 0


@dataclasses.dataclass
class EngineReport:
    """Per-run serving metrics."""

    n_requests: int
    n_finished: int
    n_steps: int
    n_preemptions: int
    prompt_tokens: int  # first-time prefill tokens (== sum of prompt lens)
    recompute_tokens: int  # re-prefilled context after preemption (overhead)
    generated_tokens: int
    wall_s: float
    throughput_tok_s: float  # generated tokens / wall second
    token_slots: int  # padded (sequence, position) compute slots spent
    slot_efficiency: float  # useful tokens / token_slots
    ttft_steps_mean: float  # arrival -> first token, in engine steps
    ttft_steps_p95: float
    ttft_s_mean: float
    itl_steps_mean: float  # steps per generated token after the first
    occupancy_mean: float  # KV-pool block occupancy, sampled per step
    occupancy_max: float
    budget_util_mean: float  # budget_used / token_budget per step
    ttft_steps_p50: float = 0.0
    ttft_steps_p99: float = 0.0
    itl_steps_p50: float = 0.0
    itl_steps_p95: float = 0.0
    itl_steps_p99: float = 0.0
    # Phase wall times (sums over steps); prefill_ms_mean / decode_ms_mean
    # average over the steps that RAN that phase.
    schedule_s_total: float = 0.0
    prefill_s_total: float = 0.0
    decode_s_total: float = 0.0
    prefill_steps: int = 0
    decode_steps: int = 0
    prefill_ms_mean: float = 0.0
    decode_ms_mean: float = 0.0

    def summary(self) -> str:
        return (
            f"requests {self.n_finished}/{self.n_requests} finished in "
            f"{self.n_steps} steps ({self.n_preemptions} preemptions)\n"
            f"tokens   {self.prompt_tokens} prompt + {self.generated_tokens} "
            f"generated (+{self.recompute_tokens} recomputed); "
            f"{self.throughput_tok_s:.1f} tok/s wall, "
            f"{self.token_slots} compute slots "
            f"({self.slot_efficiency:.1%} useful)\n"
            f"latency  TTFT {self.ttft_steps_mean:.1f} steps mean / "
            f"{self.ttft_steps_p50:.1f}/{self.ttft_steps_p95:.1f}/"
            f"{self.ttft_steps_p99:.1f} p50/p95/p99 "
            f"({self.ttft_s_mean * 1e3:.1f} ms); "
            f"ITL {self.itl_steps_mean:.2f} steps mean / "
            f"{self.itl_steps_p50:.2f}/{self.itl_steps_p95:.2f}/"
            f"{self.itl_steps_p99:.2f} p50/p95/p99\n"
            f"pool     occupancy {self.occupancy_mean:.1%} mean / "
            f"{self.occupancy_max:.1%} max; budget {self.budget_util_mean:.1%}\n"
            f"phases   prefill {self.prefill_s_total * 1e3:.1f} ms over "
            f"{self.prefill_steps} steps ({self.prefill_ms_mean:.2f} ms/step); "
            f"decode {self.decode_s_total * 1e3:.1f} ms over "
            f"{self.decode_steps} steps ({self.decode_ms_mean:.2f} ms/step)"
        )


def _sketch_quantiles(xs: Sequence[float], qs: Sequence[float]) -> list[float]:
    """Percentiles via the streaming sketch (monotone in q)."""
    if not len(xs):
        return [0.0] * len(qs)
    sk = QuantileSketch()
    sk.extend(float(x) for x in xs)
    return [sk.quantile(q) for q in qs]


def build_report(requests: Sequence[Request], *, n_steps: int, wall_s: float,
                 token_slots: int, prompt_tokens: int, recompute_tokens: int,
                 generated_tokens: int,
                 occupancy_samples: Sequence[float],
                 budget_fracs: Sequence[float],
                 step_timings: Sequence[StepTiming] = ()) -> EngineReport:
    finished = [r for r in requests if r.state is RequestState.FINISHED]
    ttft_steps = [r.first_token_step - r.arrival_step for r in finished
                  if r.first_token_step is not None]
    ttft_s = [r.first_token_time - r.arrival_time for r in finished
              if r.first_token_time is not None]
    itl = [(r.finish_step - r.first_token_step) / (len(r.output_tokens) - 1)
           for r in finished
           if len(r.output_tokens) > 1 and r.finish_step is not None]
    # Recomputed context is real compute but not useful output.
    useful = prompt_tokens + generated_tokens
    pf = [t for t in step_timings if t.n_prefill_seqs]
    dc = [t for t in step_timings if t.n_decode_seqs]
    ttft_p50, ttft_p95, ttft_p99 = _sketch_quantiles(ttft_steps, (0.5, 0.95, 0.99))
    itl_p50, itl_p95, itl_p99 = _sketch_quantiles(itl, (0.5, 0.95, 0.99))
    return EngineReport(
        n_requests=len(requests),
        n_finished=len(finished),
        n_steps=n_steps,
        n_preemptions=sum(r.n_preemptions for r in requests),
        prompt_tokens=prompt_tokens,
        recompute_tokens=recompute_tokens,
        generated_tokens=generated_tokens,
        wall_s=wall_s,
        throughput_tok_s=generated_tokens / wall_s if wall_s > 0 else 0.0,
        token_slots=token_slots,
        slot_efficiency=useful / token_slots if token_slots else 0.0,
        ttft_steps_mean=float(np.mean(ttft_steps)) if ttft_steps else 0.0,
        ttft_steps_p95=ttft_p95,
        ttft_s_mean=float(np.mean(ttft_s)) if ttft_s else 0.0,
        itl_steps_mean=float(np.mean(itl)) if itl else 0.0,
        ttft_steps_p50=ttft_p50,
        ttft_steps_p99=ttft_p99,
        itl_steps_p50=itl_p50,
        itl_steps_p95=itl_p95,
        itl_steps_p99=itl_p99,
        occupancy_mean=float(np.mean(occupancy_samples)) if len(occupancy_samples) else 0.0,
        occupancy_max=float(np.max(occupancy_samples)) if len(occupancy_samples) else 0.0,
        budget_util_mean=float(np.mean(budget_fracs)) if len(budget_fracs) else 0.0,
        schedule_s_total=sum(t.schedule_ms for t in step_timings) * 1e-3,
        prefill_s_total=sum(t.prefill_ms for t in step_timings) * 1e-3,
        decode_s_total=sum(t.decode_ms for t in step_timings) * 1e-3,
        prefill_steps=len(pf),
        decode_steps=len(dc),
        prefill_ms_mean=float(np.mean([t.prefill_ms for t in pf])) if pf else 0.0,
        decode_ms_mean=float(np.mean([t.decode_ms for t in dc])) if dc else 0.0,
    )


class Engine:
    """One continuous-batching replica over one paged KV pool on
    ``device`` (the params must already live there)."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig, params, *,
                 attention_backend: str | None = None,
                 cost_model: ServingCostModel | None = None,
                 replica_id: int = 0,
                 device="cuda"):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"the port's engine serves dense/moe/vlm families, "
                             f"not {cfg.family!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.params = params
        self.replica_id = replica_id
        # Logical per-sequence cache length: the SWA ring needs only the
        # window (but never less); everything else must hold prompt +
        # generation.
        if cfg.sliding_window and engine_cfg.max_model_len < cfg.sliding_window:
            raise ValueError(
                f"max_model_len={engine_cfg.max_model_len} is smaller than "
                f"sliding_window={cfg.sliding_window}; the ring must cover "
                f"the full window")
        self.seq_slots = cfg.sliding_window or engine_cfg.max_model_len
        if self.seq_slots % engine_cfg.block_size:
            raise ValueError(
                f"per-sequence cache length {self.seq_slots} (sliding window "
                f"or max_model_len) must be a multiple of "
                f"block_size={engine_cfg.block_size}")
        self.table_width = self.seq_slots // engine_cfg.block_size
        self.pool = PagedKVPool(cfg, num_blocks=engine_cfg.num_blocks,
                                block_size=engine_cfg.block_size, device=self.device)
        self.scheduler = Scheduler(cost_model or serving_cost_model(cfg), engine_cfg)
        self._prefill = make_prefill_step(cfg, attention_backend=attention_backend)
        self._decode = make_serve_step(cfg, attention_backend=attention_backend,
                                       paged=True)

        self.waiting: list[SequenceState] = []
        self.running: list[SequenceState] = []
        self.requests: list[Request] = []
        self.plans: list[StepPlan] = []
        self.step_timings: list[StepTiming] = []
        self.n_steps = 0
        self.token_slots = 0
        self.prompt_tokens = 0
        self.recompute_tokens = 0
        self.generated_tokens = 0
        self.occupancy_samples: list[float] = []
        self.budget_fracs: list[float] = []
        self._wall_s = 0.0

    # ------------------------------------------------------------------
    def _clock(self) -> float:
        """Host clock after the device has finished the queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def submit(self, request: Request) -> None:
        """Queue a request (WAITING).  Prompt + generation must fit the
        logical cache unless the model's sliding window bounds reads."""
        total = request.prompt_len + request.max_new_tokens
        if self.cfg.sliding_window is None and total > self.seq_slots:
            raise ValueError(
                f"request {request.req_id}: prompt+max_new={total} exceeds "
                f"max_model_len={self.seq_slots}")
        # Reject up front what no amount of preemption could ever place
        # (a too-big head would livelock the strict-FIFO queue).
        need = self.pool.blocks_for_slots(min(total, self.seq_slots))
        if need > self.pool.usable_blocks:
            raise ValueError(
                f"request {request.req_id}: needs {need} KV blocks, pool has "
                f"{self.pool.usable_blocks} total")
        request.replica = self.replica_id
        request.arrival_time = time.perf_counter()
        self.requests.append(request)
        self.waiting.append(SequenceState(request))

    # ------------------------------------------------------------------
    def step(self) -> StepPlan:
        """One engine iteration: schedule -> batched prefill -> batched
        decode -> lifecycle bookkeeping.  Returns the step's plan."""
        t0 = self._clock()
        step = self.n_steps
        pre_recompute = self.recompute_tokens
        pre_preempt = sum(r.n_preemptions for r in self.requests)
        plan = self.scheduler.schedule(step, self.waiting, self.running,
                                       self.pool, seq_slots=self.seq_slots)
        t1 = self._clock()
        prefill_tokens = 0
        if plan.prefill:
            prefill_tokens = self._run_prefill(plan.prefill, step)
        t2 = self._clock()
        if plan.decode:
            self._run_decode(plan.decode, step)
        t3 = self._clock()
        self.step_timings.append(StepTiming(
            step=step,
            schedule_ms=(t1 - t0) * 1e3,
            prefill_ms=(t2 - t1) * 1e3,
            decode_ms=(t3 - t2) * 1e3,
            n_prefill_seqs=len(plan.prefill),
            prefill_tokens=prefill_tokens,
            n_decode_seqs=len(plan.decode),
            n_preempted=sum(r.n_preemptions for r in self.requests) - pre_preempt,
            recompute_tokens=self.recompute_tokens - pre_recompute))
        self.n_steps += 1
        self.plans.append(plan)
        self.occupancy_samples.append(self.pool.occupancy)
        self.budget_fracs.append(plan.budget_used / plan.budget)
        self._wall_s += time.perf_counter() - t0
        return plan

    def _prefill_groups(self, seqs: list[SequenceState],
                        prompts: list[np.ndarray]) -> list[list[int]]:
        """Split one step's admitted prefills into low-padding
        sub-batches: sort by prompt length (descending) and cut a new
        group whenever padding the next prompt up to the group's padded
        max would cost more than ``prefill_waste`` extra slots per
        useful token (Algorithm 2's bounded padded batches)."""
        ecfg = self.engine_cfg
        order = sorted(range(len(seqs)), key=lambda i: -prompts[i].size)
        groups: list[list[int]] = []
        cur: list[int] = []
        tp = useful = 0
        for i in order:
            n = int(prompts[i].size)
            if not cur:
                cur, tp, useful = [i], round_up(n, ecfg.prefill_pad), n
                continue
            if (len(cur) + 1) * tp > (useful + n) * (1.0 + ecfg.prefill_waste):
                groups.append(cur)
                cur, tp, useful = [i], round_up(n, ecfg.prefill_pad), n
            else:
                cur.append(i)
                useful += n
        if cur:
            groups.append(cur)
        return groups

    def _run_prefill(self, seqs: list[SequenceState], step: int) -> int:
        ecfg = self.engine_cfg
        total_tokens = 0
        prompts = [s.request.full_prompt() for s in seqs]
        for group in self._prefill_groups(seqs, prompts):
            B = len(group)
            lens = np.array([prompts[i].size for i in group], np.int64)
            Tp = round_up(int(lens.max()), ecfg.prefill_pad)
            batch = np.zeros((B, Tp), np.int64)
            for row, i in enumerate(group):
                batch[row, : prompts[i].size] = prompts[i]
            bt = self.pool.table_array([seqs[i].seq_id for i in group],
                                       self.table_width)
            first, _, cache = self._prefill(
                self.params, self._tensor(batch), self._tensor(lens),
                self.pool.cache, self._tensor(bt))
            self.pool.cache = cache
            first = first.cpu().numpy()
            now = time.perf_counter()
            total_tokens += int(lens.sum())
            for row, i in enumerate(group):
                # A recompute (post-preemption) re-prefills its whole
                # context; only a first admission counts as useful
                # prompt work.
                if seqs[i].request.first_token_step is None:
                    self.prompt_tokens += int(lens[row])
                else:
                    self.recompute_tokens += int(lens[row])
                seqs[i].t = int(lens[row])
                self._deliver(seqs[i], int(first[row, 0]), step, now)
            self.token_slots += B * Tp
        return total_tokens

    def _run_decode(self, seqs: list[SequenceState], step: int) -> None:
        ecfg = self.engine_cfg
        B = round_up(len(seqs), ecfg.decode_pad)
        tokens = np.zeros((B, 1), np.int64)
        t_vec = np.full(B, -1, np.int64)
        for i, seq in enumerate(seqs):
            tokens[i, 0] = seq.last_token
            t_vec[i] = seq.t
        bt = self.pool.table_array([s.seq_id for s in seqs], self.table_width)
        if B > len(seqs):
            bt = np.concatenate(
                [bt, np.zeros((B - len(seqs), self.table_width), np.int32)])
        nxt, _, cache = self._decode(
            self.params, self._tensor(tokens), self.pool.cache,
            self._tensor(bt), self._tensor(t_vec))
        self.pool.cache = cache
        nxt = nxt.cpu().numpy()
        now = time.perf_counter()
        for i, seq in enumerate(seqs):
            seq.t += 1
            self._deliver(seq, int(nxt[i, 0]), step, now)
        self.token_slots += B

    def _deliver(self, seq: SequenceState, token: int, step: int, now: float) -> None:
        seq.last_token = token
        req = seq.request
        req.record_token(token, step, now)
        self.generated_tokens += 1
        if req.done:
            req.finish(step, now)
            self.pool.free(seq.seq_id)
            self.running.remove(seq)

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request] = (), *,
            max_steps: int = 100_000) -> EngineReport:
        """Drive to completion: submit each request when the step clock
        reaches its ``arrival_step``, then step until idle."""
        pending = sorted(requests, key=lambda r: (r.arrival_step, r.req_id))
        while pending or self.has_work:
            while pending and pending[0].arrival_step <= self.n_steps:
                self.submit(pending.pop(0))
            self.step()
            if self.n_steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps "
                    f"({len(self.waiting)} waiting, {len(self.running)} running)")
        return self.report()

    def report(self) -> EngineReport:
        return build_report(
            self.requests, n_steps=self.n_steps, wall_s=self._wall_s,
            token_slots=self.token_slots, prompt_tokens=self.prompt_tokens,
            recompute_tokens=self.recompute_tokens,
            generated_tokens=self.generated_tokens,
            occupancy_samples=self.occupancy_samples,
            budget_fracs=self.budget_fracs,
            step_timings=self.step_timings)
