"""Post-balanced admission scheduling for the serving engine.

Each engine step the scheduler packs work into a *token budget* using
the same cost machinery as training-time Batch Post-Balancing:

  1. running DECODE sequences go first, FIFO by arrival, at
     ``decode_cost`` each (one token per step).  A sequence that needs a
     fresh KV block it cannot get triggers *preemption*: the
     youngest-arrival running sequence is evicted (blocks freed,
     recompute on re-admission) until the allocation fits -- mirroring
     vLLM's recompute preemption, oldest requests win.
  2. WAITING requests are admitted FIFO while their weighted prefill
     cost (``ServingCostModel.prefill_cost``: modality-weighted length
     through the paper's f(S)) fits the remaining budget, the pool can
     cover their prompt, and ``max_num_seqs`` is respected.  Strict
     FIFO within each cost class = no starvation: a too-expensive queue
     head *blocks* later arrivals instead of being skipped, and a head
     whose cost alone exceeds the budget is admitted on an otherwise
     idle step so it cannot livelock.

A copy of ``repro.serving.engine.scheduler`` without the multi-replica
``assign_replicas``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import EngineConfig
from repro_torch.core.cost_model import ServingCostModel, serving_cost_model
from repro_torch.serving.engine.kv_pool import PagedKVPool
from repro_torch.serving.engine.request import Request, SequenceState

__all__ = ["StepPlan", "Scheduler", "serving_cost_model"]


@dataclasses.dataclass
class StepPlan:
    """One engine step's scheduling decision (kept by the engine for the
    invariant tests and the report's budget accounting)."""

    step: int
    prefill: list[SequenceState]
    decode: list[SequenceState]
    admitted: list[int]  # req_ids newly WAITING->PREFILL this step
    preempted: list[int]  # req_ids evicted DECODE->WAITING this step
    budget: float
    budget_used: float

    @property
    def empty(self) -> bool:
        return not (self.prefill or self.decode)


def _fifo_key(seq: SequenceState):
    return (seq.request.arrival_step, seq.request.arrival_time,
            seq.request.req_id)


class Scheduler:
    def __init__(self, cost_model: ServingCostModel, engine_cfg: EngineConfig):
        self.cost_model = cost_model
        self.engine_cfg = engine_cfg

    # ------------------------------------------------------------------
    def request_cost(self, req: Request) -> float:
        """Weighted prefill cost of (re)computing ``req``'s context:
        generated-so-far tokens count as text (recompute prefills
        them)."""
        text = req.text_len + len(req.output_tokens)
        return self.cost_model.prefill_cost(text, req.modality_tokens)

    def prompt_blocks(self, req: Request, pool: PagedKVPool, seq_slots: int) -> int:
        """Blocks an admission must reserve: the full-prompt span,
        capped at the per-sequence ring length (windowed models wrap)."""
        span = min(req.prompt_len + len(req.output_tokens), seq_slots)
        return pool.blocks_for_slots(span)

    # ------------------------------------------------------------------
    def schedule(self, step: int, waiting: list[SequenceState],
                 running: list[SequenceState], pool: PagedKVPool,
                 *, seq_slots: int) -> StepPlan:
        """Mutates ``waiting``/``running`` and the pool's tables: admits,
        allocates, and preempts.  ``seq_slots`` is the per-sequence
        logical cache length (ring length for windowed models)."""
        budget = float(self.engine_cfg.token_budget)
        used = 0.0
        decode: list[SequenceState] = []
        prefill: list[SequenceState] = []
        admitted: list[int] = []
        preempted: list[int] = []

        # -- 1. running decodes, FIFO by arrival ------------------------
        running.sort(key=_fifo_key)
        pending = list(running)
        while pending:
            seq = pending.pop(0)
            if used + self.cost_model.decode_cost > budget and decode:
                break  # out of budget; the rest run next step
            # Ring sequences (seq_slots-bounded) never grow past their
            # table; growing sequences may need one fresh block.
            slot = seq.t % seq_slots
            need = pool.blocks_short(seq.seq_id, slot + 1)
            while need and not pool.can_alloc(need):
                victim = pending[-1] if pending else seq
                self._preempt(victim, pool, waiting, running)
                preempted.append(victim.seq_id)
                if victim is seq:
                    seq = None
                    break
                pending.pop()
            if seq is None:
                continue
            pool.ensure(seq.seq_id, slot + 1)
            decode.append(seq)
            used += self.cost_model.decode_cost

        # -- 2. waiting prefills, strict FIFO ---------------------------
        waiting.sort(key=_fifo_key)
        while waiting:
            seq = waiting[0]
            req = seq.request
            if len(running) + len(prefill) >= self.engine_cfg.max_num_seqs:
                break
            cost = self.request_cost(req)
            idle = not decode and not prefill
            if used + cost > budget and not idle:
                break  # head blocks the queue: FIFO, no skip-ahead
            n_blocks = self.prompt_blocks(req, pool, seq_slots)
            if not pool.can_alloc(n_blocks):
                break
            waiting.pop(0)
            pool.alloc(req.req_id, n_blocks)
            req.start_prefill()
            seq.reset()
            prefill.append(seq)
            admitted.append(req.req_id)
            used += cost

        running.extend(prefill)
        return StepPlan(step=step, prefill=prefill, decode=decode,
                        admitted=admitted, preempted=preempted,
                        budget=budget, budget_used=used)

    @staticmethod
    def _preempt(seq: SequenceState, pool: PagedKVPool,
                 waiting: list[SequenceState],
                 running: list[SequenceState]) -> None:
        pool.free(seq.seq_id)
        seq.request.preempt()
        seq.reset()
        running.remove(seq)
        waiting.append(seq)
