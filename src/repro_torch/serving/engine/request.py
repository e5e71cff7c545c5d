"""Request lifecycle for the continuous-batching serving engine.

State machine (one :class:`Request` per user request):

    WAITING --admit--> PREFILL --first token--> DECODE --done--> FINISHED
                 ^                                  |
                 +----------- preempt --------------+

Preemption (pool exhaustion) frees the sequence's KV blocks and
re-queues it for *recompute*: on re-admission the prefill covers the
original prompt PLUS the tokens generated so far (teacher-forcing its
own outputs), so a greedy request regenerates exactly the same stream.

Timestamps are recorded twice: in engine steps (deterministic, what the
tests and the benchmark's simulated-cost accounting use) and in wall
seconds (what the throughput numbers use).  ``modality_tokens`` carries
the per-modality prefill token counts (post-connector LLM tokens) that
the scheduler's :class:`~repro_torch.core.cost_model.ServingCostModel` weighs
-- the serving-side mirror of the structure the MLLM Global Orchestrator
gathers at training time (paper S7).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

__all__ = ["RequestState", "Request", "SequenceState", "requests_from_examples"]


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` holds the flattened LLM-token prompt (all modality
    subsequences post-connector); ``modality_tokens`` records how many
    of those tokens belong to each non-text modality.
    """

    req_id: int
    prompt: np.ndarray  # [T] int32 LLM tokens
    max_new_tokens: int
    modality_tokens: dict[str, int] = dataclasses.field(default_factory=dict)
    # Wall-clock arrival, stamped by Engine.submit() (same clock domain
    # as the other *_time fields); arrival_step is the deterministic
    # scheduling clock traces are authored in.
    arrival_time: float = 0.0
    arrival_step: int = 0

    state: RequestState = RequestState.WAITING
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    first_token_time: float | None = None
    first_token_step: int | None = None
    finish_time: float | None = None
    finish_step: int | None = None
    n_preemptions: int = 0
    replica: int | None = None

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, dtype=np.int32).ravel()
        if self.prompt.size == 0:
            raise ValueError(f"request {self.req_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.req_id}: max_new_tokens must be >= 1")

    # ------------------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def text_len(self) -> int:
        """Prompt tokens not accounted to any non-text modality."""
        return max(0, self.prompt_len - sum(self.modality_tokens.values()))

    @property
    def done(self) -> bool:
        return len(self.output_tokens) >= self.max_new_tokens

    def full_prompt(self) -> np.ndarray:
        """Prompt + generated-so-far: what a recompute must prefill."""
        if not self.output_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output_tokens, np.int32)])

    # -- transitions ----------------------------------------------------
    def start_prefill(self) -> None:
        assert self.state is RequestState.WAITING, self.state
        self.state = RequestState.PREFILL

    def record_token(self, token: int, step: int, now: float) -> None:
        """Append one generated token (the first flips PREFILL->DECODE)."""
        assert self.state in (RequestState.PREFILL, RequestState.DECODE)
        self.output_tokens.append(int(token))
        if self.first_token_step is None:
            self.first_token_step = step
            self.first_token_time = now
        self.state = RequestState.DECODE

    def finish(self, step: int, now: float) -> None:
        assert self.state is RequestState.DECODE, self.state
        self.state = RequestState.FINISHED
        self.finish_step = step
        self.finish_time = now

    def preempt(self) -> None:
        assert self.state is RequestState.DECODE, self.state
        self.state = RequestState.WAITING
        self.n_preemptions += 1

    # -- serialization (engine snapshot / replica handoff) --------------
    def to_state_dict(self) -> dict:
        """JSON-able lifecycle state.  KV-cache contents are NOT part of
        a request's state: a restored in-flight request re-enters
        through the preemption-recompute path (teacher-forcing
        ``output_tokens``), which regenerates the pages exactly."""
        return {
            "req_id": self.req_id,
            "prompt": self.prompt.tolist(),
            "max_new_tokens": self.max_new_tokens,
            "modality_tokens": dict(self.modality_tokens),
            "arrival_time": self.arrival_time,
            "arrival_step": self.arrival_step,
            "state": self.state.value,
            "output_tokens": list(self.output_tokens),
            "first_token_time": self.first_token_time,
            "first_token_step": self.first_token_step,
            "finish_time": self.finish_time,
            "finish_step": self.finish_step,
            "n_preemptions": self.n_preemptions,
            "replica": self.replica,
        }

    @staticmethod
    def from_state_dict(d: dict) -> "Request":
        req = Request(
            req_id=int(d["req_id"]),
            prompt=np.asarray(d["prompt"], np.int32),
            max_new_tokens=int(d["max_new_tokens"]),
            modality_tokens=dict(d["modality_tokens"]),
            arrival_time=float(d["arrival_time"]),
            arrival_step=int(d["arrival_step"]),
        )
        req.state = RequestState(d["state"])
        req.output_tokens = [int(t) for t in d["output_tokens"]]
        req.first_token_time = d["first_token_time"]
        req.first_token_step = d["first_token_step"]
        req.finish_time = d["finish_time"]
        req.finish_step = d["finish_step"]
        req.n_preemptions = int(d["n_preemptions"])
        req.replica = d["replica"]
        return req


@dataclasses.dataclass
class SequenceState:
    """Runtime decode state of one admitted request.

    ``t`` is the next cache position to write (= tokens already in the
    KV cache); ``last_token`` feeds the next decode step.  Block
    ownership lives in the pool's table, keyed by ``request.req_id``."""

    request: Request
    t: int = 0
    last_token: int = 0

    @property
    def seq_id(self) -> int:
        return self.request.req_id

    def reset(self) -> None:
        """Back to un-prefilled (preemption recompute)."""
        self.t = 0
        self.last_token = 0


def requests_from_examples(examples, *, vocab: int, max_total_len: int,
                           rng: np.random.Generator,
                           max_new_lo: int = 4, max_new_hi: int = 48,
                           length_scale: int = 1,
                           arrival_step_fn=None) -> list[Request]:
    """Turn ``data.synthetic`` Examples into a serving request trace.

    Subsequence lengths are divided by ``length_scale`` (synthetic
    examples are sized for 4k-32k training streams; serving smoke tests
    run at a few hundred slots) and clipped so prompt + max_new fits
    ``max_total_len``.  Prompt token ids are uniform in [1, vocab);
    ``modality_tokens`` carries the scaled per-modality counts.
    ``arrival_step_fn(i)`` assigns arrival steps (default: all at 0).
    """
    ds = {"vision": 1, "audio": 1}
    reqs = []
    for i, ex in enumerate(examples):
        mt = {}
        for m in ("vision", "audio"):
            n = ex.subseq_len(m, ds)
            if n:
                mt[m] = max(1, n // length_scale)
        text = max(2, ex.text_len // length_scale)
        max_new = int(rng.integers(max_new_lo, max_new_hi + 1))
        total = text + sum(mt.values())
        cap = max_total_len - max_new
        if total > cap:  # clip text first, then modalities proportionally
            over = total - cap
            cut = min(over, text - 2)
            text -= cut
            over -= cut
            for m in list(mt):
                if over <= 0:
                    break
                cut = min(over, mt[m] - 1)
                mt[m] -= cut
                over -= cut
            total = text + sum(mt.values())
        prompt = rng.integers(1, vocab, size=total).astype(np.int32)
        step = int(arrival_step_fn(i)) if arrival_step_fn else 0
        reqs.append(Request(req_id=i, prompt=prompt, max_new_tokens=max_new,
                            modality_tokens=mt, arrival_step=step))
    return reqs
