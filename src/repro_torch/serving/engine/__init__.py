"""Continuous-batching serving engine with paged KV cache and
post-balanced admission scheduling (``repro.serving.engine`` in PyTorch).

    request.py    Request / SequenceState lifecycle
    kv_pool.py    PagedKVPool block allocator (alloc/free)
    scheduler.py  token-budget admission
    engine.py     Engine.step() loop, EngineReport
"""
from repro_torch.serving.engine.engine import Engine, EngineReport, StepTiming, build_report
from repro_torch.serving.engine.kv_pool import NULL_BLOCK, PagedKVPool, PoolExhausted
from repro_torch.serving.engine.request import (
    Request,
    RequestState,
    SequenceState,
    requests_from_examples,
)
from repro_torch.serving.engine.scheduler import Scheduler, StepPlan, serving_cost_model

__all__ = [
    "Engine", "EngineReport", "StepTiming", "build_report",
    "NULL_BLOCK", "PagedKVPool", "PoolExhausted",
    "Request", "RequestState", "SequenceState", "requests_from_examples",
    "Scheduler", "StepPlan", "serving_cost_model",
]
