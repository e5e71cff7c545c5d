"""Serving steps: dense and paged decode, chunked prefill and the dense
decode cache (``repro.serving.serve_step`` in PyTorch, greedy sampling).

``make_serve_step(cfg, paged=True)`` is the continuous-batching decode
step: the cache is the paged KV pool (``registry.paged_cache_specs``),
reads go through a block-table gather, and ``t`` is a per-row position
vector -- see :mod:`repro_torch.models.decode`.

``make_prefill_step(cfg)`` is the serving prefill: a loop of the paged
decode step over prompt positions, so a batch of admitted prompts is
consumed exactly as if each prompt were fed token by token through the
decode step (which is what makes engine output streams reproduce the
per-request path).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, with_attention_backend
from repro_torch.configs.registry import cache_specs
from repro_torch.models.decode import decode_step
from repro_torch.utils import resolve_device, zeros_like_specs

__all__ = ["greedy_sample", "init_cache", "make_prefill_step", "make_serve_step"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic argmax sampling ([B,V] -> [B,1] int64)."""
    return torch.argmax(logits, dim=-1)[:, None]


def make_serve_step(cfg: ModelConfig, *, attention_backend: str | None = None,
                    paged: bool = False):
    """``attention_backend`` overrides ``cfg.attention_impl`` for the
    decode attention sites (resolved via ``cfg.decode_backend``).

    Dense (default): ``(params, tokens [B,1], cache, t)``.
    Paged: ``(params, tokens [B,1], cache, block_tables [B,W], t [B])``
    where ``cache`` is the pool layout and negative ``t`` entries mark
    inactive (padding) rows.  Both return (next_tokens, logits, cache)."""
    cfg = with_attention_backend(cfg, attention_backend)

    if paged:
        def paged_serve_step(params, tokens, cache, block_tables, t):
            logits, cache = decode_step(cfg, params, tokens, cache, t,
                                        block_tables=block_tables)
            return greedy_sample(logits), logits, cache

        return paged_serve_step

    def serve_step(params, tokens, cache, t):
        logits, cache = decode_step(cfg, params, tokens, cache, t)
        return greedy_sample(logits), logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, attention_backend: str | None = None):
    """Serving prefill on the paged cache.

    Returns ``prefill_step(params, prompts [B,Tp], lengths [B], cache,
    block_tables [B,W]) -> (first_tokens [B,1], last_logits [B,V],
    cache)``: loops the paged decode step over positions 0..Tp-1; row b
    goes inactive once ``p >= lengths[b]`` (its writes are dropped), and
    ``first_tokens`` is sampled from each row's logits at its own last
    prompt position."""
    cfg = with_attention_backend(cfg, attention_backend)

    def prefill_step(params, prompts, lengths, cache, block_tables):
        B, Tp = prompts.shape
        last = torch.zeros((B, params["embed"].shape[0]), dtype=torch.float32,
                           device=prompts.device)
        for p in range(Tp):
            t = torch.where(p < lengths, p, -1).to(torch.int32)
            logits, cache = decode_step(cfg, params, prompts[:, p:p + 1], cache, t,
                                        block_tables=block_tables)
            last = torch.where((p == lengths - 1)[:, None], logits, last)
        return greedy_sample(last), last, cache

    return prefill_step


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device="cuda"):
    """Zero-initialised dense decode cache matching ``registry.cache_specs``
    (the KV cache; for the ssm family the O(1) conv window and state; for
    the hybrid family the Mamba-2 state and the shared block's KV caches).
    The ssm and hybrid families serve through this dense cache and
    :func:`make_serve_step`: the paged pool and ``Engine`` refuse them."""
    return zeros_like_specs(cache_specs(cfg, batch, seq_len), resolve_device(device))
