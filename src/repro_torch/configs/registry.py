"""Decode-state specs (``repro.configs.registry``'s ``cache_specs`` and
``paged_cache_specs``), as ``(shape, dtype)`` tuples."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["cache_specs", "paged_cache_specs"]


def cache_specs(cfg: ModelConfig, B: int, seq_len: int):
    """Decode-state specs per family: the dense/moe/vlm KV cache (full, or
    a sliding-window ring), the ssm state, and the hybrid's Mamba-2 state
    beside one KV cache per application of its shared attention block
    (``sa_*``: G = n_layers // shared_attn_every, the full history, no
    window).  k/v and the ssm conv window are bf16 and the ssm state fp32
    whatever the model's dtype, as in the JAX package.  The audio family
    is not ported yet."""
    L = cfg.n_layers
    hd, Hkv = cfg.head_dim_, cfg.n_kv_heads

    def attn_cache(n_layers, S):
        return {
            "k": ((n_layers, B, S, Hkv, hd), torch.bfloat16),
            "v": ((n_layers, B, S, Hkv, hd), torch.bfloat16),
            "kv_pos": ((B, S), torch.int32),
            "kv_seg": ((B, S), torch.int32),
        }

    if cfg.family in ("dense", "moe", "vlm"):
        return attn_cache(L, min(seq_len, cfg.sliding_window or seq_len))
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.family == "ssm":
        return {
            "conv": ((L, B, K - 1, di), torch.bfloat16),
            "h": ((L, B, di, N), torch.float32),
        }
    if cfg.family == "hybrid":
        P = cfg.ssm_headdim
        sa = attn_cache(L // cfg.shared_attn_every, seq_len)
        return {
            "conv": ((L, B, K - 1, di), torch.bfloat16),
            "h": ((L, B, di // P, P, N), torch.float32),
            **{f"sa_{k}": v for k, v in sa.items()},
        }
    raise ValueError(f"the port has no decode cache for family {cfg.family!r} yet")


def paged_cache_specs(cfg: ModelConfig, num_blocks: int, block_size: int):
    """Decode-state specs for the paged KV pool (serving engine).

    A pool of fixed-size blocks shared by every sequence: k/v are
    ``[L, num_blocks, block_size, Hkv, hd]`` in bf16 (whatever the
    model's dtype, as in the JAX package) and kv_pos/kv_seg are
    ``[num_blocks, block_size]`` int32, shared across layers.  A
    sequence's logical cache of S slots is the gather of its block table
    -- slot ``i`` lives at ``(table[i // block_size], i % block_size)``.

    Only attention-cache families page: ssm/hybrid decode state is O(1)
    per sequence (nothing to page).
    """
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"paged KV cache supports dense/moe/vlm families, not {cfg.family!r}")
    hd, Hkv, L = cfg.head_dim_, cfg.n_kv_heads, cfg.n_layers
    return {
        "k": ((L, num_blocks, block_size, Hkv, hd), torch.bfloat16),
        "v": ((L, num_blocks, block_size, Hkv, hd), torch.bfloat16),
        "kv_pos": ((num_blocks, block_size), torch.int32),
        "kv_seg": ((num_blocks, block_size), torch.int32),
    }
