"""Decode-state specs (``repro.configs.registry``'s ``cache_specs`` and
``paged_cache_specs``), as ``(shape, dtype)`` tuples."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["cache_specs", "paged_cache_specs"]


def cache_specs(cfg: ModelConfig, B: int, seq_len: int):
    """Decode-state specs per family: the dense/moe/vlm KV cache (full, or
    a sliding-window ring) and the ssm state.  k/v and the ssm conv window
    are bf16 and the ssm state fp32 whatever the model's dtype, as in the
    JAX package.  The hybrid and audio families are not ported yet."""
    L = cfg.n_layers
    if cfg.family in ("dense", "moe", "vlm"):
        S = min(seq_len, cfg.sliding_window or seq_len)
        hd, Hkv = cfg.head_dim_, cfg.n_kv_heads
        return {
            "k": ((L, B, S, Hkv, hd), torch.bfloat16),
            "v": ((L, B, S, Hkv, hd), torch.bfloat16),
            "kv_pos": ((B, S), torch.int32),
            "kv_seg": ((B, S), torch.int32),
        }
    if cfg.family == "ssm":
        di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        return {
            "conv": ((L, B, K - 1, di), torch.bfloat16),
            "h": ((L, B, di, N), torch.float32),
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

    Only attention-cache families page.
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
