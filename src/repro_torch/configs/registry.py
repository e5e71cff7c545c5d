"""Cache specs for the serving engine (``repro.configs.registry``'s
``paged_cache_specs``), as ``(shape, dtype)`` tuples."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["paged_cache_specs"]


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
