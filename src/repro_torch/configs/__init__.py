"""Configs the port carries, resolved by name.

``get_config`` mirrors ``repro.configs.registry.get_config`` over the
architectures ported so far (``ARCHITECTURES``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    EncoderConfig,
    EngineConfig,
    ModelConfig,
    with_attention_backend,
)
from repro_torch.configs.registry import cache_specs, paged_cache_specs

__all__ = ["ARCHITECTURES", "EncoderConfig", "EngineConfig", "ModelConfig",
           "cache_specs", "get_config", "paged_cache_specs", "with_attention_backend"]

ARCHITECTURES = ("mllm_10b", "mllm_18b", "mllm_84b", "granite_moe_3b_a800m",
                 "falcon_mamba_7b", "zamba2_2_7b")


def get_config(name: str, *, attention_backend: str | None = None) -> ModelConfig:
    """Resolve an architecture id; ``attention_backend`` overrides the
    config's attention path (e.g. force "flash" / "reference")."""
    name = name.replace("-", "_")
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; the port carries {ARCHITECTURES}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return with_attention_backend(mod.CONFIG, attention_backend)
