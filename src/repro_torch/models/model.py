"""Parameter init for the dense/vlm LLM backbone (``repro.models.model``'s
``init_params`` with ``_init_attn``, ``_init_dense_mlp`` and
``_init_block_norms``).

Parameters are a dict of tensors with the JAX package's keys and stacked
``[L, ...]`` layer shapes.  They are made directly on the target device
in the config's dtype, one layer slice at a time, from a
``torch.Generator`` seeded by ``seed``; the full-width backbone never
passes through the CPU.  The numbers differ from ``jax.random``'s for
the same seed: parity tests load the JAX package's weights through
:mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import resolve_device

__all__ = ["init_params", "torch_dtype"]

Params = dict


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense(shape, dt, device, gen, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, drawn in fp32 one leading
    slice at a time (bounds the fp32 scratch to one layer)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(shape, dtype=dt, device=device)
    for part in (out if len(shape) == 3 else [out]):
        w = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        part.copy_(w.mul_(std))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Backbone parameters of a dense/vlm config (encoders are not
    built: serving runs the LLM backbone only)."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"the port builds dense/vlm backbones, not {cfg.family!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg)
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    hd, H, Hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale=None):
        return _dense(shape, dt, device, gen, scale)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    params: Params = {"embed": dense((V, D), scale=1.0)}
    layers: Params = {}
    if not cfg.nonparametric_norm:
        layers.update(attn_norm=ones((L, D)), mlp_norm=ones((L, D)))
    layers.update(wq=dense((L, D, H * hd)), wk=dense((L, D, Hkv * hd)),
                  wv=dense((L, D, Hkv * hd)), wo=dense((L, H * hd, D)))
    if cfg.qk_norm:
        layers.update(q_norm=ones((L, hd)), k_norm=ones((L, hd)))
    layers.update(w_gate=dense((L, D, F)), w_up=dense((L, D, F)),
                  w_down=dense((L, F, D)))
    params["layers"] = layers
    if not cfg.nonparametric_norm:
        params["final_norm"] = ones((D,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V))
    return params
