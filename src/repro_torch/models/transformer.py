"""Decoder and encoder stacks (``repro.models.transformer`` in PyTorch,
the dense/moe/vlm, ssm, hybrid and encoder paths).

Layer parameters are stacked on a leading ``[L, ...]`` axis, as in the
JAX package.  Where JAX scans one layer body over that axis, the port
unbinds the stacked leaves once and loops over the layers; the unbind's
backward stacks the layer gradients into one ``[L, ...]`` gradient.
``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``, not
reentrant): the backward recomputes the layer's forward, so an attention
layer runs its forward kernel twice per training step.  An moe layer
returns ``(x, aux)`` from the checkpointed body, with the routing aux
metrics of :func:`repro_torch.models.moe.moe_ffn`.  An ssm layer is a
pre-norm Mamba-1 block with a residual; under remat it runs the
selective-scan forward twice per training step.  The hybrid stack
(zamba2) runs groups of ``shared_attn_every`` pre-norm Mamba-2 layers,
each group followed by one application of the shared attention + MLP
block; under remat each Mamba-2 layer and each application is
checkpointed once (the JAX package also checkpoints the group around
them, a memory choice that would run each Mamba-2 forward a third time
here; the numbers are the same either way).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    apply_rope,
    gelu_mlp,
    layer_norm,
    rms_norm,
    rotary_embedding,
    swiglu,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba1_block, mamba2_block

__all__ = ["decoder_stack", "encoder_stack"]

Params = dict


def _norm(cfg: ModelConfig, x, scale):
    if cfg.nonparametric_norm:
        return layer_norm(x, None, None)
    if cfg.family == "audio":
        return layer_norm(x, scale, None)
    return rms_norm(x, scale)


def _attend(cfg: ModelConfig, p: Params, x, seg, pos, sin, cos, *, causal=True):
    """Self attention with rope on q and k (cross attention, the whisper
    decoder's, is not ported yet)."""
    B, T, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.segment_window and cfg.attention_backend != "reference":
        raise ValueError("window-chunked attention (segment_window) is not ported yet")
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, T, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attention(q, k, v, q_seg=seg, kv_seg=seg, q_pos=pos, kv_pos=pos,
                    causal=causal, window=cfg.sliding_window,
                    backend=cfg.attention_backend, block_q=cfg.block_q,
                    block_kv=cfg.block_kv)
    return out.reshape(B, T, H * hd) @ p["wo"]


def _ffn(cfg: ModelConfig, p: Params, x, valid=None):
    """The feed-forward block; the moe family returns ``(out, aux)``.  The
    port has no autotune cache: the grouped blocks are the config's, as
    in the JAX package with ``kernel_autotune`` off."""
    if cfg.family == "moe":
        return moe_ffn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                       top_k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor,
                       valid=valid, backend=cfg.moe_backend, block_m=cfg.moe_block_m,
                       block_n=cfg.moe_block_n)
    if cfg.family == "audio":
        return gelu_mlp(x, p["w_in"], p["w_out"])
    if cfg.family in ("dense", "vlm", "hybrid"):
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    raise ValueError(f"the port has no feed-forward block for family {cfg.family!r}")


def _attn_mlp_layer(cfg: ModelConfig, p: Params, x, seg, pos, sin, cos, *,
                    causal=True):
    """One attention + FFN layer: x, or ``(x, aux)`` for the moe family."""
    h = _norm(cfg, x, p.get("attn_norm"))
    x = x + _attend(cfg, p, h, seg, pos, sin, cos, causal=causal)
    h = _norm(cfg, x, p.get("mlp_norm"))
    if cfg.family == "moe":
        ff, aux = _ffn(cfg, p, h, seg > 0)
        return x + ff, aux
    return x + _ffn(cfg, p, h)


def _layer_slices(stacked: Params) -> list[Params]:
    """``{name: [L, ...]}`` -> one ``{name: [...]}`` dict per layer."""
    names = list(stacked)
    return [dict(zip(names, parts))
            for parts in zip(*(stacked[n].unbind(0) for n in names))]


def _remat(cfg: ModelConfig, body, x):
    """``body(x)``, checkpointed under ``cfg.remat``."""
    return checkpoint(body, x, use_reentrant=False) if cfg.remat else body(x)


def _run_layers(cfg: ModelConfig, stacked: Params, x, seg, pos, *, causal):
    """Returns (x, the per-layer aux dicts: one per layer for moe, else
    none)."""
    sin, cos = rotary_embedding(pos, cfg.head_dim_, cfg.rope_theta)
    auxs = []
    for lp in _layer_slices(stacked):
        body = functools.partial(_attn_mlp_layer, cfg, lp, seg=seg, pos=pos, sin=sin,
                                 cos=cos, causal=causal)
        out = _remat(cfg, body, x)
        if cfg.family == "moe":
            x, aux = out
            auxs.append(aux)
        else:
            x = out
    return x, auxs


def _ssm_kwargs(cfg: ModelConfig) -> dict:
    """Backend/block kwargs for the mamba blocks.  The scan backend keeps
    its chunking defaults; the pallas backend (the CUDA kernels in the
    port) takes block_d/chunk from the config.  The port has no autotune
    cache: the blocks are the config's, as in the JAX package with
    ``kernel_autotune`` off."""
    if cfg.ssm_backend != "pallas":
        return {}
    return dict(backend="pallas", block_d=cfg.ssm_block_d, chunk=cfg.ssm_chunk)


def _mamba1_layer(cfg: ModelConfig, p: Params, x, seg, ssm_kw):
    h = _norm(cfg, x, p.get("norm"))
    return x + mamba1_block(p, h, seg, ssm_state=cfg.ssm_state, **ssm_kw)


def _mamba2_layer(cfg: ModelConfig, p: Params, x, seg, ssm_kw):
    h = _norm(cfg, x, p.get("norm"))
    return x + mamba2_block(p, h, seg, ssm_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                            **ssm_kw)


def _hybrid_stack(cfg: ModelConfig, params: Params, x, seg, pos):
    """zamba2: layer ``g * every + i`` is the i-th Mamba-2 layer of group
    g; after each group, the shared attention + MLP block (one weight
    set, so its gradient sums every application)."""
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    if n_groups * every != cfg.n_layers:
        raise ValueError(f"n_layers {cfg.n_layers} is no multiple of shared_attn_every "
                         f"{every}")
    sin, cos = rotary_embedding(pos, cfg.head_dim_, cfg.rope_theta)
    ssm_kw = _ssm_kwargs(cfg)
    layers = _layer_slices(params["layers"])
    shared = functools.partial(_attn_mlp_layer, cfg, params["shared_attn"], seg=seg,
                               pos=pos, sin=sin, cos=cos)

    for g in range(n_groups):
        for lp in layers[g * every:(g + 1) * every]:
            x = _remat(cfg, functools.partial(_mamba2_layer, cfg, lp, seg=seg, ssm_kw=ssm_kw),
                       x)
        x = _remat(cfg, shared, x)
    return x


def decoder_stack(cfg: ModelConfig, params: Params, x, seg, pos):
    """x [B,T,D] -> ([B,T,D], aux).  For dense/vlm/ssm/hybrid aux is the
    scalar aux loss, 0; for moe a dict: ``lb_loss`` summed over layers,
    ``expert_load`` [E] and ``dropped_frac`` averaged over layers."""
    if cfg.family == "ssm":
        ssm_kw = _ssm_kwargs(cfg)
        for lp in _layer_slices(params["layers"]):
            x = _remat(cfg, functools.partial(_mamba1_layer, cfg, lp, seg=seg, ssm_kw=ssm_kw),
                       x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        return (_hybrid_stack(cfg, params, x, seg, pos),
                torch.zeros((), dtype=torch.float32, device=x.device))
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"the port's decoder_stack runs dense/moe/vlm/ssm/hybrid, not {cfg.family!r}")
    x, auxs = _run_layers(cfg, params["layers"], x, seg, pos, causal=True)
    if cfg.family == "moe":
        return x, {
            "lb_loss": torch.stack([a["lb_loss"] for a in auxs]).sum(),
            "expert_load": torch.stack([a["expert_load"] for a in auxs]).mean(0),
            "dropped_frac": torch.stack([a["dropped_frac"] for a in auxs]).mean(),
        }
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def encoder_stack(cfg: ModelConfig, params: Params, x, seg, pos):
    """Bidirectional encoder over ``params["enc_layers"]``; LayerNorm +
    GELU when ``cfg.family == "audio"`` (the modality encoders' path)."""
    return _run_layers(cfg, params["enc_layers"], x, seg, pos, causal=False)[0]
