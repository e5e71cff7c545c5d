"""Decoder and encoder stacks (``repro.models.transformer`` in PyTorch,
the dense/vlm and encoder paths).

Layer parameters are stacked on a leading ``[L, ...]`` axis, as in the
JAX package.  Where JAX scans one layer body over that axis, the port
unbinds the stacked leaves once and loops over the layers; the unbind's
backward stacks the layer gradients into one ``[L, ...]`` gradient.
``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``, not
reentrant): the backward recomputes the layer's forward, so an attention
layer runs its forward kernel twice per training step.
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


def _ffn(cfg: ModelConfig, p: Params, x):
    if cfg.family == "audio":
        return gelu_mlp(x, p["w_in"], p["w_out"])
    if cfg.family in ("dense", "vlm"):
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    raise ValueError(f"the port has no feed-forward block for family {cfg.family!r}")


def _attn_mlp_layer(cfg: ModelConfig, p: Params, x, seg, pos, sin, cos, *,
                    causal=True):
    h = _norm(cfg, x, p.get("attn_norm"))
    x = x + _attend(cfg, p, h, seg, pos, sin, cos, causal=causal)
    h = _norm(cfg, x, p.get("mlp_norm"))
    return x + _ffn(cfg, p, h)


def _layer_slices(stacked: Params) -> list[Params]:
    """``{name: [L, ...]}`` -> one ``{name: [...]}`` dict per layer."""
    names = list(stacked)
    return [dict(zip(names, parts))
            for parts in zip(*(stacked[n].unbind(0) for n in names))]


def _run_layers(cfg: ModelConfig, stacked: Params, x, seg, pos, *, causal):
    sin, cos = rotary_embedding(pos, cfg.head_dim_, cfg.rope_theta)
    for lp in _layer_slices(stacked):
        body = functools.partial(_attn_mlp_layer, cfg, lp, seg=seg, pos=pos, sin=sin,
                                 cos=cos, causal=causal)
        x = checkpoint(body, x, use_reentrant=False) if cfg.remat else body(x)
    return x


def decoder_stack(cfg: ModelConfig, params: Params, x, seg, pos):
    """x [B,T,D] -> ([B,T,D], aux), the dense/vlm branch: aux is the
    scalar aux loss, 0 for these families."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"the port's decoder_stack runs dense/vlm, not {cfg.family!r}")
    x = _run_layers(cfg, params["layers"], x, seg, pos, causal=True)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def encoder_stack(cfg: ModelConfig, params: Params, x, seg, pos):
    """Bidirectional encoder over ``params["enc_layers"]``; LayerNorm +
    GELU when ``cfg.family == "audio"`` (the modality encoders' path)."""
    return _run_layers(cfg, params["enc_layers"], x, seg, pos, causal=False)
