"""Single-token decode for the dense/moe/vlm, ssm and hybrid families
(``repro.models.decode`` in PyTorch).

Cache layouts (see ``configs.registry.paged_cache_specs``):

* dense: k,v [L,B,S,Hkv,hd], kv_pos/kv_seg [B,S] shared across layers;
  the new token is written at ring index ``t % S``.
* hybrid: the Mamba-2 state conv [L,B,K-1,di], h [L,B,H,P,N], and per
  application g of the shared attention block sa_k/sa_v [G,B,S,Hkv,hd]
  with sa_kv_pos/sa_kv_seg [B,S] (the full history, no window).
* paged (the serving engine's path, ``block_tables`` given): k,v
  [L,NB,bs,Hkv,hd], kv_pos/kv_seg [NB,bs].  Each sequence's logical cache
  of S = W*bs slots is read through a block-table gather -- slot i lives
  at pool block ``table[i // bs]``, offset ``i % bs``.  ``t`` is a per-row
  [B] vector; a negative ``t[b]`` marks row b inactive: its cache writes
  are dropped and its logits are garbage the caller ignores.

Unlike the JAX package, which returns new cache arrays, the port writes
the new token's k/v/pos/seg (or ssm state) into the given cache tensors in
place (the pool is the largest tensor after the weights) and returns the
same dict.  One exception keeps the JAX package's numbers: its conv window
takes the dtype of the concatenation of window and new input, so an fp32
model's bf16 window (``cache_specs``) becomes fp32 on the first step; the
port then replaces the window by an fp32 copy.
The layer ``scan`` is a Python loop over ``params["layers"][key][l]``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention
from repro_torch.models.layers import apply_rope, layer_norm, rms_norm, rotary_embedding, swiglu
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba1_decode_step, mamba2_decode_step

__all__ = ["decode_step"]


def _norm(cfg, x, scale):
    if cfg.nonparametric_norm:
        return layer_norm(x, None, None)
    return rms_norm(x, scale)


def _proj_qkv(cfg, lp, x):
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ lp["wq"]).reshape(B, H, hd)
    k = (x @ lp["wk"]).reshape(B, Hkv, hd)
    v = (x @ lp["wv"]).reshape(B, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return q, k, v


def _attn_decode(cfg, lp, x, k_cache, v_cache, kv_pos, kv_seg, t, *, window,
                 paged=None):
    """x [B,D].  Returns out [B,D]; writes the new k/v into the caches.

    Dense mode (``paged=None``): k/v_cache [B,S,Hkv,hd], int ``t``.
    Paged mode: k/v_cache are pool blocks [NB,bs,Hkv,hd], ``paged =
    (block_tables [B,W], rows, write_blk, write_off)`` where ``rows``
    lists the active rows and write_blk/write_off their target slots;
    kv_pos/kv_seg arrive already gathered to [B, W*bs]."""
    B, D = x.shape
    q, k, v = _proj_qkv(cfg, lp, x)
    if paged is None:
        S = k_cache.shape[1]
        q_pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
        sin, cos = rotary_embedding(q_pos, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q[:, None], sin, cos)  # [B,1,H,hd]
        k = apply_rope(k[:, None], sin, cos)[:, 0]
        k_cache[:, t % S] = k.to(k_cache.dtype)
        v_cache[:, t % S] = v.to(v_cache.dtype)
        k_read, v_read = k_cache, v_cache
    else:
        bt, rows, wblk, woff = paged
        bs = k_cache.shape[1]
        S = bt.shape[1] * bs
        tc = t.clamp(min=0)
        sin, cos = rotary_embedding(tc[:, None], cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q[:, None], sin, cos)
        k = apply_rope(k[:, None], sin, cos)[:, 0]
        k_cache[wblk, woff] = k[rows].to(k_cache.dtype)
        v_cache[wblk, woff] = v[rows].to(v_cache.dtype)
        k_read = k_cache[bt].reshape((B, S) + k_cache.shape[2:])
        v_read = v_cache[bt].reshape((B, S) + v_cache.shape[2:])
        q_pos = tc[:, None].to(torch.int32)
    out = attention(
        q, k_read, v_read,
        q_seg=torch.ones((B, 1), dtype=torch.int32, device=x.device),
        kv_seg=kv_seg, q_pos=q_pos, kv_pos=kv_pos,
        causal=True, window=window, backend=cfg.decode_backend,
        block_q=cfg.block_q, block_kv=cfg.block_kv,
    )  # [B,1,H,hd]
    return out[:, 0].reshape(B, -1) @ lp["wo"]


def _layer(params, l):
    return {name: w[l] for name, w in params["layers"].items()}


def _dense_ffn(cfg, lp, h):
    """The dense-family FFN half of a decode layer ([B,D] -> [B,D]); the
    moe family routes every row (no validity mask: an inactive row's
    output is ignored)."""
    if cfg.family == "moe":
        ff, _ = moe_ffn(h[:, None, :], lp["router"], lp["w_gate"], lp["w_up"],
                        lp["w_down"], top_k=cfg.experts_per_token,
                        capacity_factor=cfg.capacity_factor, backend=cfg.moe_backend,
                        block_m=cfg.moe_block_m, block_n=cfg.moe_block_n)
        return ff[:, 0]
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _decode_layers(cfg, params, x, cache, kv_pos, kv_seg, t, paged):
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = _norm(cfg, x, lp.get("attn_norm"))
        x = x + _attn_decode(cfg, lp, h, cache["k"][l], cache["v"][l], kv_pos,
                             kv_seg, t, window=cfg.sliding_window, paged=paged)
        h = _norm(cfg, x, lp.get("mlp_norm"))
        x = x + _dense_ffn(cfg, lp, h)
    return x


def _update_pos_seg(cache, t, S):
    cache["kv_pos"][:, t % S] = t
    cache["kv_seg"][:, t % S] = 1
    return cache["kv_pos"], cache["kv_seg"]


def _decode_dense(cfg, params, x, cache, t):
    S = cache["k"].shape[2]
    kv_pos, kv_seg = _update_pos_seg(cache, t, S)
    return _decode_layers(cfg, params, x, cache, kv_pos, kv_seg, t, None)


def _decode_dense_paged(cfg, params, x, cache, t, block_tables):
    """Dense-family decode on the paged pool (module docstring).

    The JAX package scatters with ``mode="drop"`` and block index NB for
    inactive rows; here the active rows are selected explicitly (one
    ``nonzero`` per step) so no write ever sees an out-of-range index."""
    B = x.shape[0]
    bs = cache["kv_seg"].shape[1]
    S = block_tables.shape[1] * bs
    block_tables = block_tables.long()
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device).expand(B).contiguous()
    rows = torch.nonzero(t >= 0).squeeze(1)
    tc = t.clamp(min=0)
    idx = tc[rows] % S  # logical ring slot (= sliding-window ring)
    wblk = block_tables[rows, (idx // bs).long()].long()
    woff = (idx % bs).long()
    cache["kv_pos"][wblk, woff] = tc[rows]
    cache["kv_seg"][wblk, woff] = 1
    kv_pos = cache["kv_pos"][block_tables].reshape(B, S)
    kv_seg = cache["kv_seg"][block_tables].reshape(B, S)
    return _decode_layers(cfg, params, x, cache, kv_pos, kv_seg, t,
                          (block_tables, rows, wblk, woff))


def _ssm_layer_step(cfg, params, x, cache, l):
    """Layer l's O(1) state update (Mamba-1 for ssm, Mamba-2 for hybrid),
    written into ``cache["conv"][l]`` / ``cache["h"][l]``."""
    lp = _layer(params, l)
    conv = cache["conv"]
    state = {"conv": conv[l], "h": cache["h"][l]}
    if cfg.family == "hybrid":
        o, st = mamba2_decode_step(lp, rms_norm(x, lp["norm"]), state,
                                   ssm_state=cfg.ssm_state, headdim=cfg.ssm_headdim)
    else:
        o, st = mamba1_decode_step(lp, rms_norm(x, lp["norm"]), state,
                                   ssm_state=cfg.ssm_state)
    if st["conv"].dtype != conv.dtype:
        cache["conv"] = conv = conv.to(st["conv"].dtype)
    conv[l] = st["conv"]
    cache["h"][l] = st["h"]
    return x + o


def _decode_ssm(cfg, params, x, cache):
    for l in range(cfg.n_layers):
        x = _ssm_layer_step(cfg, params, x, cache, l)
    return x


def _decode_hybrid(cfg, params, x, cache, t):
    """Groups of ``shared_attn_every`` Mamba-2 decode steps, each group
    followed by the shared attention block on its own KV cache
    ``sa_k[g]``/``sa_v[g]`` and the shared MLP.  The positions and
    segments are written once per step."""
    every = cfg.shared_attn_every
    S = cache["sa_k"].shape[2]
    pos_seg = {"kv_pos": cache["sa_kv_pos"], "kv_seg": cache["sa_kv_seg"]}
    kv_pos, kv_seg = _update_pos_seg(pos_seg, t, S)
    shared = params["shared_attn"]
    for g in range(cfg.n_layers // every):
        for l in range(g * every, (g + 1) * every):
            x = _ssm_layer_step(cfg, params, x, cache, l)
        h = rms_norm(x, shared["attn_norm"])
        x = x + _attn_decode(cfg, shared, h, cache["sa_k"][g], cache["sa_v"][g], kv_pos,
                             kv_seg, t, window=None)
        h = rms_norm(x, shared["mlp_norm"])
        x = x + swiglu(h, shared["w_gate"], shared["w_up"], shared["w_down"])
    return x


def _final(cfg, params, x):
    if cfg.nonparametric_norm:
        return layer_norm(x, None, None)
    return rms_norm(x, params["final_norm"])


def decode_step(cfg: ModelConfig, params, tokens, cache, t, *, block_tables=None):
    """tokens [B,1] int; t int (current position), or with
    ``block_tables`` [B,W] (paged mode) an int or per-row [B] tensor with
    negative entries marking inactive rows.  Runs on the device of
    ``params``; the cache is updated in place.

    Returns (logits [B, vocab] fp32, cache)."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(
            f"the port decodes dense/moe/vlm/ssm/hybrid families, not {cfg.family!r}")
    x = params["embed"][tokens[:, 0]]  # [B,D]
    if block_tables is not None:
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"paged decode supports dense/moe/vlm families, not {cfg.family!r}")
        x = _decode_dense_paged(cfg, params, x, cache, t, block_tables)
    elif cfg.family == "ssm":
        x = _decode_ssm(cfg, params, x, cache)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(cfg, params, x, cache, t)
    else:
        x = _decode_dense(cfg, params, x, cache, t)
    x = _final(cfg, params, x)
    lm_head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ lm_head.float()
    return logits, cache
