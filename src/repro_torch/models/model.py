"""Model assembly for the dense/moe/vlm families (``repro.models.model``
in PyTorch): parameter init with the modality encoders, the training
forward over post-balanced batches, and the chunked cross-entropy.

Parameters are a dict of tensors with the JAX package's keys and stacked
``[L, ...]`` layer shapes.  They are made directly on the target device
in the config's dtype, one layer slice at a time, from a
``torch.Generator`` seeded by ``seed``; the full-width backbone never
passes through the CPU.  The numbers differ from ``jax.random``'s for
the same seed: parity tests load the JAX package's weights through
:mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import EncoderConfig, ModelConfig
from repro_torch.models.layers import layer_norm, rms_norm
from repro_torch.models.transformer import decoder_stack, encoder_stack
from repro_torch.utils import resolve_device

__all__ = ["chunked_xent", "forward", "init_params", "run_encoder", "torch_dtype"]

Params = dict


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense(shape, dt, device, gen, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, drawn in fp32 one leading
    slice at a time (bounds the fp32 scratch to one layer)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(shape, dtype=dt, device=device)
    for part in (out if len(shape) >= 3 else [out]):
        w = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        part.copy_(w.mul_(std))
    return out


def _init_encoder(e: EncoderConfig, d_llm: int, dense, ones) -> Params:
    """Modality encoder transformer (paper submodule) + MLP connector."""
    L, D, F_ = e.n_layers, e.d_model, e.d_ff
    p: Params = {"input_proj": dense((e.embed_dim, D)),
                 "conn_in": dense((D * e.downsample, d_llm)),
                 "conn_out": dense((d_llm, d_llm))}
    if L > 0:
        p["layers"] = {"attn_norm": ones((L, D)), "mlp_norm": ones((L, D)),
                       "wq": dense((L, D, D)), "wk": dense((L, D, D)),
                       "wv": dense((L, D, D)), "wo": dense((L, D, D)),
                       # ViT/whisper-style GELU MLP (the "audio" forward path)
                       "w_in": dense((L, D, F_)), "w_out": dense((L, F_, D))}
        p["final_norm"] = ones((D,))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Parameters of a dense/moe/vlm config: the backbone and, under
    ``encoder_<name>``, each modality encoder with its connector.  An moe
    layer stack holds the router ``[L, D, E]`` in fp32 whatever the
    model's dtype, and experts ``[L, E, D, F]`` / ``[L, E, F, D]``."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the port builds dense/moe/vlm backbones, not {cfg.family!r}")
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
    if cfg.family == "moe":
        E = cfg.n_experts
        layers.update(router=_dense((L, D, E), torch.float32, device, gen),
                      w_gate=dense((L, E, D, F)), w_up=dense((L, E, D, F)),
                      w_down=dense((L, E, F, D)))
    else:
        layers.update(w_gate=dense((L, D, F)), w_up=dense((L, D, F)),
                      w_down=dense((L, F, D)))
    params["layers"] = layers
    if not cfg.nonparametric_norm:
        params["final_norm"] = ones((D,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V))
    for e in cfg.encoders:
        params[f"encoder_{e.name}"] = _init_encoder(e, D, dense, ones)
    return params


# ----------------------------------------------------------------------
# Loss (chunked: never materialises [T, V] for the whole stream).
# ----------------------------------------------------------------------
def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32.  fp32 operands multiply in fp32 (TF32 only if
    the process allows it).  Otherwise the JAX package upcasts bf16 to
    fp32 first; every product of two bf16 values is exact in fp32, so on
    the card the operands are cast to bf16 (exact for bf16 values; an fp32
    operand -- the backward's logit gradient -- rounds to bf16) and
    multiplied by a bf16 GEMM with fp32 accumulation and output.  On the
    CPU both are upcast instead."""
    if a.dtype == b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        low = b.dtype if a.dtype == torch.float32 else a.dtype
        return torch.mm(a.to(low), b.to(low), out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(xs, lm_head, ls):
    """fp32 logits of one chunk and its per-position loss (0 where the
    label is -1)."""
    logits = _f32_product(xs, lm_head)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, ls.clamp(min=0)[:, None].long())[:, 0]
    return logits, logz, torch.where(ls >= 0, logz - gold, torch.zeros_like(logz))


class _ChunkedXent(torch.autograd.Function):
    """Sum of next-token cross-entropy over chunks of the stream.  The
    backward recomputes each chunk's logits (the JAX package's
    ``jax.checkpoint`` on the chunk body) and sums the lm_head gradient
    over the chunks in fp32, as JAX's cotangent of the upcast head does."""

    @staticmethod
    def forward(ctx, x, lm_head, labels, chunk):
        B, T, D = x.shape
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, T, chunk):
            xs = x[:, c0:c0 + chunk].reshape(-1, D)
            _, _, loss = _chunk_logits(xs, lm_head, labels[:, c0:c0 + chunk].reshape(-1))
            total = total + loss.view(B, -1).sum()
        ctx.save_for_backward(x, lm_head, labels)
        ctx.chunk = chunk
        return total

    @staticmethod
    def backward(ctx, g):
        x, lm_head, labels = ctx.saved_tensors
        B, T, D = x.shape
        dx = torch.empty_like(x)
        dw = torch.zeros(lm_head.shape, dtype=torch.float32, device=x.device)
        for c0 in range(0, T, ctx.chunk):
            xs = x[:, c0:c0 + ctx.chunk].reshape(-1, D)
            ls = labels[:, c0:c0 + ctx.chunk].reshape(-1)
            logits, logz, _ = _chunk_logits(xs, lm_head, ls)
            # d loss / d logits = (softmax - onehot(label)) on labelled rows
            dlogits = logits.sub_(logz[:, None]).exp_()
            rows = torch.arange(ls.numel(), device=x.device)
            dlogits[rows, ls.clamp(min=0).long()] -= 1.0
            dlogits.mul_(torch.where(ls >= 0, g, torch.zeros_like(g))[:, None])
            dx[:, c0:c0 + ctx.chunk] = _f32_product(dlogits, lm_head.T).view(
                B, -1, D).to(x.dtype)
            dw += _f32_product(xs.T, dlogits)
        return dx, dw.to(lm_head.dtype), None, None


def chunked_xent(x, lm_head, labels, *, chunk: int = 2048):
    """x [B,T,D], lm_head [D,V], labels [B,T] (-1 = ignore) ->
    (sum_loss fp32, n_valid int32).  Logits are fp32 and live one chunk
    of ``chunk`` positions per stream at a time."""
    n = (labels >= 0).sum(dtype=torch.int32)
    return _ChunkedXent.apply(x, lm_head, labels, chunk), n


# ----------------------------------------------------------------------
# Forward (training).
# ----------------------------------------------------------------------
def _encoder_model_cfg(e: EncoderConfig, base: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        base,
        family="audio",  # LayerNorm + GELU path
        n_layers=e.n_layers,
        scan_unroll=e.scan_unroll,
        d_model=e.d_model,
        n_heads=e.n_heads,
        n_kv_heads=e.n_heads,
        head_dim=None,
        d_ff=e.d_ff,
        qk_norm=False,
        sliding_window=None,
        nonparametric_norm=False,
    )


def run_encoder(cfg_e: EncoderConfig, p: Params, embeds, seg, pos, *,
                base_cfg: ModelConfig):
    """Stub-frontend embeddings -> connector tokens in LLM space.
    Returns [S, cap_E // downsample, d_llm]."""
    x = embeds.to(torch_dtype(base_cfg)) @ p["input_proj"]
    if cfg_e.n_layers > 0:
        enc_cfg = _encoder_model_cfg(cfg_e, base_cfg)
        x = encoder_stack(enc_cfg, {"enc_layers": p["layers"]}, x, seg, pos)
        x = rms_norm(x, p["final_norm"])
    ds = cfg_e.downsample
    S, T, D = x.shape
    x = x.reshape(S, T // ds, D * ds) @ p["conn_in"]
    return F.gelu(x, approximate="tanh") @ p["conn_out"]


def _final_norm(cfg: ModelConfig, params: Params, x):
    if cfg.nonparametric_norm:
        return layer_norm(x, None, None)
    if cfg.family == "audio":
        return layer_norm(x, params["final_norm"], None)
    return rms_norm(x, params["final_norm"])


def _scatter_tokens(x, dst, values):
    """x [S, cap_L, D]; dst [S, T] slots; values [S, T, D].  Slots outside
    [0, cap_L) -- the orchestrator's cap_L means "drop" -- are routed to a
    sink row past the end that is cut off (the JAX package's
    ``mode="drop"``)."""
    S, cap_L, D = x.shape
    keep = (dst >= 0) & (dst < cap_L)
    idx = torch.where(keep, dst, cap_L).long()
    rows = torch.arange(S, device=x.device)[:, None].expand_as(idx)
    padded = torch.cat([x, x.new_zeros((S, 1, D))], dim=1)
    padded = padded.index_put((rows, idx), values.to(x.dtype))
    return padded[:, :cap_L]


def forward(cfg: ModelConfig, params: Params, batch: dict, *,
            exchange: Callable | None = None):
    """Returns (sum_loss, n_tokens, aux) for a post-balanced batch of
    tensors (the orchestrator's keys): aux is the scalar aux loss, or for
    the moe family ``decoder_stack``'s dict of routing metrics.
    ``exchange(name, tokens)`` moves encoder-output tokens to their
    destination streams."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the port's forward runs dense/moe/vlm, not {cfg.family!r}")
    tokens = batch["tokens"].long()
    if cfg.encoders:
        S = tokens.shape[0]
        cap_L = batch["llm_seg"].shape[1]
        x = torch.zeros((S, cap_L, cfg.d_model), dtype=torch_dtype(cfg),
                        device=tokens.device)
        x = _scatter_tokens(x, batch["text_dst"], F.embedding(tokens, params["embed"]))
        for e in cfg.encoders:
            enc_tok = run_encoder(e, params[f"encoder_{e.name}"],
                                  batch[f"enc_{e.name}_embeds"],
                                  batch[f"enc_{e.name}_seg"], batch[f"enc_{e.name}_pos"],
                                  base_cfg=cfg)
            if exchange is not None:
                enc_tok = exchange(e.name, enc_tok)
            x = _scatter_tokens(x, batch[f"enc_{e.name}_dst"], enc_tok)
        seg, pos, labels = batch["llm_seg"], batch["llm_pos"], batch["llm_labels"]
    else:
        x = F.embedding(tokens, params["embed"])
        seg, pos, labels = batch["seg"], batch["pos"], batch["labels"]
    x, aux = decoder_stack(cfg, params, x, seg, pos)
    x = _final_norm(cfg, params, x)
    lm_head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    loss_sum, n = chunked_xent(x, lm_head, labels)
    return loss_sum, n, aux
