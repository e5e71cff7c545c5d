"""Train step factories (``repro.training.train_step`` in PyTorch).

``make_train_step(cfg, ...)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: the forward pass over a post-balanced
batch (encoders -> exchange -> scatter -> decoder -> chunked
cross-entropy), its gradients by autograd, and AdamW.  The exchange that
moves encoder tokens to their destination streams is the single-device
gather path of the JAX package's ``make_exchange`` (the orchestrator's
``global_gather`` plan); the collective modes across cards are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, with_attention_backend
from repro_torch.models.model import forward, init_params
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
)
from repro_torch.utils import resolve_device

__all__ = [
    "METRIC_HELP",
    "OPT_STATE_KEYS",
    "batch_to_device",
    "check_opt_state",
    "init_train_state",
    "make_exchange",
    "make_loss_fn",
    "make_train_step",
]

METRIC_HELP = {
    "loss": "mean next-token cross-entropy over supervised positions",
    "aux_loss": "MoE load-balance auxiliary loss (0 for dense families)",
    "tokens": "supervised positions in the step's global batch",
    "moe_dropped_frac": "routed tokens dropped at expert capacity "
                        "(0 on the drop-free grouped backend)",
    "moe_max_expert_load": "largest per-expert load fraction "
                           "(1/n_experts = perfectly balanced routing)",
    "grad_norm": "global gradient L2 norm",
}

# The optimizer-state contract of ``make_train_step`` / ``adamw_update``.
OPT_STATE_KEYS = ("mu", "nu", "step")


def _leaf_shapes(tree, prefix="") -> dict:
    """{"a/b": shape} for every leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        out.update(_leaf_shapes(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: tuple(v.shape)})
    return out


def check_opt_state(params, opt_state) -> None:
    """Validate an optimizer state against the train-step contract:
    ``{"mu", "nu", "step"}`` with both moment trees congruent with
    ``params`` (same keys, same leaf shapes) and a scalar step.  Raises
    ``ValueError`` with the first violation."""
    if not isinstance(opt_state, dict) or set(opt_state) != set(OPT_STATE_KEYS):
        got = sorted(opt_state) if isinstance(opt_state, dict) else type(opt_state)
        raise ValueError(f"opt_state must have keys {OPT_STATE_KEYS}, got {got}")
    want = _leaf_shapes(params)
    for moment in ("mu", "nu"):
        got = opt_state[moment]
        got = _leaf_shapes(got) if isinstance(got, dict) else None
        if got is None or got.keys() != want.keys():
            raise ValueError(
                f"opt_state[{moment!r}] tree structure does not match params")
        for name, shape in want.items():
            if got[name] != shape:
                raise ValueError(f"opt_state[{moment!r}] leaf shape {got[name]} != "
                                 f"params leaf shape {shape}")
    step = torch.as_tensor(opt_state["step"])
    if step.dim() != 0:
        raise ValueError(f"opt_state['step'] must be a scalar, got {tuple(step.shape)}")


def batch_to_device(batch: dict, device) -> dict:
    """The orchestrator's numpy batch as tensors on ``device`` (dtypes
    kept: int32 indices, fp32 embeddings, bool masks)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_exchange(batch: dict):
    """The exchange closure over one batch: reads the encoder's plan
    arrays out of the batch and moves its tokens [S, cap_out_src, D] to
    their destination streams [S, cap_out, D] by a global take of
    ``global_gather``, zero where ``post_mask`` is false."""

    def exchange(name: str, enc_tok: torch.Tensor) -> torch.Tensor:
        S, T, D = enc_tok.shape
        idx = batch[f"enc_{name}_plan_global_gather"]
        mask = batch[f"enc_{name}_plan_post_mask"]
        moved = enc_tok.reshape(S * T, D).index_select(0, idx.reshape(-1).long())
        out = torch.where(mask.reshape(-1, 1), moved, torch.zeros_like(moved))
        return out.reshape(S, mask.shape[-1], D)

    return exchange


def make_loss_fn(cfg: ModelConfig, *, attention_backend: str | None = None):
    """``loss_fn(params, batch) -> (loss, metrics)`` with
    ``loss = sum / n + 0.01 * aux``; ``attention_backend`` overrides the
    config's backend at every attention site."""
    cfg = with_attention_backend(cfg, attention_backend)

    def loss_fn(params, batch):
        ex = make_exchange(batch) if cfg.encoders else None
        loss_sum, n, aux = forward(cfg, params, batch, exchange=ex)
        n = torch.clamp(n, min=1)
        loss = loss_sum / n + 0.01 * aux
        return loss, {"loss": loss_sum / n, "aux_loss": aux, "tokens": n}

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None, *,
                    attention_backend: str | None = None):
    """``train_step(params, opt_state, batch, *, lr=None)``: loss, autograd
    gradients of every parameter leaf, AdamW (in place).  Metrics are
    0-d tensors; nothing is read back to the host."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(cfg, attention_backend=attention_backend)

    def train_step(params, opt_state, batch, *, lr=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        it = iter(grads)
        grad_tree = _like(params, it)
        params, opt_state, om = adamw_update(params, grad_tree, opt_state, opt_cfg,
                                             lr=lr)
        return params, opt_state, {**{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


def _like(tree, it):
    return {k: _like(v, it) if isinstance(v, dict) else next(it) for k, v in tree.items()}


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Random parameters from ``seed`` (see ``init_params``) and a fresh
    AdamW state."""
    params = init_params(cfg, seed, device=device)
    return params, adamw_init(params)
