"""Train step factories (``repro.training.train_step`` in PyTorch).

``make_train_step(cfg, ...)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: the forward pass over a post-balanced
batch (encoders -> exchange -> scatter -> decoder -> chunked
cross-entropy), its gradients by autograd, and AdamW.

With no group, one process runs all d streams of the batch and the
exchange that moves encoder tokens to their destination streams is the
global take of the orchestrator's ``global_gather`` plan (the JAX
package's ``mesh=None``).  Under a DP ``group`` each process holds one
stream (its ``shard_batch``), the exchange runs the communicator's
collectives, the supervised-token count is summed over the group before
the backward, and the gradients are summed in flat buckets, so every
rank's replica takes the same update.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, with_attention_backend
from repro_torch.core.communicator import apply_comm_plan
from repro_torch.models.model import forward, init_params
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
)
from repro_torch.utils import resolve_device

__all__ = [
    "EXCHANGE_KEYS",
    "GROUP_COMM_MODES",
    "METRIC_HELP",
    "OPT_STATE_KEYS",
    "allreduce_grads",
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


# The plan arrays the orchestrator's batch carries per encoder.
EXCHANGE_KEYS = ("pre_gather_dense", "post_gather_dense", "post_mask", "global_gather")
# Modes the training step runs under a group (the batch carries no split
# sizes for "ragged").
GROUP_COMM_MODES = ("a2a", "allgather")
# Elements of one gradient all-reduce.
GRAD_BUCKET_NUMEL = 1 << 25


def make_exchange(batch: dict, group=None, mode: str = "a2a"):
    """The exchange closure over one batch: reads the encoder's plan
    arrays out of the batch and moves its tokens [S, cap_out_src, D] to
    their destination streams [S, cap_out, D], zero where ``post_mask``
    is false.  With no group, the global take over all S streams; under
    a group (S = 1 per rank), the communicator's ``mode``."""
    if group is not None and mode not in GROUP_COMM_MODES:
        raise ValueError(f"the training step exchanges in modes {GROUP_COMM_MODES} "
                         f"under a group, not {mode!r}")

    def exchange(name: str, enc_tok: torch.Tensor) -> torch.Tensor:
        S, T, D = enc_tok.shape
        plan = {k: batch[f"enc_{name}_plan_{k}"] for k in EXCHANGE_KEYS}
        out = apply_comm_plan(enc_tok.reshape(S * T, D), plan, group,
                              mode="gather" if group is None else mode)
        return out.reshape(S, plan["post_mask"].shape[-1], D)

    return exchange


def make_loss_fn(cfg: ModelConfig, *, group=None, comm_mode: str = "a2a",
                 attention_backend: str | None = None):
    """``loss_fn(params, batch) -> (loss, metrics)`` with
    ``loss = sum / n + 0.01 * aux`` (the moe family's ``lb_loss``, its
    other routing metrics reported as ``moe_*``); ``attention_backend``
    overrides the config's backend at every attention site.

    Under a DP ``group`` the batch is this rank's shard, ``n`` the
    group's supervised positions (so the ranks' losses sum to the global
    batch's), and the metrics are the global batch's."""
    cfg = with_attention_backend(cfg, attention_backend)
    if group is not None and cfg.family == "moe":
        raise NotImplementedError(
            "the moe family's load-balance loss is a function of the global "
            "batch's router statistics, which are not reduced across DP ranks yet "
            "(ROADMAP A.13)")

    def loss_fn(params, batch):
        ex = make_exchange(batch, group, comm_mode) if cfg.encoders else None
        loss_sum, n, aux = forward(cfg, params, batch, exchange=ex)
        total = loss_sum.detach()
        if group is not None:
            # the global sum (for the metric) and count in one all-reduce
            both = torch.stack([total.double(), n.double()])
            dist.all_reduce(both, group=group)
            total, n = both[0].float(), both[1].to(n.dtype)
        n = torch.clamp(n, min=1)
        # the moe family returns a dict of routing metrics: only the
        # load-balance loss enters the objective, the rest are metrics
        aux_loss = aux["lb_loss"] if isinstance(aux, dict) else aux
        loss = loss_sum / n + 0.01 * aux_loss
        metrics = {"loss": total / n, "aux_loss": aux_loss, "tokens": n}
        if isinstance(aux, dict):
            metrics["moe_dropped_frac"] = aux["dropped_frac"]
            metrics["moe_max_expert_load"] = aux["expert_load"].max()
        return loss, metrics

    return loss_fn


@torch.no_grad()
def allreduce_grads(grads, group, *, bucket_numel: int = GRAD_BUCKET_NUMEL) -> list:
    """Sum gradients over the group, packed by dtype into flat buckets of
    ``bucket_numel`` elements (one collective per bucket, a leaf split
    across buckets where it does not fit).  Returns the summed
    gradients, contiguous, in order."""
    grads = [g.contiguous() for g in grads]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        bucket = gs[0].new_empty(min(bucket_numel, sum(g.numel() for g in gs)))
        pieces, fill = [], 0
        for flat in (g.view(-1) for g in gs):
            lo = 0
            while lo < flat.numel():
                n = min(flat.numel() - lo, bucket.numel() - fill)
                bucket[fill:fill + n].copy_(flat[lo:lo + n])
                pieces.append((flat[lo:lo + n], fill))
                fill += n
                lo += n
                if fill == bucket.numel():
                    _reduce_bucket(bucket, fill, pieces, group)
                    pieces, fill = [], 0
        if fill:
            _reduce_bucket(bucket, fill, pieces, group)
    return grads


def _reduce_bucket(bucket, fill, pieces, group):
    dist.all_reduce(bucket[:fill], group=group)
    for dst, at in pieces:
        dst.copy_(bucket[at:at + dst.numel()])


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None, *,
                    group=None, comm_mode: str = "a2a",
                    attention_backend: str | None = None):
    """``train_step(params, opt_state, batch, *, lr=None)``: loss, autograd
    gradients of every parameter leaf, AdamW (in place).  Metrics are
    0-d tensors; nothing is read back to the host.  Under a DP ``group``
    the gradients are summed over the ranks before the update."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(cfg, group=group, comm_mode=comm_mode,
                           attention_backend=attention_backend)

    def train_step(params, opt_state, batch, *, lr=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if group is not None:
            grads = allreduce_grads(grads, group)
        grad_tree = _like(params, iter(grads))
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
