"""Rank processes of ``tests/test_torch_dp.py`` (torch and numpy only).

Each rank joins a gloo group on the CPU through a file rendezvous, runs
every case of the file and returns its results to the test process,
which compares them with numpy oracles, the JAX package and the port's
single-process step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.balancing import post_balance
from repro_torch.core.communicator import apply_comm_plan, build_comm_plan, plan_to_device
from repro_torch.core.cost_model import CostModel
from repro_torch.core.nodewise import nodewise_rearrange
from repro_torch.launch.mesh import close_dp, init_dp
from repro_torch.launch.train import receive_shard
from repro_torch.sharding.specs import shard_batch
from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.training.train_step import (allreduce_grads, batch_to_device,
                                             make_loss_fn, make_train_step)

EXCHANGE_MODES = ("a2a", "ragged", "allgather")
# (seed, node-wise) per world size; the node-wise plan groups 2 ranks a node.
EXCHANGE_CASES = {2: ((0, False), (1, False)), 4: ((0, False), (1, False), (2, True))}
FEAT = (4,)
LR = 1e-3


@dataclasses.dataclass
class ExchangeCase:
    pi: object
    plan: object
    cap_in: int
    cap_out: int
    x: np.ndarray  # [d * cap_in, *FEAT]: every rank's packed source tokens
    w: np.ndarray  # [d * cap_out, *FEAT]: the cotangent of the result


def exchange_case(d: int, seed: int, nodewise: bool) -> ExchangeCase:
    """A post-balanced plan of random lengths (as the JAX package's
    ``communicator_check.py`` draws them), payloads and a cotangent."""
    rng = np.random.default_rng(seed)
    lens = [rng.integers(1, 40, size=rng.integers(1, 6)) for _ in range(d)]
    pi = post_balance(lens, d, CostModel())
    if nodewise:
        pi = nodewise_rearrange(pi, 2)
    cap_in = int(max(l.sum() for l in lens))
    cap_out = int(max(l.sum() for l in pi.dest_lengths()) or 1)
    x = rng.normal(size=(d * cap_in,) + FEAT).astype(np.float32)
    w = rng.normal(size=(d * cap_out,) + FEAT).astype(np.float32)
    return ExchangeCase(pi, build_comm_plan(pi, cap_in, cap_out), cap_in, cap_out, x, w)


def _exchange(rank, world, group):
    out = {}
    for seed, nodewise in EXCHANGE_CASES[world]:
        case = exchange_case(world, seed, nodewise)
        whole = plan_to_device(case.plan, "cpu")
        rows = shard_batch(whole, rank, world)  # the [1, ...] rows a batch carries
        for mode in EXCHANGE_MODES:
            for arrays, tag in ((whole, "whole"), (rows, "rows")):
                x = torch.from_numpy(
                    case.x[rank * case.cap_in:(rank + 1) * case.cap_in]).requires_grad_(True)
                y = apply_comm_plan(x, arrays, group, mode=mode)
                w = torch.from_numpy(case.w[rank * case.cap_out:(rank + 1) * case.cap_out])
                (g,) = torch.autograd.grad(y, x, grad_outputs=w)
                out[(seed, nodewise, mode, tag)] = (y.detach().numpy(), g.numpy())
    return out


def _grads(cfg, params, batch, group, mode):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = make_loss_fn(cfg, group=group, comm_mode=mode)(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    grads = allreduce_grads(grads, group, bucket_numel=4096)  # many buckets, split leaves
    return (float(metrics["loss"]), int(metrics["tokens"]),
            [g.detach().numpy().copy() for g in grads])


def _model(rank, dp, model):
    cfg, moe_cfg, params_np, batches = model
    out = {}
    shard = batch_to_device(shard_batch(batches[0], rank, dp.world), "cpu")
    for mode in ("a2a", "allgather"):
        out[mode] = _grads(cfg, params_from_numpy(params_np, device="cpu"), shard,
                           dp.group, mode)
    try:
        make_loss_fn(moe_cfg, group=dp.group)
        out["moe_error"] = None
    except NotImplementedError as e:
        out["moe_error"] = str(e)
    params = params_from_numpy(params_np, device="cpu")
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=LR), group=dp.group)
    losses = []
    for batch in batches:
        got = receive_shard(dp, batch if rank == 0 else None)
        params, opt_state, m = step_fn(params, opt_state, batch_to_device(got, "cpu"))
        losses.append(float(m["loss"]))
    out["step_losses"] = losses
    out["params_after"] = params_to_numpy(params)
    return out


def rank_main(rank, world, rendezvous, model=None):
    """One rank: the exchange cases, and with ``model`` = (cfg, moe cfg,
    numpy params, numpy batches) the DP loss, gradients and AdamW steps."""
    torch.set_num_threads(1)
    dp = init_dp(rank, world, device="cpu", backend="gloo",
                 init_method=f"file://{rendezvous}", timeout_s=60)
    try:
        out = {"exchange": _exchange(rank, world, dp.group)}
        if model is not None:
            out.update(_model(rank, dp, model))
        return out
    finally:
        close_dp()


def sleeper(rank, seconds):
    import time

    time.sleep(seconds)


def failer(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank
