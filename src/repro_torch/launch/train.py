"""Training launcher (the core of ``repro.launch.train`` in PyTorch).

    PYTHONPATH=src torchrun --nproc_per_node 4 src/repro_torch/launch/train.py \\
        --arch mllm_10b --d 4 --steps 20

With ``RANK`` and ``WORLD_SIZE`` in the environment (as ``torchrun``
sets them) it runs one DP instance per rank and requires ``--d`` to
equal the world size.  Rank 0 draws and plans every step's global batch
with the port's orchestrator and sends each rank its shard; no rank
plans on its own.  Every rank runs the post-balanced step: encoder
tokens move between ranks by the communicator's ``--comm-mode``
collectives and the gradients are summed over the group, so the
replicas stay equal.  The backend is ``nccl`` at one rank per card, or
``gloo`` with ``--backend gloo`` (the CPU, or several ranks on one
card).  Without those variables it runs the d streams in one process
with the single-process exchange (the JAX launcher's ``--mesh none``).
Rank 0 prints one JSON line per step.

Not ported: checkpoints, the observability plane, pipeline stages,
fault injection and the prefetching loader (ROADMAP A.8-A.10, A.13).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.orchestrator import MLLMGlobalOrchestrator
from repro_torch.data.synthetic import Example
from repro_torch.launch.mesh import DPGroup, close_dp, init_dp
from repro_torch.sharding.specs import shard_batch
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (GROUP_COMM_MODES, batch_to_device,
                                             init_train_state, make_train_step)
from repro_torch.utils import resolve_device

__all__ = ["BatchPlanner", "main", "receive_shard", "sampler_for", "train"]

# Draws that overflow the capacities are drawn again, at most this often.
MAX_ATTEMPTS = 16


def sampler_for(cfg):
    """The JAX launcher's synthetic sampler (``_sampler_for``, copied)."""
    names = [e.name for e in cfg.encoders]

    def sampler(rng, per):
        out = []
        for _ in range(per):
            text = int(rng.integers(16, 128))
            vis = int(rng.integers(1, 4)) * 32 if "vision" in names else 0
            aud = int(rng.integers(16, 64)) if "audio" in names else 0
            if cfg.family == "audio":
                order = ("audio", "text")
            elif vis and aud:
                order = ("vision", "audio", "text")
            elif vis:
                order = ("vision", "text")
            elif aud:
                order = ("audio", "text")
            else:
                order = ("text",)
            out.append(Example("mix", text, vis, aud, order))
        return out

    return sampler


class BatchPlanner:
    """Rank 0's global batches: d instances of ``per`` examples drawn from
    batch ``index``'s own seed and planned by the orchestrator at
    capacities fixed from a probe draw (margin 3.0), as the JAX
    launcher's loader does; an overflowing draw is drawn again with the
    next attempt's seed."""

    def __init__(self, cfg, d: int, per: int, seed: int):
        self.d, self.per, self.seed = d, per, seed
        self.orch = MLLMGlobalOrchestrator(cfg, d, vocab=cfg.vocab_size)
        self.sampler = sampler_for(cfg)
        probe = [self.sampler(np.random.default_rng(s), per) for s in range(d)]
        self.caps = self.orch.default_capacities(probe, margin=3.0)

    def batch(self, index: int):
        """``(batch, report)`` of batch ``index``: numpy arrays ``[d, ...]``."""
        for attempt in range(MAX_ATTEMPTS):
            rng = np.random.default_rng((self.seed, index, attempt))
            examples = [self.sampler(rng, self.per) for _ in range(self.d)]
            try:
                return self.orch.plan_and_pack(
                    examples, self.caps, np.random.default_rng((self.seed, index, attempt)))
            except ValueError:
                continue
        raise RuntimeError(f"batch {index} overflowed its capacities {MAX_ATTEMPTS} times")


def receive_shard(dp: DPGroup, batch: dict | None) -> dict:
    """This rank's shard of the global batch that rank 0 holds
    (``batch`` on rank 0, None elsewhere), sent by ``scatter_object_list``."""
    shards = ([shard_batch(batch, r, dp.world) for r in range(dp.world)]
              if dp.rank == 0 else None)
    got = [None]
    dist.scatter_object_list(got, shards, src=0, group=dp.group)
    return got[0]


def train(cfg, *, d: int, per: int, steps: int, lr: float, seed: int, device,
          dp: DPGroup | None = None, comm_mode: str = "a2a", emit=print):
    """``steps`` post-balanced AdamW steps from random weights (seed 0);
    rank 0 (or the single process) emits one JSON line per step.
    Returns the parameters and optimizer state."""
    lead = dp is None or dp.rank == 0
    planner = BatchPlanner(cfg, d, per, seed) if lead else None
    params, opt_state = init_train_state(cfg, seed=0, device=device)
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr),
                              group=None if dp is None else dp.group, comm_mode=comm_mode)
    for it in range(steps):
        t0 = time.perf_counter()
        batch_np, report = planner.batch(it) if lead else (None, None)
        if dp is not None:
            batch_np = receive_shard(dp, batch_np)
        params, opt_state, m = step_fn(params, opt_state, batch_to_device(batch_np, device))
        if lead:
            row = {"step": it, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "tokens": int(m["tokens"]),
                   "llm_utilization": float(report.phase_utilization["llm"]),
                   "wall_ms": (time.perf_counter() - t0) * 1e3}
            emit(json.dumps(row))
    return params, opt_state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--d", type=int, default=4, help="DP instances")
    ap.add_argument("--per", type=int, default=4, help="examples/instance")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0, help="data stream seed")
    ap.add_argument("--comm-mode", choices=GROUP_COMM_MODES, default="a2a",
                    help="the exchange's collectives across ranks")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default: nccl on CUDA, gloo on "
                         "the CPU); gloo runs several ranks on one card")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, attention_backend="flash")
    if args.smoke:
        cfg = cfg.smoke()
    dp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if args.d != world:
            raise SystemExit(f"--d {args.d} must equal the world size {world}")
        dp = init_dp(int(os.environ["RANK"]), world, device=args.device,
                     backend=args.backend)
        device = dp.device
    elif args.backend is not None:
        raise SystemExit("--backend needs one process per rank (run under torchrun)")
    else:
        device = resolve_device(args.device)
    if dp is None or dp.rank == 0:
        print(json.dumps({"arch": cfg.name, "family": cfg.family, "d": args.d,
                          "device": str(device),
                          "dp": None if dp is None else dp.describe(),
                          "exchange": "gather" if dp is None else args.comm_mode}),
              flush=True)
    try:
        train(cfg, d=args.d, per=args.per, steps=args.steps, lr=args.lr, seed=args.seed,
              device=device, dp=dp, comm_mode=args.comm_mode,
              emit=lambda line: print(line, flush=True))
    finally:
        close_dp()


if __name__ == "__main__":
    main()
