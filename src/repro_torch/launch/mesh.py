"""The data-parallel group (``repro.launch.mesh`` on ``torch.distributed``).

One process per DP instance: the JAX package's ``("data",)`` mesh axis
becomes the default process group, rank ``r`` holding DP shard ``r``.
The backend is chosen explicitly: ``nccl`` for CUDA at one rank per card,
``gloo`` on the CPU or where the caller asks for several ranks on one
card.  Nothing switches backend on its own: NCCL with more ranks than
cards raises.

``spawn_ranks`` starts ranks as ``spawn`` processes and bounds them by a
join timeout, killing every rank when one fails or the time runs out.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import pickle
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.utils import resolve_device

__all__ = ["DPGroup", "choose_backend", "close_dp", "dp_shards_of", "init_dp",
           "spawn_ranks"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DPGroup:
    """One rank's view of the DP group."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: dist.ProcessGroup

    def describe(self) -> dict:
        return {"backend": self.backend, "world": self.world, "rank": self.rank,
                "device": str(self.device)}


def choose_backend(device, world: int, backend: str | None = None) -> str:
    """``backend`` if given, else ``nccl`` on CUDA and ``gloo`` on the CPU;
    NCCL needs CUDA and one card per rank."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; use gloo on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"nccl runs one rank per card: {world} ranks, {cards} card(s); "
                "pass backend 'gloo' to run several ranks on one card")
    return backend


def init_dp(rank: int, world: int, *, device, backend: str | None = None,
            init_method: str = "env://", timeout_s: float = 600.0) -> DPGroup:
    """Join the DP group as ``rank`` of ``world``.  On CUDA a rank takes
    card ``rank % device_count`` (every rank the one card when there is
    one card and the backend is gloo)."""
    device = resolve_device(device)
    backend = choose_backend(device, world, backend)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DPGroup(rank, world, backend, device, dist.group.WORLD)


def close_dp() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def dp_shards_of(dp: DPGroup | None) -> int:
    """DP shards of the group (1 with none: a single process)."""
    return 1 if dp is None else dp.world


def _rank_main(payload, rank, results):
    # Arguments and results travel as plain pickles: torch's own reduction
    # would share tensors through file descriptors that die with the rank.
    try:
        fn, args = pickle.loads(payload)
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world: int, args: tuple = (), *, timeout_s: float) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes and return
    their results by rank.  A rank that raises or dies, or a run longer
    than ``timeout_s``, kills every rank and raises.  ``fn`` and
    ``args`` must pickle: ``fn`` a module-level function."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    payload = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, args=(payload, r, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} "
                                   f"did not finish within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]
