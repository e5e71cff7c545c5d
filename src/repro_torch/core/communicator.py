"""Node-wise All-to-All Communicator (paper S5.2.1).

A copy of ``repro.core.communicator``.  The host half, :class:`CommPlan`
and :func:`build_comm_plan`, compiles a rearrangement into static-shape
transport arrays.  The device half, :func:`apply_comm_plan`, moves one
rank's packed tokens to their destination ranks over a
``torch.distributed`` group, one process per DP instance:

  * ``a2a``       the paper's All-to-All Batch Communicator as a dense
                  ``all_to_all_single`` over per-peer chunks padded to the
                  plan's ``chunk_cap`` (per-rank traffic O(max_i L_i),
                  paper Eq. 4).
  * ``ragged``    the paper-exact ragged all-to-all: ``all_to_all_single``
                  with the plan's per-peer split sizes, read on the host.
  * ``allgather`` the strawman: every rank gathers every mini-batch and
                  takes its own (traffic O((d-1) max_i L_i), Eq. 3).
  * ``gather``    no group: the single-process global take over all d
                  streams at once (the JAX package's ``mesh=None`` path).

Gradients flow back through every mode: the backward of an all-to-all is
the all-to-all with its splits swapped, that of the all-gather a
reduce-scatter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.rearrangement import Rearrangement
from repro_torch.utils import resolve_device
from repro_torch.utils import round_up as _round_up

__all__ = ["COMM_MODES", "CommPlan", "apply_comm_plan", "build_comm_plan",
           "plan_to_device"]


@dataclasses.dataclass
class CommPlan:
    """Host-built static-shape plan for one payload exchange.

    All integer arrays are int32.  Shapes:
      pre_gather   [d, cap_in]   send-buffer build: dest-major token order
      input_offsets, send_sizes, output_offsets, recv_sizes  [d, d]
      post_gather  [d, cap_out]  recv-buffer -> final packed layout
      post_mask    [d, cap_out]  True on valid (non-pad) token positions
    """

    d: int
    cap_in: int
    cap_out: int
    pre_gather: np.ndarray
    input_offsets: np.ndarray
    send_sizes: np.ndarray
    output_offsets: np.ndarray
    recv_sizes: np.ndarray
    post_gather: np.ndarray
    post_mask: np.ndarray
    # Global-gather fallback: final token p of shard i comes from global
    # flat index global_gather[i, p] of the [d*cap_in] source array.
    global_gather: np.ndarray
    # Dense all_to_all emulation (CPU/TPU-portable): static per-peer chunk.
    chunk_cap: int
    pre_gather_dense: np.ndarray  # [d, d*chunk_cap]
    post_gather_dense: np.ndarray  # [d, cap_out]
    # Host-only metadata: destination packed-layout offsets per example
    # (flat, aligned with the source Rearrangement's entries).
    dst_starts: np.ndarray | None = None

    def comm_bytes(self, bytes_per_token: int) -> dict[str, int]:
        """Analytic traffic accounting (paper Eq. 3 vs 4)."""
        off_diag = self.send_sizes.copy()
        np.fill_diagonal(off_diag, 0)
        ragged = int(off_diag.sum()) * bytes_per_token
        dense = int(self.d * (self.d - 1) * self.chunk_cap) * bytes_per_token
        ag = int(self.d * (self.d - 1) * self.cap_in) * bytes_per_token
        return {"ragged": ragged, "a2a_dense": dense, "allgather": ag}


def _layout(insts: np.ndarray, slots: np.ndarray, lengths: np.ndarray, d: int):
    """Token start offset of each example in its shard's packed buffer,
    ordering examples by slot; returns (starts[n], totals[d])."""
    starts = np.zeros(len(insts), dtype=np.int64)
    totals = np.zeros(d, dtype=np.int64)
    for i in range(d):
        sel = np.where(insts == i)[0]
        sel = sel[np.argsort(slots[sel])]
        off = 0
        for k in sel:
            starts[k] = off
            off += lengths[k]
        totals[i] = off
    return starts, totals


def build_comm_plan(
    pi: Rearrangement, cap_in: int, cap_out: int, *, chunk_pad_to: int = 8,
    src_starts: np.ndarray | None = None, chunk_cap: int | None = None,
) -> CommPlan:
    """Compile a Rearrangement into static-shape transport arrays.

    ``src_starts``: explicit token offset of each example in its SOURCE
    shard buffer (flat, aligned with pi's entries).  Defaults to packed
    contiguous layout in src_slot order; the orchestrator passes explicit
    starts when the source layout has alignment gaps (downsample) or
    padded rows (audio).
    """
    d = pi.d
    n = pi.n
    lengths = pi.lengths.astype(np.int64)
    if src_starts is None:
        src_starts, src_totals = _layout(pi.src_inst, pi.src_slot, lengths, d)
        if src_totals.max(initial=0) > cap_in:
            raise ValueError(f"cap_in={cap_in} < max shard tokens {src_totals.max()}")
    else:
        src_starts = np.asarray(src_starts, dtype=np.int64)
        if n and (src_starts + lengths).max() > cap_in:
            raise ValueError(f"cap_in={cap_in} < max src end {(src_starts + lengths).max()}")
    dst_starts, dst_totals = _layout(pi.dst_inst, pi.dst_slot, lengths, d)
    if dst_totals.max(initial=0) > cap_out:
        raise ValueError(f"cap_out={cap_out} < max shard tokens {dst_totals.max()}")

    pre_gather = np.zeros((d, cap_in), dtype=np.int32)
    input_offsets = np.zeros((d, d), dtype=np.int32)
    send_sizes = np.zeros((d, d), dtype=np.int32)
    output_offsets = np.zeros((d, d), dtype=np.int32)
    recv_sizes = np.zeros((d, d), dtype=np.int32)
    post_gather = np.zeros((d, cap_out), dtype=np.int32)
    post_mask = np.zeros((d, cap_out), dtype=bool)
    global_gather = np.zeros((d, cap_out), dtype=np.int32)

    # Send side: per source shard, order examples dest-major then dst_slot.
    send_pos_of_example = np.zeros(n, dtype=np.int64)  # position in send buffer
    for s in range(d):
        ex = np.where(pi.src_inst == s)[0]
        ex = ex[np.lexsort((pi.dst_slot[ex], pi.dst_inst[ex]))]
        off = 0
        for t in range(d):
            input_offsets[s, t] = off
            for k in ex[pi.dst_inst[ex] == t]:
                send_pos_of_example[k] = off
                l = int(lengths[k])
                pre_gather[s, off : off + l] = np.arange(
                    src_starts[k], src_starts[k] + l, dtype=np.int32
                )
                off += l
            send_sizes[s, t] = off - input_offsets[s, t]

    # Recv side: source-major chunks.
    for t in range(d):
        off = 0
        for s in range(d):
            output_offsets[s, t] = off
            recv_sizes[t, s] = send_sizes[s, t]
            off += send_sizes[s, t]

    # Dense-emulation layout: per-peer chunks padded to a static capacity.
    # ``chunk_cap`` may be supplied by the caller (FIXED across steps so
    # the jitted step never recompiles); overflow raises and the data
    # pipeline resamples.
    max_send = int(send_sizes.max(initial=0))
    if chunk_cap is None:
        chunk_cap = _round_up(max(max_send, 1), chunk_pad_to)
    elif max_send > chunk_cap:
        raise ValueError(f"peer chunk {max_send} > static chunk_cap {chunk_cap}")
    pre_gather_dense = np.zeros((d, d * chunk_cap), dtype=np.int32)
    for s in range(d):
        for t in range(d):
            sz = int(send_sizes[s, t])
            src = pre_gather[s, input_offsets[s, t] : input_offsets[s, t] + sz]
            pre_gather_dense[s, t * chunk_cap : t * chunk_cap + sz] = src

    # Post gather: final packed layout per destination shard.
    post_gather_dense = np.zeros((d, cap_out), dtype=np.int32)
    for t in range(d):
        ex = np.where(pi.dst_inst == t)[0]
        ex = ex[np.argsort(pi.dst_slot[ex])]
        for k in ex:
            s = int(pi.src_inst[k])
            # position of k's tokens inside s->t chunk:
            within = send_pos_of_example[k] - input_offsets[s, t]
            recv_start = output_offsets[s, t] + within
            l = int(lengths[k])
            dst = int(dst_starts[k])
            post_gather[t, dst : dst + l] = np.arange(
                recv_start, recv_start + l, dtype=np.int32
            )
            post_gather_dense[t, dst : dst + l] = s * chunk_cap + int(within) + np.arange(
                l, dtype=np.int32
            )
            post_mask[t, dst : dst + l] = True
            global_gather[t, dst : dst + l] = s * cap_in + np.arange(
                src_starts[k], src_starts[k] + l, dtype=np.int32
            )

    return CommPlan(
        d=d,
        cap_in=cap_in,
        cap_out=cap_out,
        pre_gather=pre_gather,
        input_offsets=input_offsets,
        send_sizes=send_sizes,
        output_offsets=output_offsets,
        recv_sizes=recv_sizes,
        post_gather=post_gather,
        post_mask=post_mask,
        global_gather=global_gather,
        chunk_cap=chunk_cap,
        pre_gather_dense=pre_gather_dense,
        post_gather_dense=post_gather_dense,
        dst_starts=dst_starts,
    )


_PLAN_KEYS = (
    "pre_gather", "input_offsets", "send_sizes", "output_offsets",
    "recv_sizes", "post_gather", "post_mask", "global_gather",
    "pre_gather_dense", "post_gather_dense",
)
# The per-peer split sizes size the ragged collective on the host, so
# they stay host tensors: reading them off the card would be a sync.
_HOST_KEYS = ("send_sizes", "recv_sizes")


def plan_to_device(plan: CommPlan, device) -> dict[str, torch.Tensor]:
    """The plan's arrays as tensors, ``[d, ...]`` each: on ``device``
    but for the split sizes, which stay on the host."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(plan, k))).to(
        "cpu" if k in _HOST_KEYS else device) for k in _PLAN_KEYS}


# ----------------------------------------------------------------------
# Device-side exchange.
# ----------------------------------------------------------------------
COMM_MODES = ("a2a", "ragged", "allgather", "gather")


def _all_gather_single(out, x, group):
    # torch 2.13 renamed all_gather_into_tensor; older releases lack the new name
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_single(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` along dim 0 (equal chunks when the splits are
    None); the backward sends the gradient back with the splits swapped."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        rows = sum(out_splits) if out_splits is not None else x.shape[0]
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return _AllToAll.apply(g, in_splits, out_splits, ctx.group), None, None, None


class _AllGather(torch.autograd.Function):
    """Every rank's rows, rank-major; the backward is the reduce-scatter
    (sum) of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world = dist.get_world_size(group)
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, g):
        world = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // world,) + tuple(g.shape[1:]))
        _reduce_scatter_single(out, g.contiguous(), ctx.group)
        return out, None


def _row(a, rank: int, world: int):
    """This rank's row of a plan array: ``a[rank]`` of a whole ``[d, ...]``
    plan, ``a[0]`` of the ``[1, ...]`` shard ``shard_batch`` leaves."""
    if a.shape[0] not in (1, world):
        raise ValueError(f"plan array of {a.shape[0]} rows under a group of {world}")
    return a[0] if a.shape[0] == 1 else a[rank]


def _host_sizes(a, rank: int, world: int) -> list[int]:
    row = _row(a, rank, world)
    if isinstance(row, torch.Tensor):
        if row.device.type != "cpu":
            raise ValueError("the ragged mode reads its split sizes on the host; "
                             "pass them as numpy arrays or CPU tensors "
                             "(plan_to_device keeps them there)")
        row = row.numpy()
    return [int(v) for v in row]


def _masked(res: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    keep = mask.reshape(mask.shape + (1,) * (res.dim() - 1))
    return torch.where(keep, res, torch.zeros((), dtype=res.dtype, device=res.device))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.to(x.device).reshape(-1).long())


def apply_comm_plan(x: torch.Tensor, plan_arrays: dict, group=None, *,
                    mode: str = "a2a") -> torch.Tensor:
    """Rearrange packed token payloads across DP ranks.

    Under a ``group`` (one process per DP instance), ``x`` is this rank's
    packed tokens ``[cap_in, ...]`` and the result this rank's
    ``[cap_out, ...]``; ``plan_arrays`` are the whole plan's ``[d, ...]``
    arrays or this rank's ``[1, ...]`` rows.  With no group only
    ``mode="gather"`` runs: ``x`` is all d streams ``[d * cap_in, ...]``
    and the result ``[d * cap_out, ...]``.  Positions where ``post_mask``
    is false are zero.
    """
    if mode not in COMM_MODES:
        raise ValueError(f"unknown communicator mode {mode!r}; one of {COMM_MODES}")
    if group is None and mode != "gather":
        raise ValueError(f"mode {mode!r} needs a group; with none only mode 'gather' "
                         "(the single-process take) runs")
    if group is not None and mode == "gather":
        raise ValueError("mode 'gather' has no meaning across processes; use 'a2a', "
                         "'ragged' or 'allgather' under a group")
    if group is None:
        out = _take(x, plan_arrays["global_gather"])
        return _masked(out, plan_arrays["post_mask"].to(x.device).reshape(-1))

    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def row(key):
        return _row(plan_arrays[key], rank, world)

    mask = row("post_mask").to(x.device)
    if mode == "allgather":
        everyone = _AllGather.apply(x, group)
        return _masked(_take(everyone, row("global_gather")), mask)
    if mode == "a2a":
        send = _take(x, row("pre_gather_dense"))
        recv = _AllToAll.apply(send, None, None, group)  # chunk s: from rank s
        return _masked(_take(recv, row("post_gather_dense")), mask)
    # ragged
    sizes = _host_sizes(plan_arrays["send_sizes"], rank, world)
    recv_sizes = _host_sizes(plan_arrays["recv_sizes"], rank, world)
    send = _take(x, row("pre_gather")[:sum(sizes)])
    recv = _AllToAll.apply(send, recv_sizes, sizes, group)
    if not recv.shape[0]:
        # nothing arrives and every position is masked; a zero row keeps
        # the result on the graph, so this rank too runs the backward's
        # collective that its peers run
        recv = torch.cat([recv, recv.new_zeros((1,) + tuple(recv.shape[1:]))])
    return _masked(_take(recv, row("post_gather")), mask)
