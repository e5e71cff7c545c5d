"""Node-wise All-to-All Communicator -- host half (paper S5.2.1).

A copy of the host side of ``repro.core.communicator``: :class:`CommPlan`
and :func:`build_comm_plan` compile a rearrangement into the static-shape
transport arrays the training step reads.  The device half
(``apply_comm_plan``) is not ported yet; on one card the exchange is the
``global_gather`` take of ``repro_torch.training.train_step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.rearrangement import Rearrangement
from repro_torch.utils import round_up as _round_up

__all__ = ["CommPlan", "build_comm_plan"]


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
