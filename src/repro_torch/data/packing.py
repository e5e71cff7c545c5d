"""Packed-stream assembly for post-balanced batches.

(A copy of ``repro.data.packing``, with the port's imports.)

A *stream* is one DP shard's token buffer [cap]: examples laid out
contiguously in destination-slot order, ``seg`` carrying a per-example
id (0 = padding), ``pos`` restarting at 0 per example.  Padded phases
(audio, paper S8) lay each example out in a fixed ``max_len`` row inside
the stream so the compute cost matches the padded cost model while the
same segment machinery applies.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pack_stream", "pack_padded_stream", "random_tokens"]


def pack_stream(
    dest_lengths: list[np.ndarray],
    cap: int,
    *,
    seg_ids: list[np.ndarray] | None = None,
    align: int = 1,
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Build (seg [S,cap], pos [S,cap], starts per shard) for packed layout.

    ``seg_ids[i][j]``: id (>0) of example j on shard i; defaults to a
    running counter unique per shard.  ``align``: round each example's
    start offset up to this multiple (connector downsample alignment).
    """
    S = len(dest_lengths)
    seg = np.zeros((S, cap), np.int32)
    pos = np.zeros((S, cap), np.int32)
    starts: list[np.ndarray] = []
    for i, lens in enumerate(dest_lengths):
        off = 0
        st = np.zeros(len(lens), np.int64)
        for j, l in enumerate(np.asarray(lens, np.int64)):
            sid = int(seg_ids[i][j]) if seg_ids is not None else j + 1
            if off + l > cap:
                raise ValueError(f"shard {i}: {off + l} tokens > cap {cap}")
            seg[i, off : off + l] = sid
            pos[i, off : off + l] = np.arange(l)
            st[j] = off
            off += int(l)
            off = -(-off // align) * align
        starts.append(st)
    return seg, pos, starts


def pack_padded_stream(
    dest_lengths: list[np.ndarray],
    cap: int,
    row_len: int,
    *,
    seg_ids: list[np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Padded layout: example j of a shard occupies row j*row_len; tokens
    beyond its length stay seg=0 (padding).  cap must be >= rows*row_len."""
    S = len(dest_lengths)
    seg = np.zeros((S, cap), np.int32)
    pos = np.zeros((S, cap), np.int32)
    starts: list[np.ndarray] = []
    for i, lens in enumerate(dest_lengths):
        st = np.zeros(len(lens), np.int64)
        for j, l in enumerate(np.asarray(lens, np.int64)):
            off = j * row_len
            if off + row_len > cap:
                raise ValueError(f"shard {i}: padded rows exceed cap {cap}")
            if l > row_len:
                raise ValueError(f"example len {l} > row_len {row_len}")
            sid = int(seg_ids[i][j]) if seg_ids is not None else j + 1
            seg[i, off : off + l] = sid
            pos[i, off : off + l] = np.arange(l)
            st[j] = off
        starts.append(st)
    return seg, pos, starts


def random_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    return rng.integers(1, vocab, size=shape, dtype=np.int32)
