"""Paged KV-cache pool: a fixed-size block allocator over the decode cache.

Device storage follows ``registry.paged_cache_specs``: per layer, the
KV cache is a pool of ``num_blocks`` blocks of ``block_size`` token
slots; a sequence's logical cache is its *block table* -- slot ``i``
lives at ``(table[i // block_size], i % block_size)``.  Decode reads
through a block-table gather (:mod:`repro_torch.models.decode`), so the same
attention path runs on paged storage and sequences of wildly different
lengths share one physical pool with no per-sequence over-allocation.

Block 0 is the reserved NULL block: all-zero k/v with ``kv_seg == 0``.
Short block tables are padded with it, and a gather of the null block
reproduces exactly what a dense zero-initialized cache holds in
unwritten slots -- this is what makes paged decode bit-identical to the
dense path.  For the same reason ``free()`` zeroes the freed blocks'
``kv_seg`` rows: a recycled block must never leak stale segment marks
into a new owner's masked slots (stale k/v values are harmless -- the
mask multiplies them by an exact 0 -- but stale seg marks would
un-mask them).

Host-side bookkeeping (free list + tables) is plain Python; the cache
tensors live on the engine's device and the decode step writes into
them in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import paged_cache_specs
from repro_torch.utils import zeros_like_specs

__all__ = ["PoolExhausted", "PagedKVPool", "NULL_BLOCK"]

NULL_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Raised by ``alloc`` when the free list cannot cover a request --
    the engine's signal to preempt."""


class PagedKVPool:
    def __init__(self, cfg: ModelConfig, *, num_blocks: int, block_size: int,
                 device):
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        if self.num_blocks < 2:
            raise ValueError("need num_blocks >= 2 (block 0 is reserved)")
        self.cache = zeros_like_specs(
            paged_cache_specs(cfg, self.num_blocks, self.block_size), device)
        # Free list kept descending so list.pop() hands out the lowest
        # id first (deterministic allocation order for tests).
        self._free: list[int] = list(range(self.num_blocks - 1, NULL_BLOCK, -1))
        self._tables: dict[int, list[int]] = {}

    # -- capacity accounting --------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.usable_blocks - self.num_free

    @property
    def occupancy(self) -> float:
        return self.num_used / self.usable_blocks

    def table(self, seq_id: int) -> list[int]:
        return list(self._tables.get(seq_id, ()))

    def owners(self) -> list[int]:
        return list(self._tables)

    def blocks_for_slots(self, n_slots: int) -> int:
        """Blocks a table must span to cover ``n_slots`` token slots."""
        return -(-max(0, n_slots) // self.block_size)

    def blocks_short(self, seq_id: int, n_slots: int) -> int:
        """Additional blocks ``seq_id`` needs to cover ``n_slots``."""
        return max(0, self.blocks_for_slots(n_slots)
                   - len(self._tables.get(seq_id, ())))

    def can_alloc(self, n_blocks: int) -> bool:
        return n_blocks <= self.num_free

    # -- alloc / free ------------------------------------------------
    def alloc(self, seq_id: int, n_blocks: int = 1) -> list[int]:
        """Append ``n_blocks`` fresh blocks to ``seq_id``'s table."""
        if n_blocks < 0:
            raise ValueError(f"n_blocks must be >= 0, got {n_blocks}")
        if n_blocks > self.num_free:
            raise PoolExhausted(
                f"seq {seq_id} needs {n_blocks} blocks, {self.num_free} free")
        blocks = [self._free.pop() for _ in range(n_blocks)]
        self._tables.setdefault(seq_id, []).extend(blocks)
        return blocks

    def ensure(self, seq_id: int, n_slots: int) -> list[int]:
        """Grow ``seq_id``'s table to cover ``n_slots`` slots."""
        return self.alloc(seq_id, self.blocks_short(seq_id, n_slots))

    def free(self, seq_id: int) -> list[int]:
        """Release ``seq_id``'s blocks (zeroing their kv_seg rows)."""
        blocks = self._tables.pop(seq_id, [])
        if blocks:
            idx = torch.as_tensor(blocks, device=self.cache["kv_seg"].device)
            self.cache["kv_seg"][idx] = 0
            self._free.extend(blocks)
            self._free.sort(reverse=True)
        return blocks

    # -- device-side views ----------------------------------------------
    def table_array(self, seq_ids, width: int) -> np.ndarray:
        """Block tables as a dense [B, width] int32 (null-block padded)."""
        out = np.full((len(seq_ids), width), NULL_BLOCK, dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            blocks = self._tables.get(sid, ())
            if len(blocks) > width:
                raise ValueError(
                    f"seq {sid} table has {len(blocks)} blocks > width {width}")
            out[i, : len(blocks)] = blocks
        return out

    def check(self) -> None:
        """Assert allocator invariants (tests): the null block is never
        allocated, no block is double-booked, and free + allocated
        partition the usable id range."""
        seen: set[int] = set()
        for sid, blocks in self._tables.items():
            for b in blocks:
                assert b != NULL_BLOCK, f"seq {sid} owns the null block"
                assert 0 < b < self.num_blocks, f"seq {sid} owns bad id {b}"
                assert b not in seen, f"block {b} double-booked"
                seen.add(b)
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids in free list"
        assert not (free & seen), f"blocks both free and allocated: {free & seen}"
        assert free | seen == set(range(1, self.num_blocks)), "id leak"
