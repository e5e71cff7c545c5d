"""Rearrangement Pi: the consequence-invariant example permutation (paper S3.3).

(A copy of ``repro.core.rearrangement``, with the port's imports.)

A rearrangement maps example j of original mini-batch i to slot j' of new
mini-batch i'.  We key every example by its *original* (instance, slot) so
that rearrangements from different phases of the same iteration can be
composed (paper S6, "Rearrangement Composition"):

    A'_Ek = (Pi_M o Pi_Ek^{-1})(A_Ek)

i.e. data currently living at Pi_Ek's destinations moves directly to
Pi_M's destinations in ONE all-to-all instead of two.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Rearrangement", "identity_rearrangement", "compose"]


@dataclasses.dataclass
class Rearrangement:
    """Flat representation over n examples.

    All arrays have shape (n,).  Example k originated at
    (orig_inst[k], orig_slot[k]); under this rearrangement its payload
    moves from (src_inst[k], src_slot[k]) to (dst_inst[k], dst_slot[k]).
    For a plain post-balancing plan src == orig; for a *composed* plan
    (encoder outputs) src is the encoder dispatcher's destination.
    """

    d: int
    orig_inst: np.ndarray
    orig_slot: np.ndarray
    src_inst: np.ndarray
    src_slot: np.ndarray
    dst_inst: np.ndarray
    dst_slot: np.ndarray
    lengths: np.ndarray  # token lengths of the moved payloads

    def __post_init__(self) -> None:
        n = len(self.orig_inst)
        for name in ("orig_slot", "src_inst", "src_slot", "dst_inst", "dst_slot", "lengths"):
            arr = getattr(self, name)
            if len(arr) != n:
                raise ValueError(f"{name} has length {len(arr)} != {n}")

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.orig_inst)

    @classmethod
    def from_batches(
        cls,
        new_batches: Sequence[Sequence[tuple[int, int, int]]],
        d: int,
    ) -> "Rearrangement":
        """Build from a list (len d') of batches of (src_inst, src_slot, length).

        ``d'`` may be < d (Alg 2 can produce fewer); the remaining
        destination batches are empty.
        """
        if len(new_batches) > d:
            raise ValueError(f"{len(new_batches)} batches > d={d}")
        oi, osl, di, dsl, ln = [], [], [], [], []
        for dst, batch in enumerate(new_batches):
            for slot, (si, sj, length) in enumerate(batch):
                oi.append(si)
                osl.append(sj)
                di.append(dst)
                dsl.append(slot)
                ln.append(length)
        oi = np.asarray(oi, dtype=np.int64)
        osl = np.asarray(osl, dtype=np.int64)
        return cls(
            d=d,
            orig_inst=oi,
            orig_slot=osl,
            src_inst=oi.copy(),
            src_slot=osl.copy(),
            dst_inst=np.asarray(di, dtype=np.int64),
            dst_slot=np.asarray(dsl, dtype=np.int64),
            lengths=np.asarray(ln, dtype=np.int64),
        )

    # ------------------------------------------------------------------
    def dest_batches(self) -> list[list[tuple[int, int, int]]]:
        """Inverse view: per destination instance, ordered (src_inst, src_slot, len)."""
        out: list[list[tuple[int, int, int]]] = [[] for _ in range(self.d)]
        order = np.lexsort((self.dst_slot, self.dst_inst))
        for k in order:
            out[int(self.dst_inst[k])].append(
                (int(self.src_inst[k]), int(self.src_slot[k]), int(self.lengths[k]))
            )
        return out

    def dest_lengths(self) -> list[np.ndarray]:
        """Per destination instance, the ordered sequence lengths."""
        order = np.lexsort((self.dst_slot, self.dst_inst))
        lens_sorted = np.asarray(self.lengths, dtype=np.int64)[order]
        counts = np.bincount(self.dst_inst[order], minlength=self.d)
        return np.split(lens_sorted, np.cumsum(counts)[:-1])

    def comm_matrix(self) -> np.ndarray:
        """V[i, j] = token volume moving from instance i to instance j (S5.2.2)."""
        V = np.zeros((self.d, self.d), dtype=np.int64)
        np.add.at(V, (self.src_inst, self.dst_inst), self.lengths)
        return V

    def internode_volume(self, instances_per_node: int) -> np.ndarray:
        """Per-source-instance volume leaving its node (paper Eq. 5 argument)."""
        V = self.comm_matrix()
        c = instances_per_node
        node_of = np.arange(self.d) // c
        same = node_of[:, None] == node_of[None, :]
        return (V * (~same)).sum(axis=1)

    def self_volume(self) -> int:
        """Bytes that never leave their shard (beyond-paper metric)."""
        stay = self.src_inst == self.dst_inst
        return int(self.lengths[stay].sum())

    # ------------------------------------------------------------------
    def permute_destinations(self, perm: np.ndarray) -> "Rearrangement":
        """Relabel destination batches: new dst of batch i is perm[i].

        The balancing objective only depends on the *contents* of each
        destination batch, not its index (paper S5.2.2) -- so this is
        objective-invariant and is the degree of freedom the Node-wise
        Rearrangement Algorithm optimizes.
        """
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (self.d,) or set(perm.tolist()) != set(range(self.d)):
            raise ValueError("perm must be a permutation of range(d)")
        return dataclasses.replace(self, dst_inst=perm[self.dst_inst])

    def inverse(self) -> "Rearrangement":
        """Pi^{-1}: moves payloads from dst back to src."""
        return dataclasses.replace(
            self,
            src_inst=self.dst_inst.copy(),
            src_slot=self.dst_slot.copy(),
            dst_inst=self.src_inst.copy(),
            dst_slot=self.src_slot.copy(),
        )


def identity_rearrangement(lengths_per_instance: Sequence[np.ndarray], d: int) -> Rearrangement:
    """The no-balancing baseline: every example stays where it was sampled."""
    batches = [
        [(i, j, int(l)) for j, l in enumerate(lens)]
        for i, lens in enumerate(lengths_per_instance)
    ]
    batches += [[] for _ in range(d - len(batches))]
    return Rearrangement.from_batches(batches, d)


def compose(pi_m: Rearrangement, pi_e: Rearrangement) -> Rearrangement:
    """Pi_M o Pi_E^{-1}: move encoder outputs (located per pi_e) straight to
    pi_m's destinations (paper S6).

    ``pi_e`` may cover a SUBSET of pi_m's examples (Modality Composition
    Incoherence: not every example has every modality); the composed
    rearrangement covers exactly pi_e's examples.  Lengths are taken from
    ``pi_e`` (the payload being moved is the *encoded* subsequence, whose
    length pi_e tracked).  Destination slots keep pi_m's example-level
    slots (gaps where other examples sit are fine: layouts sort by slot).
    """
    # Join on (orig_inst, orig_slot).
    idx_m = {(int(a), int(b)): k for k, (a, b) in enumerate(zip(pi_m.orig_inst, pi_m.orig_slot))}
    n = pi_e.n
    dst_inst = np.empty(n, dtype=np.int64)
    dst_slot = np.empty(n, dtype=np.int64)
    for k in range(n):
        key = (int(pi_e.orig_inst[k]), int(pi_e.orig_slot[k]))
        if key not in idx_m:
            raise KeyError(f"example {key} missing from backbone rearrangement")
        m = idx_m[key]
        dst_inst[k] = pi_m.dst_inst[m]
        dst_slot[k] = pi_m.dst_slot[m]
    return Rearrangement(
        d=pi_m.d,
        orig_inst=pi_e.orig_inst.copy(),
        orig_slot=pi_e.orig_slot.copy(),
        src_inst=pi_e.dst_inst.copy(),
        src_slot=pi_e.dst_slot.copy(),
        dst_inst=dst_inst,
        dst_slot=dst_slot,
        lengths=pi_e.lengths.copy(),
    )
