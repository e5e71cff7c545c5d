"""Streaming quantile sketch, a copy of ``repro.obs.registry``'s
:class:`QuantileSketch` (the estimator behind ``EngineReport``'s
p50/p95/p99)."""
from __future__ import annotations

import math
from typing import Iterable, Sequence

__all__ = ["QuantileSketch"]


class QuantileSketch:
    """Greenwald-Khanna epsilon-approximate streaming quantiles.

    Maintains tuples ``(v, g, delta)`` such that for any query rank
    ``r`` the returned value's true rank is within ``eps * n`` of ``r``
    -- the classic GK invariant ``g + delta <= floor(2 * eps * n)``.
    Memory is O((1/eps) * log(eps * n)); inserts amortize to O(log)
    via a buffered batch insert.

    The rank-error bound is what the property tests in
    ``tests/test_obs.py`` verify against ``np.quantile`` on adversarial
    (sorted / reversed / constant / heavy-tailed) streams.
    """

    __slots__ = ("eps", "_tuples", "_n", "_buf", "_buf_cap")

    def __init__(self, eps: float = 0.005, buffer: int = 64) -> None:
        if not 0.0 < eps < 0.5:
            raise ValueError(f"eps must be in (0, 0.5), got {eps}")
        self.eps = float(eps)
        self._tuples: list[list[float]] = []  # [v, g, delta], sorted by v
        self._n = 0
        self._buf: list[float] = []
        self._buf_cap = max(1, int(buffer))

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return self._n + len(self._buf)

    def add(self, value: float) -> None:
        self._buf.append(float(value))
        if len(self._buf) >= self._buf_cap:
            self._drain()

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def _drain(self) -> None:
        if not self._buf:
            return
        for v in sorted(self._buf):
            self._insert(v)
        self._buf.clear()
        self._compress()

    def _insert(self, v: float) -> None:
        t = self._tuples
        self._n += 1
        if not t or v < t[0][0]:
            t.insert(0, [v, 1.0, 0.0])
            return
        if v >= t[-1][0]:
            t.append([v, 1.0, 0.0])
            return
        # binary search for the first tuple with value > v
        lo, hi = 0, len(t)
        while lo < hi:
            mid = (lo + hi) // 2
            if t[mid][0] <= v:
                lo = mid + 1
            else:
                hi = mid
        cap = math.floor(2.0 * self.eps * self._n)
        t.insert(lo, [v, 1.0, max(0.0, cap - 1.0)])

    def _compress(self) -> None:
        t = self._tuples
        if len(t) < 3:
            return
        cap = math.floor(2.0 * self.eps * self._n)
        i = len(t) - 2
        while i >= 1:
            if t[i][1] + t[i + 1][1] + t[i + 1][2] <= cap:
                t[i + 1][1] += t[i][1]
                del t[i]
            i -= 1

    def quantile(self, q: float) -> float:
        """Value whose rank is within ``eps * n`` of ``ceil(q * n)``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        self._drain()
        if self._n == 0:
            return float("nan")
        t = self._tuples
        target = max(1, math.ceil(q * self._n))  # 1-based target rank
        margin = self.eps * self._n
        rmin = 0.0
        prev_v = t[0][0]
        for v, g, delta in t:
            rmin += g
            if rmin + delta > target + margin:
                return prev_v
            prev_v = v
        return t[-1][0]

    def quantiles(self, qs: Sequence[float]) -> list[float]:
        return [self.quantile(q) for q in qs]

    # -- serialization (flight recorder / snapshots) --------------------
    def state_dict(self) -> dict:
        self._drain()
        return {"eps": self.eps, "n": self._n,
                "tuples": [list(t) for t in self._tuples]}

    @classmethod
    def from_state_dict(cls, state: dict) -> "QuantileSketch":
        sk = cls(eps=state["eps"])
        sk._n = int(state["n"])
        sk._tuples = [list(t) for t in state["tuples"]]
        return sk
