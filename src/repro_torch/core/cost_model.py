"""Cost models f(S) for Batch Post-Balancing (paper Eq. 1, Eq. 2, App. A).

A copy of the parts of ``repro.core.cost_model`` that the serving
scheduler uses: :class:`CostModel`, :class:`ServingCostModel`,
:func:`transformer_cost_coeffs` and :func:`serving_cost_model`.

  Eq. (2)  transformer    f = alpha*L + beta * L^2 / b          (padding)
                          f = alpha*L + beta * sum(l_j^2)       (no padding)

  App. A   conv-transformer (padded attention, unpadded batch):
                          f = L + lambda * b * max(l)^2
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "CostModel",
    "FEATURE_NAMES",
    "N_FEATURES",
    "ServingCostModel",
    "length_features",
    "serving_cost_model",
    "transformer_cost_coeffs",
]

# Per-batch feature basis shared by every f(S) variant (and by the
# telemetry calibrator, which regresses measured wall times onto it):
#   x0 = L        batch length per Eq. (1) (sum packed, b*max padded)
#   x1 = L^2/b    padded quadratic term
#   x2 = sum l^2  packed quadratic term
#   x3 = b*max^2  ConvTransformer quadratic term (== x1 when padded)
# so every variant is  f = alpha*x0 + beta*x[quad_index].
FEATURE_NAMES = ("L", "L2_over_b", "sum_l2", "b_max_l2")
N_FEATURES = len(FEATURE_NAMES)


def length_features(lengths: Sequence[int] | np.ndarray,
                    padding: bool = False) -> np.ndarray:
    """The (4,) feature vector of one mini-batch."""
    arr = np.asarray(lengths, dtype=np.float64)
    if arr.size == 0:
        return np.zeros(N_FEATURES)
    b = float(arr.size)
    s = float(arr.sum())
    mx = float(arr.max())
    L = b * mx if padding else s
    return np.array([L, L * L / b, float((arr * arr).sum()), b * mx * mx])


def _segment_max(values: np.ndarray, ids: np.ndarray, n_segments: int) -> np.ndarray:
    """Max of ``values`` per segment id (empty segments -> 0)."""
    out = np.zeros(n_segments, dtype=np.float64)
    np.maximum.at(out, ids, values)
    return out


@dataclasses.dataclass(frozen=True)
class CostModel:
    """f(S) for one phase.

    Attributes:
      alpha: linear per-token coefficient.
      beta: quadratic attention coefficient (0 for SSM phases).
      padding: whether the phase batches with padding (paper: audio yes,
        vision/LLM no).
      conv_attention: App. A ConvTransformer objective -- attention is
        computed on the *padded* length even though the batch is packed
        (f = L + lambda*b*max(l)^2).  Mutually exclusive with `padding`.
    """

    alpha: float = 1.0
    beta: float = 0.0
    padding: bool = False
    conv_attention: bool = False

    @property
    def lam(self) -> float:
        return self.beta / self.alpha if self.alpha else 0.0

    @property
    def quad_index(self) -> int:
        """Which feature column carries this variant's quadratic term."""
        if self.conv_attention:
            return 3
        return 1 if self.padding else 2

    def with_coeffs(self, alpha: float, beta: float) -> "CostModel":
        """Same variant (padding / conv flags), new coefficients -- the
        single injection point calibration swaps through."""
        return dataclasses.replace(self, alpha=float(alpha), beta=float(beta))

    def feature_vector(self, lengths: Sequence[int] | np.ndarray) -> np.ndarray:
        return length_features(lengths, self.padding)

    def segment_features(self, lengths: np.ndarray, batch_ids: np.ndarray,
                         d: int) -> np.ndarray:
        """Per-destination-batch feature vectors, shape (d, 4) -- the
        vectorized :func:`length_features` over a whole assignment."""
        lengths = np.asarray(lengths, dtype=np.float64)
        batch_ids = np.asarray(batch_ids)
        cnt = np.bincount(batch_ids, minlength=d).astype(np.float64)
        bsum = np.bincount(batch_ids, weights=lengths, minlength=d)
        sq = np.bincount(batch_ids, weights=lengths * lengths, minlength=d)
        bmax = _segment_max(lengths, batch_ids, d)
        L = cnt * bmax if self.padding else bsum
        safe_cnt = np.maximum(cnt, 1.0)
        return np.stack([L, L * L / safe_cnt, sq, cnt * bmax * bmax], axis=1)

    def cost_from_features(self, features: np.ndarray) -> np.ndarray:
        """f(S) from (..., 4) feature vectors; agrees with :meth:`cost`."""
        f = np.asarray(features, dtype=np.float64)
        return self.alpha * f[..., 0] + self.beta * f[..., self.quad_index]

    def cost(self, lengths: Sequence[int] | np.ndarray) -> float:
        """f(S) per paper Eq. (2) / App. A."""
        arr = np.asarray(lengths, dtype=np.float64)
        if arr.size == 0:
            return 0.0
        b = arr.size
        if self.conv_attention:
            L = float(arr.sum())
            return self.alpha * L + self.beta * b * float(arr.max()) ** 2
        if self.padding:
            L = b * float(arr.max())
            return self.alpha * L + self.beta * (L * L) / b
        L = float(arr.sum())
        return self.alpha * L + self.beta * float((arr * arr).sum())

    def costs(self, batches: Sequence[Sequence[int]]) -> np.ndarray:
        return np.array([self.cost(b) for b in batches], dtype=np.float64)

    # -- batched evaluators (vectorized balancing engine + oracle) ------
    def segment_costs(self, lengths: np.ndarray, batch_ids: np.ndarray,
                      d: int) -> np.ndarray:
        """f(S'_i) for every destination batch at once.

        ``lengths[k]`` belongs to batch ``batch_ids[k]``; returns shape
        (d,).  Agrees with :meth:`cost` per batch (empty batches cost 0).
        """
        lengths = np.asarray(lengths, dtype=np.float64)
        batch_ids = np.asarray(batch_ids)
        bsum = np.bincount(batch_ids, weights=lengths, minlength=d)
        if self.conv_attention:
            cnt = np.bincount(batch_ids, minlength=d)
            bmax = _segment_max(lengths, batch_ids, d)
            return self.alpha * bsum + self.beta * cnt * bmax * bmax
        if self.padding:
            cnt = np.bincount(batch_ids, minlength=d)
            bmax = _segment_max(lengths, batch_ids, d)
            L = cnt * bmax
            return self.alpha * L + self.beta * L * L / np.maximum(cnt, 1)
        sq = np.bincount(batch_ids, weights=lengths * lengths, minlength=d)
        return self.alpha * bsum + self.beta * sq

    def assignment_costs(self, lengths: np.ndarray,
                         assignments: np.ndarray, d: int) -> np.ndarray:
        """Per-batch costs for a whole matrix of candidate assignments.

        ``assignments`` has shape (m, n): row r assigns ``lengths[j]`` to
        batch ``assignments[r, j]``.  Returns shape (m, d).  This is the
        batched objective evaluator the brute-force oracle enumerates
        with (one bincount instead of m*d python cost() calls).
        """
        assignments = np.asarray(assignments, dtype=np.int64)
        m, n = assignments.shape
        flat_ids = (assignments + d * np.arange(m, dtype=np.int64)[:, None]).ravel()
        flat_lens = np.broadcast_to(lengths, (m, n)).ravel()
        return self.segment_costs(flat_lens, flat_ids, m * d).reshape(m, d)

    def max_cost(self, batches: Sequence[Sequence[int]]) -> float:
        c = self.costs(batches)
        return float(c.max()) if c.size else 0.0

    def utilization(self, batches: Sequence[Sequence[int]]) -> float:
        """Simulated utilization = mean(f) / max(f).

        Under synchronous DP every instance waits for the straggler, so a
        batch set with cost vector c achieves mean(c)/max(c) of the
        utilization a perfectly balanced set would.  This is the metric
        the benchmarks report as 'simulated MFU fraction'.
        """
        c = self.costs(batches)
        m = float(c.max()) if c.size else 0.0
        return float(c.mean() / m) if m > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class ServingCostModel:
    """Admission costs for the serving engine's scheduler.

    Serving reuses the training-time balancing machinery: the set of
    requests admitted to one engine step is a "mini-batch" whose cost a
    token budget caps, and the waiting queue is post-balanced across
    engine replicas with the same :class:`CostModel` objective
    (``post_balance`` over weighted lengths).  Modality Composition
    Incoherence shows up at serving time as prefill cost varying by
    orders of magnitude with the request's modality mix, so:

      prefill cost = f(modality-weighted length)
                     where weighted length = text tokens
                       + sum_m weight_m * modality-m tokens
      decode cost  = ``decode_cost`` (one token per step, length
                     independent to first order)

    ``modality_weights[m]`` is the per-token compute of a modality-m
    LLM token relative to a text token (its encoder + connector ride on
    top of the backbone); modalities without an entry cost 1.0.
    """

    model: CostModel = dataclasses.field(default_factory=CostModel)
    modality_weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    decode_cost: float = 1.0

    def weighted_length(self, text_len: float,
                        modality_tokens: Mapping[str, int] | None = None) -> float:
        total = float(text_len)
        for m, n in (modality_tokens or {}).items():
            total += self.modality_weights.get(m, 1.0) * float(n)
        return total

    def prefill_cost(self, text_len: float,
                     modality_tokens: Mapping[str, int] | None = None) -> float:
        """f(S) of a single-request prefill at its weighted length."""
        return self.model.cost([self.weighted_length(text_len, modality_tokens)])

    def weighted_lengths(
        self,
        text_lens: Sequence[float],
        modality_tokens: Sequence[Mapping[str, int] | None],
    ) -> np.ndarray:
        return np.array(
            [self.weighted_length(t, m) for t, m in zip(text_lens, modality_tokens)],
            dtype=np.float64,
        )


def transformer_cost_coeffs(
    hidden: int,
    ffn: int,
    n_layers: int,
    *,
    moe_experts_active: int = 1,
    ssm: bool = False,
) -> tuple[float, float]:
    """Derive (alpha, beta) from an architecture (used by dispatchers).

    alpha ~ per-token matmul FLOPs, beta ~ per-token-pair attention FLOPs.
    Both are scaled so alpha is O(1) -- only the *ratio* matters for the
    balancing objective.
    """
    lin = n_layers * (8.0 * hidden * hidden + 6.0 * hidden * ffn * moe_experts_active)
    quad = 0.0 if ssm else 4.0 * n_layers * hidden
    alpha = 1.0
    beta = quad / lin
    return alpha, beta


def serving_cost_model(cfg) -> ServingCostModel:
    """Derive the serving admission costs from an architecture.

    alpha/beta come from :func:`transformer_cost_coeffs` (so the
    quadratic attention term prices long prompts super-linearly, as in
    training).  Each encoder's modality weight is the encoder+connector
    compute riding on one post-connector LLM token, relative to a
    backbone token: ``1 + (enc_layers * enc_width^2 * downsample) /
    (layers * width^2)`` -- ``downsample`` because each LLM token
    aggregates that many encoder tokens."""
    alpha, beta = transformer_cost_coeffs(
        cfg.d_model, cfg.d_ff, max(1, cfg.n_layers),
        moe_experts_active=max(1, cfg.experts_per_token),
        ssm=cfg.family == "ssm")
    base = max(1, cfg.n_layers) * cfg.d_model ** 2
    weights = {
        e.name: 1.0 + (e.n_layers * e.d_model ** 2 * e.downsample) / base
        for e in cfg.encoders
    }
    return ServingCostModel(CostModel(alpha=alpha, beta=beta),
                            modality_weights=weights)
