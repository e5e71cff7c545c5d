"""AdamW + global-norm clipping + cosine schedule
(``repro.training.optimizer`` in PyTorch).

Parameter and optimizer trees are nested dicts of tensors.  The update
follows the JAX package step for step (clip, moments, bias correction,
decay of every leaf with ``ndim >= 2`` -- stacked ``[L, D]`` norm scales
included -- then ``p - lr * delta`` in fp32, cast back).  Where JAX returns
new trees, the port updates parameters and moments in place and returns
the same dicts: the full-width model has no memory for a second copy.
Leaves are walked in pieces of at most ``CHUNK_ELEMS`` elements (a
stacked ``[L, ...]`` leaf layer slice by layer slice, and a slice or an
unstacked leaf larger than that in row chunks), which bounds every fp32
temporary to one piece: MLLM-84B's ``[152064, 8192]`` embedding would
otherwise take 4.98 GB per temporary.  The update is elementwise, so the
pieces give it bit for bit; the norm sums the pieces' sums.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: dict) -> list:
    """Leaves of a nested dict, depth first in insertion order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def _zip_leaves(*trees):
    """Tuples of same-key leaves of congruent nested dicts, in the first
    tree's order."""
    for k, v in trees[0].items():
        if isinstance(v, dict):
            yield from _zip_leaves(*(t[k] for t in trees))
        else:
            yield tuple(t[k] for t in trees)


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# Elements of the largest piece a leaf is walked in (256 MB in fp32).
CHUNK_ELEMS = 1 << 26


def _pieces(t: torch.Tensor):
    """A leaf as views of at most ``CHUNK_ELEMS`` elements: a stacked
    leaf (ndim >= 3) as its layer slices, and each slice (or any other
    leaf) larger than that as chunks of whole rows of its first dim."""
    for part in (t.unbind(0) if t.dim() >= 3 else (t,)):
        if part.dim() == 0 or part.numel() <= CHUNK_ELEMS:
            yield part
        else:
            yield from part.split(max(1, CHUNK_ELEMS // part[0].numel()))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = None
    for leaf in tree_leaves(tree):
        for part in _pieces(leaf):
            sq = torch.sum(torch.square(part.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_init(params: dict) -> dict:
    return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
            "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig, *,
                 lr=None):
    """Returns (params, state, metrics), parameters and moments updated
    in place; ``lr`` overrides ``cfg.lr`` (a float or a 0-d tensor)."""
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, mu, nu in _zip_leaves(params, grads, state["mu"], state["nu"]):
        decay = p.dim() >= 2  # decay matrices only (standard practice)
        for ps, gs, ms, ns in zip(_pieces(p), _pieces(g), _pieces(mu), _pieces(nu)):
            gf = gs.float() * scale
            ms.copy_(b1 * ms + (1 - b1) * gf)
            ns.copy_(b2 * ns + (1 - b2) * gf * gf)
            delta = (ms / bc1) / (torch.sqrt(ns / bc2) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * ps.float()
            ps.copy_((ps.float() - lr * delta).to(ps.dtype))
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm}
