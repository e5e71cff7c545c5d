"""Weights between the JAX package and the port, as numpy.

``params_from_numpy`` turns a parameter tree of nested dicts of numpy
arrays -- the JAX package's ``init_params`` output after
``jax.tree.map(np.asarray, params)`` -- into the port's dict of tensors,
with the same keys and the same stacked ``[L, ...]`` shapes.
``params_to_numpy`` goes back.  bf16 travels as fp32 numpy-side on the
way out (numpy has no bf16) and converts exactly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (what JAX hands numpy): widen exactly to fp32
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        t = t.to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


# Leaves the JAX package keeps in fp32 whatever the model's dtype.
FP32_LEAVES = frozenset({"router"})


def params_from_numpy(tree: dict, *, device, dtype: torch.dtype | None = None) -> dict:
    """Nested dicts of numpy arrays -> nested dicts of tensors on
    ``device`` (cast to ``dtype`` when given, else the arrays' own; the
    ``FP32_LEAVES`` keep their own dtype)."""
    return {k: params_from_numpy(v, device=device, dtype=dtype) if isinstance(v, dict)
            else _tensor(v, device, None if k in FP32_LEAVES else dtype)
            for k, v in tree.items()}


def params_to_numpy(tree: dict) -> dict:
    """Nested dicts of tensors -> nested dicts of numpy arrays (bf16 as
    fp32)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else arr(v)
            for k, v in tree.items()}
