"""Small shared numeric helpers."""
from __future__ import annotations

import torch

__all__ = ["round_up", "zeros_like_specs", "resolve_device"]


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return -(-x // m) * m


def zeros_like_specs(specs: dict, device) -> dict:
    """Zero tensors on ``device`` for a dict of ``(shape, dtype)`` specs
    (the port's form of ``registry`` cache specs)."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in specs.items()}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no
    GPU: entry points run on the card unless the caller asks for the
    CPU, and never fall back silently."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device
