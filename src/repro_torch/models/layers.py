"""Shared neural building blocks (``repro.models.layers`` in PyTorch)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "layer_norm", "swiglu", "rotary_embedding", "apply_rope"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back; ``scale=None`` gives the
    non-parametric variant."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 and cast back; with scale=bias=None this
    is OLMo's non-parametric LN."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP (llama/qwen/mistral family)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10_000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for the given integer positions; [..., head_dim/2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Split-half RoPE.  x: [..., seq, heads, head_dim]; sin/cos:
    [..., seq, head_dim/2].  Computed in fp32 (the tables' type), cast
    back to x's type."""
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
