"""Shared transformer layers (counterpart of ``repro.models.layers``).

Parameters are plain dicts of tensors.  The reference's sharding helpers
(``shard``, ``axis_rules``, ``resolve_pspec``) have no counterpart: the
port runs on one card.
"""
from __future__ import annotations

import torch
from torch import Tensor
from torch.nn import functional as F


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS normalisation over the last axis, computed in float32 and
    returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dt)


def rope_freqs(seq: int, dim: int, theta: float, offset: int = 0, *,
               device=None) -> tuple[Tensor, Tensor]:
    """(cos, sin) of shape (seq, dim // 2), float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    pos = offset + torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (B, S, H, D); cos/sin: (S, D // 2), broadcast over B and H."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(generator: torch.Generator, shape: tuple, dtype,
               fan_in: int | None = None) -> Tensor:
    """N(0, 1 / fan_in) weights drawn in float32 on ``generator``'s device,
    cast to ``dtype``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(fan_in ** -0.5).to(dtype)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """SwiGLU MLP: (silu(x W_gate) * (x W_up)) W_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
