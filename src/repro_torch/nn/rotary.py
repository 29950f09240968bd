"""Rotary position embeddings (RoPE), theta-configurable.

``theta <= 0`` disables rotary.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)  # (head_dim/2,)


def apply_rotary(x, positions, theta: float):
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S), e.g.
    (S,) for a sequence or (B, 1) for per-row decode positions."""
    if theta is None or theta <= 0:
        return x
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions.float()[..., None] * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
