"""Rotary position embeddings (the JAX package's ``models/rope.py``, 1-D
RoPE only)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., s) int -> angles (..., s, head_dim // 2) f32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., s, n_heads, head_dim), angles broadcastable (..., s, half):
    rotate-half form."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
