"""Rotary position embeddings: standard RoPE, Qwen2-VL M-RoPE, sinusoidal
(the JAX package's ``models/rope.py``).

M-RoPE [arXiv:2409.12191]: the head_dim/2 frequency slots are split into
(t, h, w) sections, each rotated by its own position component.  The
text-only stub gives all three components the token index, where M-RoPE
equals 1-D RoPE bit for bit.  Whisper's decoder and encoder add
sinusoidal positions to their inputs instead (``sinusoidal_rows``).
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections=()) -> torch.Tensor:
    """positions (..., s) int, or (3, ..., s) with ``mrope_sections`` ->
    angles (..., s, head_dim // 2) f32.  Section i's frequency slots
    rotate by ``positions[i]``."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    if not mrope_sections:
        return positions[..., None].to(torch.float32) * freqs
    if positions.ndim < 2 or positions.shape[0] != len(mrope_sections):
        raise ValueError(f"M-RoPE takes ({len(mrope_sections)}, ..., s) "
                         f"positions, got {tuple(positions.shape)}")
    if sum(mrope_sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do not "
                         f"cover head_dim // 2 = {head_dim // 2}")
    parts, start = [], 0
    for i, sec in enumerate(mrope_sections):
        parts.append(positions[i][..., None].to(torch.float32)
                     * freqs[start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., s, n_heads, head_dim), angles broadcastable (..., s, half):
    rotate-half form."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoidal_rows(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """The rows of the sinusoidal table at integer ``positions`` (any
    shape) -> (*positions.shape, d_model) f32: ``sin`` in the even
    columns, ``cos`` in the odd ones, of ``pos / 10000^(2i / d_model)``.
    Row p equals row p of ``sinusoidal_positions(n, d_model)`` for any
    n > p: a decode step computes its own rows in place of the
    reference's ``max_seq_len`` table."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)
    angle = pos / torch.pow(10000.0, dim / d_model)
    out = torch.empty(tuple(positions.shape) + (d_model,),
                      dtype=torch.float32, device=positions.device)
    out[..., 0::2] = torch.sin(angle)
    out[..., 1::2] = torch.cos(angle)
    return out


def sinusoidal_positions(seq_len: int, d_model: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """The (seq_len, d_model) sinusoidal table."""
    return sinusoidal_rows(torch.arange(seq_len, device=device),
                           d_model).to(dtype)
