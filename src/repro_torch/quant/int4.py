"""Groupwise symmetric INT4 quantization (paper §3.4 / W4 weights).

The JAX package's ``quant/int4.py`` layout, bit for bit:

  * groups of G=128 along the contraction dim K;
  * scales: (K//G, N) float32 with s = max|w_group| / 7 (floored at 1e-8);
  * values: q = clip(round(w / s), -8, 7) with round half to even, two
    nibbles per uint8 along *column pairs* -> packed (K, N//2): column 2j
    in the low nibble, column 2j+1 in the high nibble.

``kernels/int4_matmul.py`` consumes this layout and unpacks the nibbles
in registers, so packed bytes are the only weight traffic.
"""
from __future__ import annotations

import math

import torch

GROUP = 128


def quantize_int4(w: torch.Tensor, group: int = GROUP):
    """w (K, N) -> (packed (K, N//2) uint8, scales (K//group, N) f32).
    Runs on ``w``'s device."""
    K, N = w.shape
    if K % group or N % 2:
        raise ValueError(f"quantize_int4 needs K % group == 0 and an even "
                         f"N, got K={K} N={N} group={group}")
    wg = w.to(torch.float32).reshape(K // group, group, N)
    scale = wg.abs().amax(dim=1) / 7.0                    # (K//group, N)
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.round(wg / scale[:, None, :]).to(torch.int32)
    q = torch.clamp(q, -8, 7).reshape(K, N)
    return pack_int4(q), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7], shape (K, N) -> uint8 (K, N//2)."""
    qu = (q + 8).to(torch.uint8)                          # [0, 15]
    return qu[:, 0::2] | (qu[:, 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (K, N//2) -> int32 (K, N) in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = ((packed >> 4) & 0xF).to(torch.int32) - 8
    K, N2 = packed.shape
    return torch.stack([lo, hi], dim=-1).reshape(K, N2 * 2)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32, group: int = GROUP) -> torch.Tensor:
    """Inverse of quantize_int4 -> (K, N) dtype."""
    q = unpack_int4(packed)                               # (K, N)
    K, N = q.shape
    w = q.reshape(K // group, group, N).to(torch.float32) \
        * scale[:, None, :]
    return w.reshape(K, N).to(dtype)


def stack_group(K: int) -> int:
    """Group size for a stacked matrix with contraction dim ``K``:
    ``gcd(K, 128)`` always divides K."""
    return math.gcd(int(K), GROUP)
