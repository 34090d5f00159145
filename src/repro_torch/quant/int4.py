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

from repro_torch.tree import flatten_with_path, unflatten

GROUP = 128


def quantize_int4(w: torch.Tensor, group: int = GROUP):
    """w (K, N) -> (packed (K, N//2) uint8, scales (K//group, N) f32).
    Runs on ``w``'s device."""
    K, N = w.shape
    if K % group or N % 2:
        raise ValueError(f"quantize_int4 needs K % group == 0 and an even "
                         f"N, got K={K} N={N} group={group}")
    wg = w.to(torch.float32).reshape(K // group, group, N)
    # divide by a tensor on w's device: PyTorch's CUDA division by a
    # Python number multiplies by its f32 reciprocal, which rounds
    # otherwise than the CPU's (and the reference's) true division
    seven = torch.tensor(7.0, dtype=torch.float32, device=w.device)
    scale = wg.abs().amax(dim=1) / seven                  # (K//group, N)
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


def stack_eligible(shape) -> bool:
    """Whether a stacked weight (..., K, N) packs as INT4: at least one
    stack axis, an even N (nibble pairs), and a group of >= 16 along K
    (smaller groups spend more scale bytes than they save)."""
    return (len(shape) >= 3 and shape[-1] % 2 == 0
            and stack_group(shape[-2]) >= 16)


def quantize_int4_stack(w: torch.Tensor, group: int = 0):
    """w (..., K, N) -> (packed (..., K, N//2) uint8, scale (..., K//g, N)
    f32): ``quantize_int4`` on every (K, N) slice of the stack axes, so
    each slice carries exactly the 2-D layout and ``int4_matmul`` takes
    it as it is.  ``group`` defaults to ``stack_group(K)``."""
    g = group or stack_group(w.shape[-2])
    lead = tuple(w.shape[:-2])
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    pairs = [quantize_int4(s, g) for s in flat]
    packed = torch.stack([p for p, _ in pairs])
    scale = torch.stack([s for _, s in pairs])
    return (packed.reshape(lead + tuple(packed.shape[1:])),
            scale.reshape(lead + tuple(scale.shape[1:])))


def dequantize_int4_stack(packed: torch.Tensor, scale: torch.Tensor,
                          dtype=torch.float32, group: int = 0):
    """Inverse of ``quantize_int4_stack`` -> (..., K, N) ``dtype``; the
    group is inferable from the shapes (``K // scale.shape[-2]``)."""
    g = group or packed.shape[-2] // scale.shape[-2]
    lead = tuple(packed.shape[:-2])
    fp = packed.reshape((-1,) + tuple(packed.shape[-2:]))
    fs = scale.reshape((-1,) + tuple(scale.shape[-2:]))
    w = torch.stack([dequantize_int4(p, s, dtype, g) for p, s in zip(fp, fs)])
    return w.reshape(lead + tuple(w.shape[1:]))


def quantize_tree(params, min_size: int = 1 << 16, group: int = GROUP):
    """Quantize every 2-D leaf with K divisible by ``group``, an even N
    and at least ``min_size`` elements; returns (the tree with each such
    leaf replaced by ``{"packed", "scale"}``, the set of their paths,
    ``/``-joined dict keys and sequence indices as in
    ``repro_torch.tree``)."""
    quantized, out = set(), []
    for path, leaf in flatten_with_path(params):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim == 2
                and leaf.shape[0] % group == 0 and leaf.shape[1] % 2 == 0
                and leaf.numel() >= min_size):
            packed, scale = quantize_int4(leaf, group)
            out.append({"packed": packed, "scale": scale})
            quantized.add(path)
        else:
            out.append(leaf)
    return unflatten(params, out), quantized
