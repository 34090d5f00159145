"""Gradient compression for a data-parallel reduction over a slow link
(the JAX package's ``runtime/compression.py``).

Symmetric per-tensor int8 quantization with error feedback: each round's
residual is added back before the next quantization, so the long-run
bias vanishes while the reduction moves 4x fewer bytes.  The collective
that would carry the int8 values waits for the sharding slice; the codec
here is bit-equal to the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map

F32 = torch.float32


def compress_int8(x: torch.Tensor):
    """x (any shape) -> (int8 values, f32 scale): ``scale = max(max|x| /
    127, 1e-12)``, values ``round(x / scale)`` (half to even) clipped to
    [-127, 127]."""
    m = torch.max(torch.abs(x)).to(F32)
    scale = torch.clamp_min(m / 127.0, 1e-12)
    q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale, dtype=F32) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


class Int8(NamedTuple):
    """One compressed leaf (a leaf of the port's trees, where plain
    tuples are containers)."""
    q: torch.Tensor
    scale: torch.Tensor


class ErrorFeedbackCompressor:
    """Per-leaf error feedback around ``compress_int8``:

        comp, residuals = ef.compress(grads, residuals)
        # the reduction carries comp (int8 values, f32 scales) ...
        grads = ef.decompress(comp)
    """

    def init(self, grads: Any):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                              device=g.device), grads)

    def compress(self, grads: Any, residuals: Any):
        def one(g, r):
            x = g.to(F32) + r
            q, s = compress_int8(x)
            return Int8(q, s), x - decompress_int8(q, s)
        pairs = tree_map(one, grads, residuals)
        comp = tree_map(lambda g, p: p[0], grads, pairs)
        new_r = tree_map(lambda g, p: p[1], grads, pairs)
        return comp, new_r

    def decompress(self, comp: Any, dtype=F32):
        return tree_map(lambda qs: decompress_int8(*qs, dtype=dtype), comp)
