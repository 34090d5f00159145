"""Shared model numerics: norms, activation, online-softmax partials.

The port of the single-device parts of the JAX package's
``models/common.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in the ``1 + scale`` form (a zero scale is the identity
    gain)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Online-softmax partials (m, l, o): m = running max of scores, l = sum
# exp(score - m), o = sum exp(..) * v (o unnormalized).
# ---------------------------------------------------------------------------

def merge_partials(a, b):
    m_a, l_a, o_a = a
    m_b, l_b, o_b = b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    l = l_a * ca + l_b * cb
    o = o_a * ca[..., None] + o_b * cb[..., None]
    return m, l, o


def finalize_partials(m, l, o):
    return o / torch.clamp_min(l, 1e-30)[..., None]
