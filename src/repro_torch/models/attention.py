"""Attention for the port's model path.

``ref_attention`` and ``attn_partials`` are the plain oracles (defined in
``kernels/ref.py`` beside the kernels' other plain versions).
``decode_attention`` is the single-shard decode step of the JAX
package's ``models/attention.py``: write the step's new K/V row at
``pos`` (a scalar or a ragged ``(b,)`` tensor), then attend through the
kernel dispatch.  Layout BSHD: q (b, sq, h, dh), k/v (b, sk, hkv, dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import attn_partials, ref_attention

__all__ = ["ref_attention", "attn_partials", "decode_attention"]


def decode_attention(q, k_cache, v_cache, k_new, v_new, pos):
    """q (b, 1, h, dh); caches (b, S, hkv, dh); k_new/v_new (b, 1, hkv,
    dh); pos: int OR (b,) int tensor of ragged positions (each row writes
    and attends its own position).  Returns (out (b, 1, h, dh), k_cache,
    v_cache).  The caches are updated IN PLACE (the JAX package returns
    functionally updated copies; the port saves a cache-sized copy per
    layer and step)."""
    b = k_cache.shape[0]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        rows = torch.arange(b, device=k_cache.device)
        p = pos.to(device=k_cache.device, dtype=torch.long)
        k_cache[rows, p] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, p] = v_new[:, 0].to(v_cache.dtype)
    else:
        k_cache[:, int(pos)] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, int(pos)] = v_new[:, 0].to(v_cache.dtype)
    out = ops.decode_attention_op(q[:, 0].contiguous(), k_cache, v_cache, pos)
    return out[:, None], k_cache, v_cache
