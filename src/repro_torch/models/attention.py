"""Attention for the port's model path.

``ref_attention`` and ``attn_partials`` are the plain oracles (defined in
``kernels/ref.py`` beside the kernels' other plain versions).
``decode_attention`` is the single-shard decode step of the JAX
package's ``models/attention.py``: write the step's new K/V row at
``pos`` (a scalar or a ragged ``(b,)`` tensor), then attend through the
kernel dispatch.  ``decode_attention_packed`` is the same step over a
``kv_mode="int4"`` history that stays packed (``kvstore.PackedRows``):
the fresh row is not quantized before it is attended, as in the
reference, which writes it into its dequantized cache.
``chunk_prefill_attention`` is a prefill chunk's attention over the
engine-held prefix (``flash_attention`` with ``q_offset``).  Layout
BSHD: q (b, sq, h, dh), k/v (b, sk, hkv, dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import attn_partials, ref_attention

__all__ = ["ref_attention", "attn_partials", "decode_attention",
           "decode_attention_packed", "chunk_prefill_attention"]


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
    out = ops.decode_attention_op(q[:, 0], k_cache, v_cache, pos)
    return out[:, None], k_cache, v_cache


def decode_attention_packed(q, k_rows, v_rows, k_new, v_new, pos):
    """q (b, 1, h, dh); ``k_rows``/``v_rows`` ``PackedRows`` of the history
    (b, S, F//2); k_new/v_new (b, 1, hkv, dh); pos: int or (b,) tensor.
    Row r attends the packed rows ``< pos[r]`` and its fresh row at
    ``pos[r]``, every value at the rows' compute dtype.  Returns
    (b, 1, h, dh)."""
    hkv = k_new.shape[2]
    out = ops.decode_attention_int4_op(
        q[:, 0], k_rows.packed, k_rows.scale, v_rows.packed, v_rows.scale,
        pos, hkv=hkv, group=k_rows.group, k_new=k_new[:, 0],
        v_new=v_new[:, 0], cache_dtype=k_rows.dtype)
    return out[:, None]


def chunk_prefill_attention(q, k, v, *, q_offset: int):
    """Prefill-chunk attention: the chunk's queries (global positions
    ``q_offset .. q_offset+sq-1``) attend causally over the running
    prefix ``k``/``v`` (``sk = q_offset + sq`` rows: the engine-held K/V
    of earlier chunks, then the chunk's own).  Each query row sees
    exactly the columns a monolithic prefill leaves unmasked for it.
    q (b, sq, h, dh), k/v (b, sk, hkv, dh) -> (b, sq, h, dh)."""
    return ops.flash_attention_op(q, k, v, causal=True, q_offset=q_offset)
