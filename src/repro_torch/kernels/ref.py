"""Plain PyTorch versions of every kernel — the oracles the kernels are
held against on the card, and what the wrappers run for CPU tensors.

They mirror the JAX package's jnp code: ``ref_attention`` and
``attn_partials`` are ``models/attention.py``'s, the three ``*_ref``
functions are ``kernels/ref.py``'s (``decode_attention_ref`` also takes
a ragged ``(b,)`` ``pos``).  ``decode_attention_int4_ref`` is the INT4-KV
decode the engines compute: dequantize the packed history with the KV
store's codec, round to the cache dtype, write the step's fresh row at
``pos``, then ``decode_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.kvstore import _dequant_impl
from repro_torch.models.common import NEG_INF, finalize_partials
from repro_torch.quant.int4 import dequantize_int4


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """(sq, sk) boolean mask; True = attend."""
    dq = q_pos[:, None]
    dk = kv_pos[None, :]
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= dk <= dq
    if window:
        m &= dq - dk < window
    return m


def ref_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle attention.  q (b, sq, h, dh); k, v (b, sk, hkv, dv)."""
    b, sq, h, dh = q.shape
    _, sk, hkv, dv = v.shape
    g = h // hkv
    qr = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qr.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / math.sqrt(dh)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(sk, device=q.device)
    m = _mask(q_pos, kv_pos, causal, window)
    scores = torch.where(m, scores, torch.full((), NEG_INF,
                                               device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, dv)


def attn_partials(q, k, v, mask):
    """Online-softmax partials (m, l, o) in fp32 for one block.  mask:
    (sq, sk) or (b, sq, sk) bool or None.  Fully masked rows keep
    l = 0, o = 0."""
    b, sq, h, dh = q.shape
    _, sk, hkv, dv = v.shape
    g = h // hkv
    qr = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bshd->bhgqs", qr.to(torch.float32),
                     k.to(torch.float32))
    s = s / math.sqrt(dh)
    if mask is not None:
        mb = mask[None, None, None] if mask.ndim == 2 \
            else mask[:, None, None]
        s = torch.where(mb, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)                                # (b, hkv, g, sq)
    p = torch.exp(s - m[..., None])
    dead = m <= NEG_INF / 2
    p = torch.where(dead[..., None], torch.zeros((), device=q.device), p)
    m = torch.where(dead, torch.full((), NEG_INF, device=q.device), m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqs,bshd->bhgqd", p.to(v.dtype), v)
    return (m.reshape(b, h, sq), l.reshape(b, h, sq),
            o.to(torch.float32).reshape(b, h, sq, dv))


def int4_matmul_ref(x, packed, scale, group: int = 128):
    """x (M, K) @ dequant(packed (K, N//2), scale (K//G, N)) -> (M, N) f32."""
    w = dequantize_int4(packed, scale, torch.float32, group)
    return x.to(torch.float32) @ w


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """q (b, sq, h, dh), k/v (b, sk, hkv, dh) -> (b, sq, h, dh)."""
    return ref_attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def decode_attention_ref(q, k_cache, v_cache, pos):
    """q (b, h, dh); caches (b, S, hkv, dh); ``pos`` an int or a (b,)
    int tensor: row r attends positions ``<= pos[r]``.  The decode
    model path's arithmetic: ``attn_partials`` then finalize."""
    b, S = k_cache.shape[:2]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    kv_pos = torch.arange(S, device=q.device)
    valid = (kv_pos[None, :] <= pos[:, None])[:, None, :]     # (b, 1, S)
    m, l, o = attn_partials(q[:, None], k_cache, v_cache, valid)
    return finalize_partials(m, l, o)[:, :, 0].to(q.dtype)   # (b, h, dh)


def decode_attention_int4_ref(q, k_packed, k_scale, v_packed, v_scale, pos,
                              *, hkv: int, group: int, k_new=None,
                              v_new=None, cache_dtype=torch.float32):
    """q (b, h, dh); packed history (b, S, F//2) uint8 with scales
    (b, S, F//group) f32, F = hkv * dh; ``pos`` an int or (b,) tensor.
    Without a fresh row, row r attends packed positions ``<= pos[r]``;
    with ``k_new``/``v_new`` (b, hkv, dh) it attends positions
    ``< pos[r]`` and the fresh row at ``pos[r]``.  Dequantized values and
    the fresh row are cast to ``cache_dtype`` first."""
    b, h, dh = q.shape
    S = k_packed.shape[1]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    kc, vc = (_dequant_impl(p, s, group).reshape(b, S, hkv, dh)
              .to(cache_dtype) for p, s in ((k_packed, k_scale),
                                            (v_packed, v_scale)))
    if k_new is not None:
        need = int(pos.max()) + 1
        if need > S:                          # room for the fresh row
            pad = (0, 0, 0, 0, 0, need - S)
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
        rows = torch.arange(b, device=q.device)
        kc[rows, pos.long()] = k_new.to(cache_dtype)
        vc[rows, pos.long()] = v_new.to(cache_dtype)
    return decode_attention_ref(q, kc, vc, pos)
