"""Single-token GQA decode attention over a KV cache, ragged positions.

Replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention_kernel`` with
the hand-written CUDA kernel ``csrc/decode_attention.cu`` (see its header
for what bounds it and how the design answers).  It takes a ``(b,)``
``pos`` where the TPU kernel took a scalar, so continuous batching can
reuse it, and f32 or bf16 caches (the serving engine's cache dtype; the
arithmetic stays f32).  A CPU tensor runs the plain version
``decode_attention_ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

NAME = "decode_attention"
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_void_p])

plain = decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """q (b, h, dh) f32; caches (b, S, hkv, dh) f32 or bf16; ``pos`` an
    int or a (b,) int tensor -> (b, h, dh) f32.  Row r attends positions
    ``<= pos[r]``."""
    b, h, dh = q.shape
    _, S, hkv, _ = k_cache.shape
    if h % hkv or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != dh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, pos)
    if (h // hkv) * dh > 32 * 128:
        raise ValueError("decode_attention: needs (h // hkv) * dh <= 4096")
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=q.device, dtype=torch.int32).reshape(-1)
        pos_t = pos_t.expand(b).contiguous()
    else:
        pos_t = torch.full((b,), int(pos), dtype=torch.int32, device=q.device)
    _build.require_cuda(NAME, q, k_cache, v_cache, pos_t)
    if q.dtype != torch.float32 or k_cache.dtype != v_cache.dtype \
            or k_cache.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("decode_attention: needs f32 q and f32 or bf16 "
                         "caches of one dtype")
    out = torch.empty_like(q)
    fn = _build.launcher(NAME, "decode_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pos_t.data_ptr(), out.data_ptr(), b, S, h, hkv, dh,
             int(k_cache.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
             _build.stream_ptr(q.device))
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
