"""Blocked causal GQA flash attention with ``window`` and ``q_offset``.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` with the hand-written CUDA kernel
``csrc/flash_attention.cu`` (see its header for what bounds it and how
the design answers).  Arbitrary ``sq``/``sk``; rows with nothing to
attend output 0.  A CPU tensor runs the plain version
``flash_attention_ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

NAME = "flash_attention"
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
         + [ctypes.c_float, ctypes.c_void_p])

plain = flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (b, sq, h, dh); k/v (b, sk, hkv, dh) -> (b, sq, h, dh)."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    if h % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window,
                     q_offset=q_offset)
    if dh > 128:
        raise ValueError("flash_attention: needs head_dim <= 128")
    _build.require_cuda(NAME, q, k, v)
    if {q.dtype, k.dtype, v.dtype} != {torch.float32}:
        raise ValueError("flash_attention: needs f32 q, k, v")
    out = torch.empty_like(q)
    fn = _build.launcher(NAME, "flash_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, hkv, dh, int(causal), int(window), int(q_offset),
             1.0 / math.sqrt(dh), _build.stream_ptr(q.device))
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
