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
ROWS = 16                        # query rows per warp (the kernel's ROWS)
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

plain = flash_attention_ref


def flash_plan(b: int, sq: int, h: int, hkv: int):
    """(warps per block, blocks): a warp owns ``ROWS`` query rows of one
    head; the warps of a block are heads of one kv group at the same
    rows and share each K/V tile.  The most warps (at most 4) that
    divide the group: on the H100 four warps per block beat one and two
    at every main-path shape, the serving prefill ones too, where one
    warp per block gives four times the blocks (``tools/flash_phases.py``;
    PERF.md)."""
    g = h // hkv
    w = next(w for w in (4, 2, 1) if g % w == 0)
    return w, b * hkv * -(-sq // ROWS) * (g // w)


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
    if dh > 128 or dh % 4:
        raise ValueError(f"flash_attention: needs head_dim <= 128 and a "
                         f"multiple of 4, got {dh}")
    _build.require_cuda(NAME, q, k, v)
    if {q.dtype, k.dtype, v.dtype} != {torch.float32}:
        raise ValueError("flash_attention: needs f32 q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    warps, _ = flash_plan(b, sq, h, hkv)
    fn = _build.launcher(NAME, "flash_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, hkv, dh, int(causal), int(window), int(q_offset),
             1.0 / math.sqrt(dh), warps, _build.stream_ptr(q.device))
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    if q_offset > 0:
        _build.LAUNCHES[_build.Q_OFFSET] += 1
    return out
