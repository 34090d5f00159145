"""Blocked causal GQA flash attention with ``window`` and ``q_offset``.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` with the hand-written CUDA kernel
``csrc/flash_attention.cu`` (see its header for what bounds it and how
the design answers).  Arbitrary ``sq``/``sk``; rows with nothing to
attend output 0.  q, k and v are all f32 or all bf16, and the output
has their dtype.  The bf16 instance computes what the TPU kernel
computes at bf16: both products on bf16 tensor cores with f32
accumulation, the unnormalised P rounded to bf16 before P.V; it takes a
head_dim that is a multiple of 16 (the f32 instance a multiple of 4),
up to ``MAX_DH``.  A CPU tensor runs the plain version
``flash_attention_ref``; a CUDA tensor launches the kernel or raises;
a meta tensor gets an empty output and reports the kernel's operations
and bytes (``kernels.cost``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import flash_attention_ref

NAME = "flash_attention"
ROWS = 16                        # query rows per warp (the kernel's ROWS)
MAX_DH = 256                     # the widest head the kernel takes (Gemma 3)
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
DH_STEP = {torch.float32: 4, torch.bfloat16: 16}   # head_dim step by dtype

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
    step = DH_STEP.get(q.dtype)
    if step is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: needs q, k, v all f32 or all "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh > MAX_DH or dh % step:
        raise ValueError(f"flash_attention: the {str(q.dtype)[6:]} kernel "
                         f"needs a head_dim <= {MAX_DH} and a multiple of "
                         f"{step}, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.device.type != "meta":
        _build.require_cuda(NAME, q, k, v)
    if q.device.type == "meta":
        cost.report(NAME, cost.flash_attention(
            b, sq, sk, h, hkv, dh, causal, window, q_offset,
            q.element_size()), (tuple(q.shape), tuple(k.shape)))
        return torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    warps, _ = flash_plan(b, sq, h, hkv)
    fn = _build.launcher(NAME, "flash_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, hkv, dh, int(causal), int(window), int(q_offset),
             1.0 / math.sqrt(dh), warps, int(q.dtype == torch.bfloat16),
             _build.stream_ptr(q.device))
    _build.check(NAME, err)
    _build.count(NAME, q.dtype == torch.bfloat16)
    if q_offset > 0:
        _build.LAUNCHES[_build.Q_OFFSET] += 1
    return out
