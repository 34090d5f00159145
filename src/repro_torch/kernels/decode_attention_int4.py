"""Single-token GQA decode attention over packed INT4 KV rows.

Replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention_int4_kernel``
with the hand-written CUDA kernel ``csrc/decode_attention_int4.cu`` (see
its header for what bounds it and how the design answers).  It reads the
KV store's packed row layout directly and dequantizes in registers; it
takes a ``(b,)`` ``pos``, and optionally the decode step's own K/V row,
which it attends unquantized at ``pos[r]`` after the packed rows
``< pos[r]`` (what both engines compute).  With ``cache_dtype``
bf16 every value is rounded to bf16 before use (the serving cache's
compute dtype).  ``q`` is f32 or bf16: the kernel widens a bf16 ``q``
as it loads and writes the output in ``q``'s dtype, as the TPU kernel
does, and widens bf16 fresh rows as it stages them; the arithmetic
stays f32.  A CPU tensor runs the plain version
``decode_attention_int4_ref``; a CUDA tensor launches the kernel or
raises; a meta tensor gets an empty output and reports the kernel's
operations and bytes (``kernels.cost``).  Its split of a row over the
cluster (``rank_runs``, over the packed rows and the fresh row) and its
step are ``decode_attention``'s (``csrc/decode_attention_common.cuh``),
so without a fresh row at f32 it equals ``decode_attention`` over the
dequantized cache bit for bit, and a row's output depends on nothing
outside that row.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.decode_attention import (CLUSTER, MAX_DH,
                                                  copy_bytes, live_rows,
                                                  pos_args, row_stride)
from repro_torch.kernels.ref import decode_attention_int4_ref

NAME = "decode_attention_int4"
_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float]
         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)   # q's and the fresh rows'

plain = decode_attention_int4_ref


def decode_attention_int4(q, k_packed, k_scale, v_packed, v_scale, pos, *,
                          hkv: int, group: int, k_new=None, v_new=None,
                          cache_dtype=torch.float32) -> torch.Tensor:
    """q (b, h, dh) f32 or bf16; packed K/V (b, S, hkv*dh//2) uint8
    with scales (b, S, hkv*dh//group) f32; ``pos`` an int or (b,) int
    tensor; optional fresh rows (b, hkv, dh) f32 or bf16 -> (b, h, dh)
    in q's dtype (module docstring).  q and the fresh rows may have any
    batch stride."""
    b, h, dh = q.shape
    _, S, F2 = k_packed.shape
    F = hkv * dh
    if (h % hkv or F2 * 2 != F or F % group
            or k_scale.shape != (b, S, F // group)
            or v_packed.shape != k_packed.shape
            or v_scale.shape != k_scale.shape or k_packed.shape[0] != b
            or (k_new is None) != (v_new is None)
            or (k_new is not None and (tuple(k_new.shape) != (b, hkv, dh)
                                       or v_new.shape != k_new.shape))):
        raise ValueError(
            f"decode_attention_int4: q {tuple(q.shape)}, packed "
            f"{tuple(k_packed.shape)} {tuple(v_packed.shape)}, scales "
            f"{tuple(k_scale.shape)} {tuple(v_scale.shape)}, hkv {hkv}, "
            f"group {group}, fresh rows "
            f"{None if k_new is None else tuple(k_new.shape)}")
    if cache_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention_int4: cache_dtype {cache_dtype}")
    if q.device.type == "cpu":
        return plain(q, k_packed, k_scale, v_packed, v_scale, pos, hkv=hkv,
                     group=group, k_new=k_new, v_new=v_new,
                     cache_dtype=cache_dtype)
    if (h // hkv > 32 or dh > MAX_DH or dh % 8 or group & (group - 1)
            or group < 8):
        raise ValueError(f"decode_attention_int4: needs h // hkv <= 32, dh "
                         f"a multiple of 8 up to {MAX_DH} and a power-of-two "
                         f"group of at least 8, got {h // hkv}, {dh}, "
                         f"{group}")
    has_new = k_new is not None
    if q.device.type == "meta":
        hist = live_rows(pos, b, S, has_new)
    pos_t, pos0 = pos_args(pos, b, q.device)
    if q.device.type != "meta":
        _build.require_cuda(NAME, k_packed, k_scale, v_packed, v_scale,
                            *(() if pos_t is None else (pos_t,)))
    for t in (q,) + ((k_new, v_new) if has_new else ()):
        if t.device != k_packed.device:
            raise ValueError(f"{NAME}: tensors on {t.device} and "
                             f"{k_packed.device}")
    if (q.dtype not in DTYPES
            or (has_new and (k_new.dtype not in DTYPES
                             or v_new.dtype != k_new.dtype))
            or (k_packed.dtype, v_packed.dtype, k_scale.dtype,
                v_scale.dtype) != (torch.uint8, torch.uint8, torch.float32,
                                   torch.float32)):
        raise ValueError(
            f"decode_attention_int4: needs an f32 or bf16 q, uint8 packed "
            f"rows, f32 scales and f32 or bf16 fresh rows of one dtype, got "
            f"q {q.dtype}, packed {k_packed.dtype} {v_packed.dtype}, scales "
            f"{k_scale.dtype} {v_scale.dtype}, fresh rows "
            f"{None if k_new is None else (k_new.dtype, v_new.dtype)}")
    if q.device.type == "meta":
        cost.report(NAME, cost.decode_attention_int4(
            b, h, hkv, dh, hist, group, has_new, q.element_size(),
            k_new.element_size() if has_new else 4),
            (tuple(q.shape), tuple(k_packed.shape)))
        return torch.empty((b, h, dh), dtype=q.dtype, device="meta")
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    _launch(q, k_packed, k_scale, v_packed, v_scale, pos_t, pos0, out,
            hkv=hkv, group=group, k_new=k_new, v_new=v_new,
            cache_dtype=cache_dtype)
    _build.count(NAME, q.dtype == torch.bfloat16)
    return out


def _launch(q, k_packed, k_scale, v_packed, v_scale, pos_t, pos0: int, out,
            *, hkv: int, group: int, k_new=None, v_new=None,
            cache_dtype=torch.float32, cluster: int = CLUSTER):
    """One launch of the kernel into ``out`` under a plan of ``cluster``
    ranks a row; checked, not counted."""
    b, h, dh = q.shape
    _, S, F2 = k_packed.shape
    has_new = k_new is not None
    cpy = copy_bytes(dh // 2, F2, k_packed.data_ptr(), v_packed.data_ptr())
    if not cpy:
        raise ValueError(f"{NAME}: packed rows and base addresses must be "
                         f"4-byte aligned, got dh {dh}, row {F2} bytes")
    kn_rs, vn_rs = ((row_stride(k_new, NAME + ": k_new"),
                     row_stride(v_new, NAME + ": v_new"))
                    if has_new else (0, 0))
    fn = _build.launcher(NAME, "decode_attention_int4_launch", _ARGS)
    err = fn(q.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(),
             v_packed.data_ptr(), v_scale.data_ptr(),
             None if pos_t is None else pos_t.data_ptr(),
             k_new.data_ptr() if has_new else None,
             v_new.data_ptr() if has_new else None, out.data_ptr(),
             b, S, h, hkv, dh, group.bit_length() - 1, int(has_new),
             int(q.dtype == torch.bfloat16),
             int(has_new and k_new.dtype == torch.bfloat16),
             int(cache_dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
             cluster, cpy, row_stride(q, NAME + ": q"), kn_rs,
             vn_rs, pos0, _build.stream_ptr(q.device))
    _build.check(NAME, err)
