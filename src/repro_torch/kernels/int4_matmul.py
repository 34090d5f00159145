"""Fused INT4-dequant matmul: ``x (M, K) @ dequant(packed, scale)``.

Replaces the TPU kernel ``src/repro/kernels/int4_matmul.py:int4_matmul``
with the hand-written CUDA kernel ``csrc/int4_matmul.cu`` (see its header
for what bounds it and how the design answers).  A CPU tensor runs the
plain version ``int4_matmul_ref``; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int4_matmul_ref

NAME = "int4_matmul"
SMALL_M = 16                     # <= this: the split-K matrix-vector path
_GV_COLS, _GV_MT = 256, 4        # columns / x rows per small-M block
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

plain = int4_matmul_ref


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(M: int, K: int, N: int, group: int, n_sms: int):
    """(splits, groups_per_split) for the small-M path: split K in whole
    groups until the grid holds about two blocks per SM."""
    n_groups = K // group
    blocks = -(-N // _GV_COLS) * -(-M // _GV_MT)
    want = max(1, -(-2 * n_sms // blocks))
    gps = -(-n_groups // min(n_groups, want))
    return -(-n_groups // gps), gps


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                *, group: int = 128) -> torch.Tensor:
    """x (M, K) f32 @ W -> (M, N) f32 with W = dequant(packed (K, N//2)
    uint8, scale (K//group, N) f32).  Any M; K % group == 0."""
    M, K = x.shape
    Kp, N2 = packed.shape
    N = 2 * N2
    if Kp != K or K % group or scale.shape != (K // group, N):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)}"
                         f", group {group}")
    if x.device.type == "cpu":
        return plain(x, packed, scale, group)
    _build.require_cuda(NAME, x, packed, scale)
    if (x.dtype, packed.dtype, scale.dtype) != (torch.float32, torch.uint8,
                                                torch.float32):
        raise ValueError("int4_matmul: needs f32 x, uint8 packed, f32 scale")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    splits, gps = 1, K // group
    partial = out
    if M <= SMALL_M:
        splits, gps = split_plan(M, K, N, group, _num_sms(x.device.index))
        if splits > 1:
            partial = torch.empty((splits, M, N), dtype=torch.float32,
                                  device=x.device)
    vec = int(N2 % 4 == 0 and packed.data_ptr() % 4 == 0)
    fn = _build.launcher(NAME, "int4_matmul_launch", _ARGS)
    err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
             out.data_ptr(), partial.data_ptr(), M, K, N, group, splits, gps,
             vec, _build.stream_ptr(x.device))
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
