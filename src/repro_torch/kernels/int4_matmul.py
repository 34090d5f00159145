"""Fused INT4-dequant matmul: ``x (M, K) @ dequant(packed, scale)``.

Replaces the TPU kernel ``src/repro/kernels/int4_matmul.py:int4_matmul``
with the hand-written CUDA kernel ``csrc/int4_matmul.cu`` (see its header
for what bounds it and how the design answers).  ``x`` is f32 or bf16,
and the output has x's dtype, as the TPU kernel takes "x (M, K)
bf16/f32" and writes ``out_dtype``: the bf16 instance reads bf16 x and
writes bf16 itself.  Its GEMV (M <= ``SMALL_M``) runs the f32
instance's arithmetic on the widened x, so it gives what widening x, the
f32 instance and a cast back give, bit for bit; above, it runs bf16
``wgmma`` on the exact bf16 nibbles (a group a multiple of 16), within
one bf16 ulp of that recipe.  A CPU tensor runs the plain version ``int4_matmul_ref`` (its f32
output cast to x's dtype); a CUDA tensor launches the kernel or
raises; a meta tensor (the roofline counter's trace) gets an empty
output and reports the kernel's operations and bytes (``kernels.cost``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import int4_matmul_ref

NAME = "int4_matmul"
SMALL_M = 16                     # <= this: the split-K matrix-vector path
MAX_CLUSTER = 8                  # blocks per cluster (the portable limit)
_GV_MT, _GV_LB = 4, 8            # small M: x rows per block, bytes per lane
_GV_WARPS = 8                    # small M: warps per block
_TB_M, _TB_N = 64, 128           # prefill: output tile (f32 x)
SMEM_MAX = 232448                # shared memory a block may use (H100)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
DTYPES = (torch.float32, torch.bfloat16)   # x's instances

plain = int4_matmul_ref


def fill(n_sms: int) -> int:
    """Blocks that count as filling the card: about one per SM."""
    return -(-95 * n_sms // 100)


def _whole_groups(n_groups: int, splits: int):
    """(splits, groups per split) covering every group, none empty."""
    gps = -(-n_groups // max(1, min(splits, n_groups)))
    return -(-n_groups // gps), gps


def decode_smem(group: int, lg_tpr: int, gps: int) -> int:
    """Shared memory of a small-M block (``csrc/int4_matmul.cu``
    gv_smem): its slice of packed rows, x and scales, and the sums."""
    cb = _GV_LB << lg_tpr
    nkp = gps * group
    return nkp * cb + 4 * (_GV_MT * nkp + gps * 2 * cb
                           + (_GV_WARPS + 1) * _GV_MT * 2 * cb + 8)


def decode_plan(M: int, K: int, N: int, group: int, n_sms: int):
    """(lg_tpr, splits, gps) for the small-M path: K split in whole groups
    over a cluster of at most ``MAX_CLUSTER`` blocks, and column tiles of
    2**lg_tpr * 8 packed bytes (at most 128), the widest that still gives
    a block to about every other SM and whose slice fits in shared
    memory.  (Filling every SM is slower on the H100: clusters of 8 then
    put two blocks on some SMs, and the launch waits for those.)"""
    splits, gps = _whole_groups(K // group, MAX_CLUSTER)
    m_chunks = -(-M // _GV_MT)
    for lg in range(4, -1, -1):        # wider tiles leave one block an SM
        if (-(-(N // 2) // (_GV_LB << lg)) * splits * m_chunks
                >= fill(n_sms) // 2
                and decode_smem(group, lg, gps) <= SMEM_MAX):
            break
    if decode_smem(group, lg, gps) > SMEM_MAX:
        raise ValueError(f"int4_matmul: K={K} is too deep for the small-M "
                         f"path's shared memory")
    return lg, splits, gps


def prefill_plan(M: int, K: int, N: int, group: int, n_sms: int):
    """(splits, gps) for the tensor-core path: 64 x 128 output tiles, K
    split in whole groups (a cluster of at most 8 blocks) until the grid
    holds about two blocks per SM (a block's shared memory lets two share
    an SM, which hides the copies' latency).  The bf16 path (tiles of 64
    or 128 rows x 128) takes the same split, so its f32 sums follow the f32
    instance's partition of K and differ from widening x, the f32
    instance and a cast back only inside a k16 step."""
    n_groups = K // group
    tiles = -(-N // _TB_N) * -(-M // _TB_M)
    splits = 1
    while (splits < MAX_CLUSTER and 2 * splits <= n_groups
           and tiles * splits < 2 * fill(n_sms)):
        splits *= 2
    return _whole_groups(n_groups, splits)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                *, group: int = 128) -> torch.Tensor:
    """x (M, K) f32 or bf16 @ W -> (M, N) in x's dtype with W =
    dequant(packed (K, N//2) uint8, scale (K//group, N) f32).  Any M;
    K % group == 0, and on the card a power-of-two group when M <=
    SMALL_M, group % 8 == 0 above (group % 16 == 0 for bf16 x)."""
    M, K = x.shape
    Kp, N2 = packed.shape
    N = 2 * N2
    if Kp != K or K % group or scale.shape != (K // group, N):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)}"
                         f", group {group}")
    if x.device.type == "cpu":
        return plain(x, packed, scale, group).to(x.dtype)
    if x.device.type != "meta":
        _build.require_cuda(NAME, x, packed, scale)
    if (x.dtype not in DTYPES
            or (packed.dtype, scale.dtype) != (torch.uint8, torch.float32)):
        raise ValueError(f"int4_matmul: needs f32 or bf16 x, uint8 packed, "
                         f"f32 scale, got {x.dtype}, {packed.dtype}, "
                         f"{scale.dtype}")
    if x.device.type == "meta":
        cost.report(NAME, cost.int4_matmul(M, K, N, group, x.element_size()),
                    (tuple(x.shape), tuple(packed.shape)))
        return torch.empty((M, N), dtype=x.dtype, device="meta")
    n_sms = _build.num_sms(x.device.index)
    epc = 16 // x.element_size()       # x elements per 16-byte copy
    xa = x.data_ptr() % 16 == 0
    if M <= SMALL_M:
        if group & (group - 1):
            raise ValueError(f"int4_matmul: the small-M path needs a "
                             f"power-of-two group, got {group}")
        lg, splits, gps = decode_plan(M, K, N, group, n_sms)
        chunk = 16 if lg else 8
        flags = (int(N2 % chunk == 0 and packed.data_ptr() % chunk == 0)
                 | 2 * int(K % epc == 0 and group % epc == 0 and xa)
                 | 4 * int(N % 4 == 0 and scale.data_ptr() % 16 == 0))
    else:
        step = 16 if x.dtype == torch.bfloat16 else 8
        if group % step:
            raise ValueError(f"int4_matmul: the {str(x.dtype)[6:]} "
                             f"tensor-core path needs group % {step} == 0, "
                             f"got {group}")
        if not xa:
            x = x.clone()
        lg = 0
        splits, gps = prefill_plan(M, K, N, group, n_sms)
        flags = 8 * int(N2 % 16 == 0 and packed.data_ptr() % 16 == 0)
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.launcher(NAME, "int4_matmul_launch", _ARGS)
    err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
             out.data_ptr(), M, K, N, group, lg, splits, gps, flags,
             int(bf16), _build.stream_ptr(x.device))
    _build.check(NAME, err)
    _build.count(NAME, bf16)
    return out
