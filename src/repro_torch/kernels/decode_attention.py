"""Single-token GQA decode attention over a KV cache, ragged positions.

Replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention_kernel`` with
the hand-written CUDA kernel ``csrc/decode_attention.cu`` (see its header
for what bounds it and how the design answers).  It takes a ``(b,)``
``pos`` where the TPU kernel took a scalar, so continuous batching can
reuse it, f32 or bf16 caches (the serving engine's cache dtype) and an
f32 or bf16 ``q``, which the kernel widens as it loads and whose dtype
it writes the output in, as the TPU kernel does; the arithmetic stays
f32, so a bf16 ``q`` gives what widening it, the f32 instance and a cast
back give, bit for bit.  An int ``pos`` goes to the kernel as an argument
and ``q`` may have any batch stride, so a call launches nothing but the
kernel.  A CPU tensor runs the plain version ``decode_attention_ref``; a
CUDA tensor launches the kernel or raises; a meta tensor gets an empty
output and reports the kernel's operations and bytes (``kernels.cost``).

The split of a row over its cluster (``rank_runs``) and the host-side
argument helpers are shared with ``decode_attention_int4``, whose kernel
runs the same step (``csrc/decode_attention_common.cuh``): each row's
live positions in tiles of ``TILE``, whole tiles a rank, the number of
ranks a function of the row's live positions alone, so a row's output
depends on nothing outside that row.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import decode_attention_ref

NAME = "decode_attention"
TILE = 32                        # positions per tile (the kernels' TILE)
CLUSTER = 16                     # the plan's ranks per (row, kv head)
MAX_DH = 256                     # 8 output features per lane (the kernels')
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
         + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)   # q's and the caches' instances

plain = decode_attention_ref


def rank_runs(n: int, cluster: int = CLUSTER):
    """[(first, stop)] positions of each rank that reads any, in rank
    order: a row's ``n`` live positions fall into ``ceil(n / TILE)``
    tiles, ``min(cluster, tiles)`` ranks take a run of whole tiles each,
    the first ``tiles % ranks`` of them one more (the kernels'
    ``rank_run``).  A function of ``n`` alone: never of the batch, the
    slab length or the other rows."""
    tiles = -(-n // TILE)
    used = min(cluster, tiles)
    if used == 0:
        return []
    base, rem = divmod(tiles, used)
    runs, t = [], 0
    for c in range(used):
        k = base + (c < rem)
        runs.append((t * TILE, min((t + k) * TILE, n)))
        t += k
    return runs


def row_len(pos: int, S: int, fresh: bool = False) -> int:
    """A row's live positions as the kernels count them: ``pos + 1``
    cached rows (at most ``S``), or with a fresh row the cached rows
    ``< pos`` (at most ``S``) and the fresh one."""
    return max(0, min(pos, S)) + 1 if fresh else max(0, min(pos + 1, S))


def row_stride(t: torch.Tensor, name: str) -> int:
    """Batch stride of a (b, n, dh) tensor whose rows are contiguous."""
    if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
        raise ValueError(f"{name} needs contiguous (heads, dh) rows, "
                         f"strides {t.stride()}")
    return t.stride(0)


def pos_args(pos, b: int, device: torch.device):
    """(pos tensor or None, pos0): an int stays a kernel argument; a
    tensor becomes a (b,) int32 tensor on ``device`` (as it is if it is
    one already)."""
    if not isinstance(pos, torch.Tensor):
        return None, int(pos)
    if (pos.dtype == torch.int32 and pos.device == device
            and pos.shape == (b,) and pos.is_contiguous()):
        return pos, 0
    pos_t = pos.to(device=device, dtype=torch.int32).reshape(-1)
    return pos_t.expand(b).contiguous(), 0


def live_rows(pos, b: int, S: int, fresh: bool = False) -> int:
    """Cached rows a decode call reads over the batch: ``pos`` (or
    ``pos + 1`` without a fresh row) a row, at most ``S``; every row of
    the slab where ``pos`` is a tensor on meta, whose values no one can
    read."""
    extra = 0 if fresh else 1
    if not isinstance(pos, torch.Tensor):
        return b * min(int(pos) + extra, S)
    if pos.device.type == "meta":
        return b * S
    p = pos.reshape(-1).expand(b).to("cpu", torch.int64)
    return int(torch.clamp(p + extra, max=S).sum())


def copy_bytes(*sizes: int) -> int:
    """Bytes per ``cp.async`` copy: the most of 16, 8 and 4 that divides
    every size and address given (a row's bytes, the row stride's, the
    base pointers); 0 where none does."""
    return next((n for n in (16, 8, 4) if all(x % n == 0 for x in sizes)),
                0)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """q (b, h, dh) f32 or bf16 (any batch stride); caches (b, S, hkv,
    dh) f32 or bf16; ``pos`` an int or a (b,) int tensor -> (b, h, dh) in
    q's dtype.  Row r attends positions ``<= pos[r]``."""
    b, h, dh = q.shape
    _, S, hkv, _ = k_cache.shape
    if h % hkv or k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != dh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, pos)
    if h // hkv > 32 or dh > MAX_DH or dh % 8:
        raise ValueError(f"decode_attention: needs h // hkv <= 32 and dh a "
                         f"multiple of 8 up to {MAX_DH}, got {h // hkv}, "
                         f"{dh}")
    if q.device.type == "meta":
        live = live_rows(pos, b, S)
    pos_t, pos0 = pos_args(pos, b, q.device)
    if q.device.type != "meta":
        _build.require_cuda(NAME, k_cache, v_cache,
                            *(() if pos_t is None else (pos_t,)))
    if q.device != k_cache.device:
        raise ValueError(f"{NAME}: tensors on {q.device} and "
                         f"{k_cache.device}")
    if q.dtype not in DTYPES or k_cache.dtype != v_cache.dtype \
            or k_cache.dtype not in DTYPES:
        raise ValueError(f"decode_attention: needs an f32 or bf16 q and f32 "
                         f"or bf16 caches of one dtype, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if q.device.type == "meta":
        cost.report(NAME, cost.decode_attention(
            b, h, hkv, dh, live, k_cache.element_size(), q.element_size()),
            (tuple(q.shape), tuple(k_cache.shape)))
        return torch.empty((b, h, dh), dtype=q.dtype, device="meta")
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    _launch(q, k_cache, v_cache, pos_t, pos0, out)
    _build.count(NAME, q.dtype == torch.bfloat16)
    return out


def _launch(q, k_cache, v_cache, pos_t, pos0: int, out,
            cluster: int = CLUSTER):
    """One launch of the kernel into ``out`` under a plan of ``cluster``
    ranks a row; checked, not counted."""
    b, h, dh = q.shape
    _, S, hkv, _ = k_cache.shape
    es = k_cache.element_size()
    cpy = copy_bytes(dh * es, k_cache.data_ptr(), v_cache.data_ptr())
    if not cpy:
        raise ValueError(f"{NAME}: cache rows and base addresses must be "
                         f"4-byte aligned, got dh {dh} at {es} bytes")
    fn = _build.launcher(NAME, "decode_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             None if pos_t is None else pos_t.data_ptr(), out.data_ptr(),
             b, S, h, hkv, dh, int(k_cache.dtype == torch.bfloat16),
             int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), cluster,
             cpy, row_stride(q, NAME + ": q"), pos0,
             _build.stream_ptr(q.device))
    _build.check(NAME, err)
