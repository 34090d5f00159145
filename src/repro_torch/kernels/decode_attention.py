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

The sequence split (``chunk_plan``) and the host-side argument helpers
are shared with ``decode_attention_int4``, whose kernel runs the same
chunk step and combine (``csrc/decode_attention_common.cuh``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import decode_attention_ref

NAME = "decode_attention"
CHUNK = 32                       # positions per chunk (the kernels' CH)
MAX_CLUSTER = 8                  # blocks per (row, kv head)
MAX_DH = 256                     # 8 output features per lane (the kernels')
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
         + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)   # q's and the caches' instances

plain = decode_attention_ref


def chunk_plan(S: int, has_new: bool = False):
    """(ranks, chunks per rank): the sequence's chunks of ``CHUNK``
    positions (the cached rows, plus a fresh row) spread over a cluster
    of at most ``MAX_CLUSTER`` blocks per (row, kv head), each rank a run
    of consecutive chunks."""
    n_chunks = max(1, -(-(S + int(has_new)) // CHUNK))
    cpr = -(-n_chunks // MAX_CLUSTER)
    return -(-n_chunks // cpr), cpr


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


def _vec(dh: int, esize: int, *ptrs: int) -> int:
    """Cache elements per load: the most in 16 bytes that divides a row
    and keeps every base address aligned."""
    n = 16 // esize
    while n > 1 and (dh % n or any(p % (n * esize) for p in ptrs)):
        n //= 2
    return n


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
    if h // hkv > 32 or dh > MAX_DH:
        raise ValueError(f"decode_attention: needs h // hkv <= 32 and dh <= "
                         f"{MAX_DH}, got {h // hkv}, {dh}")
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
    q_rs = row_stride(q, NAME + ": q")
    ranks, cpr = chunk_plan(S)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    fn = _build.launcher(NAME, "decode_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             None if pos_t is None else pos_t.data_ptr(), out.data_ptr(),
             b, S, h, hkv, dh, int(k_cache.dtype == torch.bfloat16),
             int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), ranks, cpr,
             _vec(dh, k_cache.element_size(), k_cache.data_ptr(),
                  v_cache.data_ptr()),
             q_rs, pos0, _build.stream_ptr(q.device))
    _build.check(NAME, err)
    _build.count(NAME, q.dtype == torch.bfloat16)
    return out
