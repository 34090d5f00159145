"""Each kernel's operations and bytes as plain functions of its shapes
and dtypes, and the bound they give on the H100.

One count serves two readers: ``chip_smoke.py``'s bound column (the
least time the card could take for a kernel's work) and the roofline
counter (``repro_torch.roofline``), to which an op handed meta tensors
reports its kernel's work in place of tracing its plain version
(``kernels.ops``): the plain version would price an f32 dequantized
weight or a whole score matrix that the kernel never writes.

Bytes count each input read once and each output written once, at its
own size: an f32 operand four bytes an element, a bf16 one two (the
``*itemsize`` arguments; the bf16 instances read bf16 q or x and write
their output in that dtype); operations count a multiply-add as two.  Where the work depends on the
data (the rows a ragged decode attends, the pairs a mask keeps), the
functions take what this call's data needs.

The rates are NVIDIA's data-sheet figures for the H100 SXM5 (80 GB
HBM3, 700 W), not measurements.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple

import numpy as np

HBM_BPS = 3.35e12        # device memory rate
FP32_FLOPS = 67e12       # fp32 outside the tensor cores
TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense
BF16_FLOPS = 989e12      # bf16 on the tensor cores, dense


class Cost(NamedTuple):
    flops: float
    nbytes: float


def bound_ms(nbytes: float, flops: float, rate: float = None):
    """The larger of bytes over the memory rate and operations over the
    peak rate of their type (fp32 outside the tensor cores unless
    ``rate`` says otherwise), in ms, and which of the two it is."""
    t_b, t_f = nbytes / HBM_BPS, flops / (rate or FP32_FLOPS)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# int4_matmul
# ---------------------------------------------------------------------------

SMALL_M = 16             # kernels/int4_matmul.py: the GEMV path up to here


def int4_matmul(M: int, K: int, N: int, group: int,
                itemsize: int = 4) -> Cost:
    """``x (M, K) @ dequant(packed (K, N/2) u8, scale (K/group, N)
    f32)`` -> (M, N) in x's dtype (``itemsize`` bytes an element): 2MKN
    operations; x, the packed bytes, the scales and the output once
    each."""
    nbytes = (itemsize * M * K + K * N // 2 + 4 * (K // group) * N
              + itemsize * M * N)
    return Cost(2.0 * M * K * N, float(nbytes))


def int4_matmul_bound(M: int, K: int, N: int, group: int,
                      itemsize: int = 4):
    """(ms, by, rate).  An f32 x is priced at the rate of the path the
    kernel takes: fp32 FMAs up to ``SMALL_M`` rows, above two TF32
    products per multiply-add on the tensor cores (the kernel's split of
    f32 into two TF32 terms).  A bf16 x is priced at the bf16 tensor-core
    rate whatever the path: bf16 x and the nibbles -8..7 are both exact
    in bf16, so the card could compute this function at that rate (the
    kernel widens to TF32 instead, which keeps it from this bound)."""
    c = int4_matmul(M, K, N, group, itemsize)
    if itemsize == 2:
        return (*bound_ms(c.nbytes, c.flops, BF16_FLOPS),
                "bf16, 989 TFLOP/s")
    if M > SMALL_M:
        return (*bound_ms(c.nbytes, 2 * c.flops, TF32_FLOPS),
                "tf32 x2 terms, 495 TFLOP/s")
    return (*bound_ms(c.nbytes, c.flops), "fp32, 67 TFLOP/s")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attended_pairs(sq: int, sk: int, causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> int:
    """(query, key) pairs a mask keeps: query i at position q_offset + i
    attends keys j <= it (``causal``) and within ``window`` of it."""
    qp = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(qp, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(b: int, sq: int, sk: int, h: int, hkv: int, dh: int,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, itemsize: int = 4) -> Cost:
    """Blocked GQA attention over q, k, v of ``itemsize`` bytes an
    element: 4·dh operations per attended pair and head (QK^T and PV);
    q, k, v read and the output (q's dtype) written once."""
    pairs = attended_pairs(sq, sk, causal, window, q_offset)
    nbytes = itemsize * (2 * b * sq * h * dh + 2 * b * sk * hkv * dh)
    return Cost(4.0 * b * h * dh * pairs, float(nbytes))


def flash_attention_bound(b, sq, sk, h, hkv, dh, causal=True, window=0,
                          q_offset=0, itemsize=4):
    """(ms, by, rate): for f32, three TF32 products per multiply-add on
    the tensor cores (the kernel's 3xTF32 split of f32); for bf16, one
    bf16 product at the bf16 rate."""
    c = flash_attention(b, sq, sk, h, hkv, dh, causal, window, q_offset,
                        itemsize)
    if itemsize == 2:
        return (*bound_ms(c.nbytes, c.flops, BF16_FLOPS),
                "bf16, 989 TFLOP/s")
    return (*bound_ms(c.nbytes, 3 * c.flops, TF32_FLOPS),
            "tf32 x3 terms, 495 TFLOP/s")


def decode_attention(b: int, h: int, hkv: int, dh: int, live: int,
                     cache_itemsize: int = 4, q_itemsize: int = 4) -> Cost:
    """One-token GQA decode over ``live`` cached rows in all (the sum
    over the batch of pos + 1): 4·h·dh operations a row; q read and the
    output (q's dtype) written once, each live K and V row read once,
    the (b,) positions."""
    nbytes = (q_itemsize * 2 * b * h * dh
              + 2 * live * hkv * dh * cache_itemsize + 4 * b)
    return Cost(4.0 * h * dh * live, float(nbytes))


def decode_attention_int4(b: int, h: int, hkv: int, dh: int, hist: int,
                          group: int, fresh: bool, q_itemsize: int = 4,
                          new_itemsize: int = 4) -> Cost:
    """The same decode over packed INT4 rows: ``hist`` packed rows (F/2
    bytes and F/group f32 scales each, K and V), plus one fresh row (K
    and V, ``new_itemsize`` bytes an element) a sequence when ``fresh``;
    q and the output at ``q_itemsize``."""
    F = hkv * dh
    live = hist + (b if fresh else 0)
    nbytes = (q_itemsize * 2 * b * h * dh + 4 * b
              + 2 * hist * (F // 2 + 4 * (F // group))
              + (2 * new_itemsize * b * F if fresh else 0))
    return Cost(4.0 * h * dh * live, float(nbytes))


# ---------------------------------------------------------------------------
# What the meta branches report (``kernels.ops``)
# ---------------------------------------------------------------------------

_LISTENERS: List[Callable] = []


@contextlib.contextmanager
def listening(fn: Callable):
    """Call ``fn(name, cost, shapes)`` for every kernel an op prices on
    meta tensors inside the block."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


def report(name: str, cost: Cost, shapes) -> None:
    for fn in list(_LISTENERS):
        fn(name, cost, shapes)
