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
up to ``MAX_DH`` (instances at 16, 32, 64, 128, 192 and 256).
``flash_plan`` lays out the blocks (heads x row tiles, and a key split
across a cluster where the grid is small).  A CPU tensor runs the plain version
``flash_attention_ref``; a CUDA tensor launches the kernel or raises;
a meta tensor gets an empty output and reports the kernel's operations
and bytes (``kernels.cost``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import flash_attention_ref

NAME = "flash_attention"
ROWS = 16                        # query rows per warp (the kernel's ROWS)
BK = 32                          # keys per tile (the kernel's BK)
WARPS = 4                        # warps a block (heads x row tiles), or 8
MAX_SPLITS = 8                   # key splits: the ranks of a cluster
SPLIT_TILES = 4                  # the fewest key tiles a rank walks
SPLIT_COST = 0.15                # the plan's price of each rank past one
N_SMS = 132                      # the H100's SMs (the plan's default)
MAX_DH = 256                     # the widest head the kernel takes (Gemma 3)
DH_INSTANCES = (16, 32, 64, 128, 192, 256)   # the kernel's head widths
SMEM_MAX = 232448                # shared memory a block may use (H100)
SMEM_SM = 233472                 # an SM's shared memory (228 KB)
REGS_SM = 65536                  # an SM's registers
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
         + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
DH_STEP = {torch.float32: 4, torch.bfloat16: 16}   # head_dim step by dtype

plain = flash_attention_ref


def _tiles(row0: int, sq: int, sk: int, causal: bool, window: int,
           q_offset: int):
    """The key tiles [lo, hi] query rows ``row0``..``row0 + 15`` attend
    (lo > hi: none): ``csrc/flash_attention.cu`` tile_range."""
    nrows = min(ROWS, sq - row0)
    if nrows <= 0:
        return 1, 0
    qp_lo = q_offset + row0
    k_hi = min(sk - 1, qp_lo + nrows - 1) if causal else sk - 1
    k_lo = max(0, qp_lo - window + 1) if window else 0
    return (k_lo // BK, k_hi // BK) if k_hi >= k_lo else (1, 0)


def block_tiles(rb: int, wr: int, sq: int, sk: int, causal: bool,
                window: int, q_offset: int):
    """The key tiles [lo, hi] of row block ``rb`` (``wr`` row tiles of
    16): the union of its row tiles' ranges, as the kernel walks them."""
    spans = [_tiles((rb * wr + r) * ROWS, sq, sk, causal, window, q_offset)
             for r in range(wr)]
    spans = [s for s in spans if s[0] <= s[1]]
    if not spans:
        return 1, 0
    return min(s[0] for s in spans), max(s[1] for s in spans)


def smem_bytes(dh: int, itemsize: int, warps: int, splits: int) -> int:
    """Shared memory of one block (``csrc/flash_attention.cu`` smem_bytes
    and bf16_smem_bytes): the K/V ring (and Q where it lives there), or
    a split block's (m, l, O) rows if larger."""
    DH = next(d for d in DH_INSTANCES if dh <= d)
    if itemsize == 4:
        ring = 4 * ((2 if DH > 128 else 3) * BK * (2 * DH + 12)
                    + (warps * ROWS * (DH + 8) if DH > 128 else 0))
    else:
        ring = 2 * ((3 if DH > 128 else 4) * BK * 2 * (DH + 8)
                    + warps * ROWS * (DH + 8))
    merge = 4 * warps * ROWS * (DH + 5 + MAX_SPLITS) if splits > 1 else 0
    return max(ring, merge)


def resident(dh: int, itemsize: int, warps: int, splits: int) -> int:
    """Blocks of ``warps`` warps an SM holds at once: its shared memory
    (1 KB of it reserved a block) and its registers (up to 255 a
    thread)."""
    by_smem = SMEM_SM // (smem_bytes(dh, itemsize, warps, splits) + 1024)
    return min(by_smem, REGS_SM // (32 * warps * 255))


@functools.lru_cache(maxsize=4096)
def flash_plan(b: int, sq: int, sk: int, h: int, hkv: int,
               causal: bool = True, window: int = 0, q_offset: int = 0,
               dh: int = 64, itemsize: int = 4, n_sms: int = N_SMS):
    """(wh, wr, splits, blocks).  A block is ``wh`` heads of one kv group
    (the most of 4, 2, 1 that divides the group) times ``wr`` row tiles
    of ``ROWS`` query rows, ``wh * wr`` warps (4, or 8) that share each
    K/V tile: at 4 warps a group of 1 runs 1 head x 64 rows, a group of
    2 2 heads x 32 rows, a larger group 4 heads x 16 rows.  ``splits``
    ranks of a cluster (1 to 8) split the key tiles, each walking
    ``SPLIT_TILES`` of the heaviest block's (the last rows') or more.
    Of these layouts the plan takes the least of a model of the time:
    each SM gets L = ceil(blocks / SMs) blocks, each of ``warps / 4``
    units of work divided by ``splits``, and runs them at a rate that
    grows with the warps it holds at once (``resident`` blocks of them)
    up to 8 warps, where the copies' and the tensor cores' latencies are
    covered (``tools/flash_phases.py``: a lone 4-warp block an SM runs at
    about half the rate), each rank past one adding ``SPLIT_COST`` of
    the time for the ranks' merge (the H100's times at 2, 4 and 8 ranks
    over whisper's encoder and Gemma 3's window); ties go to fewer
    warps, then fewer splits.  So it splits where the grid is under one
    wave of the SMs or leaves SMs with one block more than others
    (whisper's encoder and cross prefill, Gemma 3's window at f32, a
    short chunk over a long prefix) and takes 8 warps where one 4-warp
    block an SM is all the shared memory allows (DeepSeek-V3's MLA at dh
    192 f32, Gemma 3 at bf16); ``blocks`` counts every rank."""
    g = h // hkv
    wh = next(w for w in (4, 2, 1) if g % w == 0)
    n_qt = -(-sq // ROWS)
    best = None
    for warps in (WARPS, 2 * WARPS):
        wr = warps // wh
        if smem_bytes(dh, itemsize, warps, 1) > SMEM_MAX:
            continue
        n_rb = -(-n_qt // wr)
        blocks = b * hkv * (g // wh) * n_rb
        lo, hi = block_tiles(n_rb - 1, wr, sq, sk, causal, window, q_offset)
        tiles = max(0, hi - lo + 1)
        for splits in (1, 2, 4, 8):
            if splits > 1 and (tiles < splits * SPLIT_TILES or smem_bytes(
                    dh, itemsize, warps, splits) > SMEM_MAX):
                break
            per_sm = -(-blocks * splits // n_sms)
            held = min(per_sm, resident(dh, itemsize, warps, splits))
            rate = min(held * warps, 2 * WARPS) / (2 * WARPS)
            cost = (per_sm * warps / WARPS / splits / rate
                    * (1 + SPLIT_COST * (splits - 1)))
            if best is None or cost < best[0] - 1e-9:
                best = (cost, wh, wr, splits, blocks * splits)
    return best[1:]


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
    wh, wr, splits, _ = flash_plan(b, sq, sk, h, hkv, bool(causal),
                                   int(window), int(q_offset), dh,
                                   q.element_size(),
                                   _build.num_sms(q.device.index))
    _launch(q, k, v, out, bool(causal), int(window), int(q_offset),
            (wh, wr, splits))
    _build.count(NAME, q.dtype == torch.bfloat16)
    if q_offset > 0:
        _build.LAUNCHES[_build.Q_OFFSET] += 1
    return out


def _launch(q, k, v, out, causal: bool, window: int, q_offset: int, plan):
    """One launch of the kernel into ``out`` under ``plan`` = (wh, wr,
    splits), counted nowhere: the wrapper's launch, and the one
    ``chip_smoke.py`` and ``tools/flash_phases.py`` use to hold one plan
    against another."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    wh, wr, splits = plan
    fn = _build.launcher(NAME, "flash_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, hkv, dh, int(causal), int(window), int(q_offset),
             1.0 / math.sqrt(dh), wh, wr, splits,
             int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(NAME, err)
