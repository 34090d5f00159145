#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # everything (needs one H100-class card)
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --only plan     # kernel checks, then runs (g)-(i)

Phases, each synchronized before the next; any failure exits non-zero
before the result line:

1. report the card (``nvidia-smi`` name and power limit);
2. build the four kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (batch generation and serving: ragged positions,
   bf16 caches, one slot's prefill) and at edge shapes; time kernel,
   plain version and one library call computing the same function
   (device time per call from a torch.profiler trace) and compute the
   roofline bound;
4. run tinyllama-1.1b at full width and depth through
   ``build_lm(plan).generate``: (a) fp32 weights, (b) int4 fused,
   (c) int4 fused sequential, (d) int4 fused with ``kv_mode="int4"`` —
   ``REPEATS`` times each on one engine, every launch counter zeroed
   before and read after each run; medians, then one profiled run per
   configuration for the card's busy share;
5. hold the whole path with kernels against ``use_kernels(False)`` on
   run (b)'s weights: final hidden states of a prefill and one decode
   step, and greedy-token agreement over run (b);
6. serve through ``create_engine(plan)``: (e) int4 weights and KV, 8
   requests of ragged lengths on 4 slots, then the same requests again
   with a slot preempted mid-run (same tokens required), then kernels
   against ``use_kernels(False)`` on its weights; (f) bf16 caches
   (``kv_mode="fp32"``), 4 requests;
7. (g) the paper's configuration, built only through the plan entry
   point: ``create_engine(EngineSpec(arch="llama3.1-8b",
   quant="int4").resolve())`` against the default ``MemoryBudget``
   (Llama-3.1-8B at full width and depth, 32 layers; depth-8 window),
   4 requests of ragged lengths, a short profiled serve for the card's
   busy share, then kernels against ``use_kernels(False)`` on its
   weights (final hidden states of a prefill within 1e-4 x max, of a
   decode step over the bf16 caches within 2e-2 x max, as run (e):
   the plain version rounds probabilities to bf16); peak device memory
   beside the plan's budget and the memory model's estimate, the host's
   RAM and the seconds spent drawing and packing the weights;
8. (h) the CLI in-process: ``repro_torch.launch.serve.main`` serving
   llama3.2-1b offloaded with INT4 weights and KV and
   ``--depth-policy adaptive``, the depth chosen at each step printed;
9. (i) the resident engine: ``create_engine(EngineSpec(
   arch="tinyllama-1.1b").resolve())`` (full width and depth) serves run
   (e)'s requests, is profiled, is held against ``use_kernels(False)``
   (the tolerances of run (g)), and its tokens are compared with the
   offloaded engine's on the same weights (agreement printed; the first
   divergence, if any, with the resident model's logit margin there);
10. print the ``kernels`` JSON line, the card, then the result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BPS = 3.35e12        # H100 SXM device memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12      # H100 SXM TF32 on the tensor cores, dense
ATTN_ATOL = 2e-5         # tests/test_kernels.py, fp32 attentions
BF16_ATOL = 2e-2         # tests/test_kernels.py, bf16 attention
INT4_KV_ATOL = 1e-6      # tests/test_kernels.py:101, int4 KV vs dequantized
INT4_RTOL = 1e-5         # tests/test_kernels.py, fp32 int4 matmul
HIDDEN_RTOL = 1e-4       # whole path: max|kernels - plain| / max|plain|
BF16_HIDDEN_RTOL = 2e-2  # the same over bf16 caches: the plain version
                         # rounds probabilities to bf16 as the reference
                         # does, the kernels keep them f32
REPEATS = {"a": 3, "b": 5, "c": 3, "d": 5}   # generate calls per run
PROFILE_GEN = 8          # tokens in the profiled run (busy share only)
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
    "decode_attention": "src/repro/kernels/decode_attention.py:76",
    "int4_matmul": "src/repro/kernels/int4_matmul.py:52",
    "decode_attention_int4": "src/repro/kernels/decode_attention.py:175",
}

# main path: tinyllama-1.1b, b=4, prompt 128, gen 32, max_len 256
B, PROMPT, GEN, MAX_LEN = 4, 128, 32, 256
PAPER_REQS, PAPER_NEW = 4, 16      # run (g): requests, new tokens each
CLI_ARGV = ["--arch", "llama3.2-1b", "--offload", "--quant", "int4",
            "--kv-mode", "int4", "--depth-policy", "adaptive",
            "--requests", "8"]     # run (h)
SERVE_POS = [159, 0, 77, 131]      # ragged serving positions, one per slot
SERVE_REQS = 8                     # serving run (e): requests, all submitted


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    (CUDA events after two warm-up calls): the device time, or the host's
    launch overhead where that is longer."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(torch, fn, attempts: int = 3):
    """(start, end) in µs of every kernel and copy ``fn()`` ran on the
    card, from a ``torch.profiler`` (CUPTI) trace.  A trace that comes
    back empty (seen once on the H100 machine, for a library call that
    had traced before) is taken again, up to ``attempts`` times; then it
    raises, so no other measure stands in for device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return dev
    raise RuntimeError(f"the profiler recorded no device events in "
                       f"{attempts} traces")


def device_ms(torch, fn, iters: int) -> float:
    """Mean device time per call of ``fn``: the durations of every kernel
    and copy it ran on the card over ``iters`` calls, summed and divided
    by ``iters``."""
    fn()
    torch.cuda.synchronize()
    dev = device_events(torch, lambda: [fn() for _ in range(iters)])
    return sum(e - s for s, e in dev) / iters / 1e3


def busy_share(ivals) -> dict:
    """Union of device intervals over the span from the first start to
    the last end."""
    busy, cur = 0.0, None
    for s, e in sorted(ivals):
        if cur is None or s > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    span = max(e for _, e in ivals) - min(s for s, _ in ivals)
    return {"device_busy_s": busy / 1e6, "device_span_s": span / 1e6,
            "device_busy_share": busy / span}


def timings(torch, kernel, plain, library, iters: int) -> dict:
    return {"ms": device_ms(torch, kernel, iters),
            "plain_ms": device_ms(torch, plain, iters),
            "library_ms": device_ms(torch, library, iters),
            "call_ms": call_ms(torch, kernel, iters)}


def bound_ms(nbytes: float, flops: float, rate: float = None):
    """The larger of bytes over the memory rate and operations over the
    peak rate of their type (fp32 outside the tensor cores unless
    ``rate`` says otherwise), in ms, and which of the two it is."""
    t_b, t_f = nbytes / HBM_BPS, flops / (rate or FP32_FLOPS)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_int4(torch, rng, dev):
    """``int4_matmul`` against its plain version (rtol 1e-5, atol 1e-5 *
    max|ref|), timed at every main-path shape: decode M = 4 (the kernels
    line's head: 2048x2048), batch prefill M = 512 and serving prefill
    M = 37 and 160, each at the four projection shapes."""
    from repro_torch.kernels.int4_matmul import SMALL_M, int4_matmul, plain
    from repro_torch.quant.int4 import dequantize_int4, quantize_int4
    shapes = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))
    cases = [(M, K, N, 128, True if (M, K, N) == (4, 2048, 2048) else
              f"M={M} {K}x{N}") for M in (4, 512, 37, 160)
             for K, N in shapes]
    # the Llama-3 projections: run (g)'s llama3.1-8b (d 4096, kv 1024,
    # d_ff 14336) at decode and at its longest prefill, run (h)'s
    # llama3.2-1b (d 2048, kv 512, d_ff 8192) at decode, and the 8B's
    # vocabulary head as if it were packed (K 4096, N 128256)
    l8 = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
    cases += [(M, K, N, 128, f"llama3.1-8b M={M} {K}x{N}")
              for M in (4, 128) for K, N in l8]
    cases += [(4, K, N, 128, f"llama3.2-1b M=4 {K}x{N}")
              for K, N in ((2048, 512), (2048, 8192), (8192, 2048))]
    cases += [(4, 4096, 128256, 128, None)]
    cases += [(1, 2048, 2048, 128, None), (3, 384, 256, 32, None),
              (16, 512, 384, 128, None), (512, 384, 200, 32, None),
              (3, 96, 10, 32, None), (16, 64, 6, 32, None),
              (17, 5632, 5632, 128, None), (16, 5632, 256, 128, None)]
    rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    for M, K, N, G, main in cases:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.05
        packed, scale = quantize_int4(w, G)
        out = int4_matmul(x, packed, scale, group=G)
        ref = plain(x, packed, scale, G)
        again = int4_matmul(x, packed, scale, group=G)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = INT4_RTOL * ref.abs() + INT4_RTOL * ref.abs().max()
        ok = bool(((out - ref).abs() <= tol).all())
        row = dict(shape=f"M={M} K={K} N={N} G={G}", max_abs_err=err,
                   err_over_max=err / ref.abs().max().item(),
                   deterministic=bool(torch.equal(out, again)),
                   ok=ok and bool(torch.equal(out, again)), main=main)
        if main:
            wd = dequantize_int4(packed, scale, torch.float32, G)
            row.update(timings(
                torch, lambda: int4_matmul(x, packed, scale, group=G),
                lambda: plain(x, packed, scale, G),
                lambda: torch.matmul(x, wd), 50 if M <= 16 else 10))
            nbytes = 4 * M * K + K * N // 2 + 4 * (K // G) * N + 4 * M * N
            flops = 2.0 * M * K * N
            row["bound_fp32_ms"] = bound_ms(nbytes, flops)[0]
            if M > SMALL_M:    # two TF32 terms on the tensor cores
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, 2 * flops, TF32_FLOPS)
                row["bound_rate"] = "tf32 x2 terms, 495 TFLOP/s"
            else:
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
                row["bound_rate"] = "fp32, 67 TFLOP/s"
        rows.append(row)
    return rows


def _attn_flops(torch, sq, sk, h, dh, b, causal, window, q_offset):
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    m = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= (qp - kp) < window
    return 4.0 * b * h * dh * int(m.sum())


def check_flash(torch, rng, dev):
    """``flash_attention`` against its plain version (atol 2e-5), two
    calls bit-equal; timed at the generation prefill shape (the kernels
    line's head) and at serving prefill of one slot (b = 1, sq = 37 and
    141, run (e)'s shortest-but-one and longest prompts), each beside
    SDPA.  The bound counts three TF32 products per multiply-add on the
    tensor cores (495 TFLOP/s), ``bound_fp32_ms`` the same work at fp32."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, plain
    # (b, sq, sk, h, hkv, dh, causal, window, q_offset, timed as)
    cases = [(B, PROMPT, PROMPT, 32, 4, 64, True, 0, 0, True),
             (2, 77, 77, 8, 2, 32, True, 0, 0, None),
             (2, 45, 65, 8, 2, 32, True, 13, 20, None),
             (1, 50, 70, 4, 4, 16, False, 0, 0, None),
             (2, 33, 33, 4, 1, 128, True, 0, 0, None),
             (2, 100, 140, 32, 4, 64, True, 17, 40, None),
             # serving prefill: one slot, the prompt's own length
             (1, 37, 37, 32, 4, 64, True, 0, 0, "serving sq=37"),
             (1, 141, 141, 32, 4, 64, True, 0, 0, "serving sq=141"),
             # Llama-3: head_dim 128 and a GQA group of 4 (run g's
             # prefill, one slot), llama3.2-1b's dh 64 (run h)
             (1, 128, 128, 32, 8, 128, True, 0, 0, "llama3.1-8b sq=128"),
             (1, 37, 37, 32, 8, 128, True, 0, 0, None),
             (4, 128, 128, 32, 8, 128, True, 0, 0, None),
             (1, 15, 15, 32, 8, 64, True, 0, 0, "llama3.2-1b sq=15")]
    rows = []
    for b, sq, sk, h, hkv, dh, causal, window, q_offset, timed in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, k, v = mk(b, sq, h, dh), mk(b, sk, hkv, dh), mk(b, sk, hkv, dh)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        again = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        row = dict(shape=f"b={b} sq={sq} sk={sk} h={h} hkv={hkv} dh={dh} "
                   f"causal={causal} window={window} q_offset={q_offset}",
                   max_abs_err=err, deterministic=same,
                   ok=err <= ATTN_ATOL and same, main=timed)
        if timed:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row.update(timings(
                torch, lambda: flash_attention(q, k, v, **kw),
                lambda: plain(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 20))
            nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
            flops = _attn_flops(torch, sq, sk, h, dh, b, causal, window,
                                q_offset)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 3 * flops,
                                                        TF32_FLOPS)
            row["bound_rate"] = "tf32 x3 terms, 495 TFLOP/s"
            row["bound_fp32_ms"] = bound_ms(nbytes, flops)[0]
        rows.append(row)
    return rows


def _sdpa_decode(torch, q, kc, vc, pos_t, fresh=None):
    """One ``scaled_dot_product_attention`` call computing the decode
    step: q (b, h, dh), caches (b, S, hkv, dh) f32, row r attending
    positions <= pos[r] (the library yardstick; the port never calls
    it)."""
    import torch.nn.functional as F
    S = kc.shape[1]
    qt = q[:, :, None]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos_t[:, None].long())[:, None, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def check_decode(torch, rng, dev):
    """``decode_attention`` against its plain version (atol 2e-5 at f32,
    2e-2 over bf16 caches), two calls bit-equal, and the same result for
    an int ``pos`` and a strided ``q`` where the case has them; timed at
    the generation shape (f32) and the serving shape (bf16, ragged pos)
    beside SDPA."""
    from repro_torch.kernels.decode_attention import decode_attention, plain
    from repro_torch.core.kvstore import KV_LEN_BUCKET
    last = PROMPT + GEN - 2            # the last decode step's position
    S = -(-(last + 1) // KV_LEN_BUCKET) * KV_LEN_BUCKET
    # (b, S, h, hkv, dh, pos, cache dtype, timed as)
    cases = [(B, S, 32, 4, 64, [last] * B, torch.float32, "f32"),
             (B, S, 32, 4, 64, [0, 37, S - 1, 100], torch.float32, None),
             (B, 100, 32, 4, 64, [0, 50, 99, 77], torch.float32, None),
             (3, 77, 8, 2, 32, [76, 0, 40], torch.float32, None),
             (2, 64, 4, 4, 16, [63, 5], torch.float32, None),
             (2, 300, 8, 8, 128, [299, 3], torch.float32, None),
             (B, 1024, 32, 4, 64, [1023, 700, 0, 64], torch.float32, None),
             (B, S, 32, 4, 64, [0, 0, 0, 0], torch.float32, None),
             # serving with kv_mode="fp32": bf16 caches, ragged positions
             (B, S, 32, 4, 64, SERVE_POS, torch.bfloat16, "bf16"),
             (B, 100, 32, 4, 64, [0, 50, 99, 77], torch.bfloat16, None),
             (3, 77, 8, 2, 32, [76, 0, 40], torch.bfloat16, None),
             (2, 33, 32, 32, 16, [32, 0], torch.bfloat16, None),
             # Llama-3.1-8B serving (run g): dh 128, group 4, bf16 caches
             (B, S, 32, 8, 128, SERVE_POS, torch.bfloat16,
              "llama3.1-8b bf16"),
             (B, S, 32, 8, 128, [last] * B, torch.float32, None),
             # the resident engine (run i): the whole max_len slab
             (B, MAX_LEN, 32, 4, 64, SERVE_POS, torch.bfloat16,
              "resident S=256")]
    rows = []
    for b, S_, h, hkv, dh, pos, cdt, timed in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, kc, vc = (mk(b, h, dh), mk(b, S_, hkv, dh).to(cdt),
                     mk(b, S_, hkv, dh).to(cdt))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, pos_t)
        ref = plain(q, kc, vc, pos_t)
        same = torch.equal(out, decode_attention(q, kc, vc, pos_t))
        if len(set(pos)) == 1:         # an int pos, q as a strided view
            qv = mk(b, 1, h + 2, dh)[:, 0, 1:h + 1]
            qv.copy_(q)
            same &= torch.equal(out, decode_attention(qv, kc, vc, pos[0]))
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = ATTN_ATOL if cdt == torch.float32 else BF16_ATOL
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} pos={pos} "
                   f"cache={str(cdt)[6:]}", max_abs_err=err, tol=tol,
                   deterministic=bool(same), ok=err <= tol and bool(same),
                   main=timed)
        if timed:
            row.update(timings(
                torch, lambda: decode_attention(q, kc, vc, pos_t),
                lambda: plain(q, kc, vc, pos_t),
                _sdpa_decode(torch, q, kc.float(), vc.float(), pos_t), 50))
            live = sum(p + 1 for p in pos)
            nbytes = (4 * 2 * q.numel() + 2 * live * hkv * dh
                      * kc.element_size() + 4 * b)
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 4.0 * h * dh * live)
        rows.append(row)
    return rows


def check_decode_int4(torch, rng, dev):
    """``decode_attention_int4`` against its plain version (atol 2e-5 at
    f32, 2e-2 with bf16 rounding) and, without a fresh row at f32,
    against ``decode_attention`` over the dequantized cache (atol 1e-6,
    tests/test_kernels.py:101)."""
    from repro_torch.core.kvstore import KV_LEN_BUCKET, PackedRows, kv_group
    from repro_torch.core.kvstore import quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    S = -(-(max(SERVE_POS) + 1) // KV_LEN_BUCKET) * KV_LEN_BUCKET
    last = PROMPT + GEN - 2
    # (b, S, h, hkv, dh, pos, fresh row, cache dtype, timed as)
    cases = [(B, S, 32, 4, 64, SERVE_POS, fresh, cdt, timed)
             for fresh, cdt, timed in (
                 (True, torch.bfloat16, "serving"),
                 (True, torch.float32, "generation"),
                 (False, torch.float32, None), (False, torch.bfloat16, None))]
    cases += [(B, S, 32, 4, 64, [last] * B, True, torch.float32, None),
              (B, S, 32, 4, 64, [0, 0, 5, 1], True, torch.float32, None),
              (B, S, 32, 4, 64, [0, 0, 5, 1], False, torch.float32, None),
              (B, 100, 32, 4, 64, [99, 0, 64, 31], False, torch.float32,
               None),
              (B, 100, 32, 4, 64, [99, 0, 64, 31], True, torch.bfloat16,
               None),
              (3, 77, 6, 3, 16, [76, 0, 40], False, torch.float32, None),
              (3, 77, 6, 3, 16, [76, 0, 40], True, torch.bfloat16, None),
              (2, 64, 8, 4, 16, [63, 5], False, torch.float32, None),
              (2, 64, 8, 4, 16, [63, 5], True, torch.float32, None),
              # the S split: chunks past pos[r], pos 0 on every row, pos
              # inside the first chunk, S not a multiple of the chunk
              (B, 256, 32, 4, 64, [3, 40, 0, 255], False, torch.float32,
               None),
              (B, 256, 32, 4, 64, [3, 40, 0, 255], True, torch.bfloat16,
               None),
              (B, S, 32, 4, 64, [0, 0, 0, 0], False, torch.float32, None),
              (B, S, 32, 4, 64, [0, 0, 0, 0], True, torch.float32, None),
              (B, 33, 32, 4, 64, [32, 0, 31, 1], False, torch.float32, None),
              (B, 33, 32, 4, 64, [32, 0, 31, 1], True, torch.float32, None),
              (B, 1024, 32, 4, 64, [1023, 700, 0, 64], False, torch.float32,
               None),
              # llama3.2-1b (run h): F = 8 x 64, the CLI's short prompts
              (B, 32, 32, 8, 64, [22, 15, 9, 20], True, torch.bfloat16,
               "llama3.2-1b"),
              (B, 32, 32, 8, 64, [22, 15, 9, 20], False, torch.float32,
               None),
              # head_dim 128, group 4 (Llama-3.1-8B with kv_mode="int4")
              (B, S, 32, 8, 128, SERVE_POS, True, torch.bfloat16, None),
              (B, S, 32, 8, 128, SERVE_POS, False, torch.float32, None)]
    rows = []
    for b, S_, h, hkv, dh, pos, fresh, cdt, timed in cases:
        F, mk = hkv * dh, (lambda *s: torch.tensor(
            rng.standard_normal(s), dtype=torch.float32, device=dev))
        g = kv_group(F)
        q = mk(b, h, dh)
        kq, ks = quantize_kv_rows(mk(b, S_, F), g)
        vq, vs = quantize_kv_rows(mk(b, S_, F), g)
        kn, vn = (mk(b, hkv, dh), mk(b, hkv, dh)) if fresh else (None, None)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn, cache_dtype=cdt)
        out = decode_attention_int4(q, kq, ks, vq, vs, pos_t, **kw)
        ref = plain(q, kq, ks, vq, vs, pos_t, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = ATTN_ATOL if cdt == torch.float32 else BF16_ATOL
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} g={g} "
                   f"pos={pos} fresh={fresh} cache={str(cdt)[6:]}",
                   max_abs_err=err, tol=tol, ok=err <= tol, main=timed)
        kd = PackedRows(kq, ks, g, torch.float32, (hkv, dh)).dequantize()
        vd = PackedRows(vq, vs, g, torch.float32, (hkv, dh)).dequantize()
        if not fresh and cdt == torch.float32:
            twin = decode_attention(q, kd, vd, pos_t)
            torch.cuda.synchronize()
            row["err_vs_decode_attention"] = (out - twin).abs().max().item()
            row["bit_equal_to_decode_attention"] = bool(torch.equal(out, twin))
            row["ok"] &= row["err_vs_decode_attention"] <= INT4_KV_ATOL
        if timed:
            if fresh:                    # the yardstick attends the same rows
                kd, vd = kd.clone(), vd.clone()
                rr = torch.arange(b, device=dev)
                kd[rr, pos_t.long()] = kn
                vd[rr, pos_t.long()] = vn
            row.update(timings(
                torch, lambda: decode_attention_int4(q, kq, ks, vq, vs,
                                                     pos_t, **kw),
                lambda: plain(q, kq, ks, vq, vs, pos_t, **kw),
                _sdpa_decode(torch, q, kd, vd, pos_t), 50))
            hist = sum(min(p + (0 if fresh else 1), S_) for p in pos)
            live = hist + (b if fresh else 0)
            nbytes = (4 * 2 * q.numel() + 4 * b
                      + 2 * hist * (F // 2 + 4 * (F // g))
                      + (2 * 4 * b * F if fresh else 0))
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 4.0 * h * dh * live)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------

def make_plan(quant, pipeline, kv_mode="fp32"):
    """A tinyllama-1.1b plan for runs (a)-(f), written out field by
    field."""
    from repro_torch.serving.spec import ResolvedPlan
    return ResolvedPlan(
        arch="tinyllama-1.1b", scaled=False, engine="offloaded", b_max=B,
        max_len=MAX_LEN, seed=0, placement="host", pipeline=pipeline,
        quant=quant, kv_mode=kv_mode, fused_int4=True, moe_quant=None,
        warm=pipeline == "performance", depth=1, depth_policy="static",
        spill_cap=32, cache_on="host", disk_root="",
        block_bytes=8 * 2**20, n_io_threads=3, cold_reads=False,
        sim_bw=None, draft_arch=None, spec_k=None)


def check_launches(name, counts, expect, exact=False):
    """Fail unless every kernel in ``expect`` launched at least (or, with
    ``exact``, exactly) its expected count in run ``name``."""
    for k, n in expect.items():
        if counts[k] < n or (exact or n == 0) and counts[k] != n:
            raise RuntimeError(f"run {name}: {k} launched {counts[k]} "
                               f"times, expected {'' if exact or n == 0 else '>= '}{n}")


def generate_once(torch, ops, lm, name, prompt, expect):
    """One main-path ``generate`` on a fresh trace (the engine's trace
    otherwise accumulates across calls), its launch counts zeroed before
    and read after; fails on bad tokens or a kernel launched too
    rarely (or, where ``expect`` says 0, at all)."""
    from repro_torch.core.tasks import Trace
    lm.trace = Trace()
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = lm.generate(prompt, GEN)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    vocab = lm.cfg.vocab_size
    if toks.shape != (B, GEN) or not ((toks >= 0) & (toks < vocab)).all():
        raise RuntimeError(f"run {name}: bad tokens {toks.shape}")
    check_launches(name, counts, expect)
    return toks, stats, counts


def run_main(torch, ops, name, plan, prompt, expect):
    """``REPEATS[name]`` runs on one engine (medians and every value of the
    end-to-end metrics), then one profiled ``PROFILE_GEN``-token run for
    the card's busy share."""
    from repro_torch.serving.spec import build_lm
    t0 = time.perf_counter()
    lm = build_lm(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    runs = [generate_once(torch, ops, lm, name, prompt, expect)
            for _ in range(REPEATS[name])]
    toks, _, counts = runs[0]
    keys = ("throughput_tok_s", "decode_tok_s", "ttft_s", "total_s",
            "compute_busy")
    stats = [s for _, s, _ in runs]
    pk = stats[0]["pipeline"]["per_kind"]
    summary = {
        "run": name, "plan": f"quant={plan.quant} kv_mode={plan.kv_mode} "
        f"pipeline={plan.pipeline} depth={plan.depth} placement="
        f"{plan.placement} cache_on={plan.cache_on}", "build_s": build_s,
        "repeats": REPEATS[name],
        **{k: statistics.median(s[k] for s in stats) for k in keys},
        "all": {k: [s[k] for s in stats] for k in keys},
        **{k: max(s.get(k, 0.0) for s in stats) for k in (
            "host_peak_gb", "device_peak_gb", "device_max_allocated_gb")},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "busy_s_median": {k: statistics.median(
            s["pipeline"]["per_kind"][k]["busy_s"] for s in stats)
            for k in pk},
        "launches": counts,
        "repeats_tokens_equal": all((t == toks).all() for t, _, _ in runs)}
    summary["profiled_gen"] = PROFILE_GEN
    summary.update(busy_share(device_events(
        torch, lambda: lm.generate(prompt, PROFILE_GEN))))
    log(json.dumps({"main_path": summary}))
    return lm, toks, counts, summary


def whole_path_check(torch, ops, lm, prompt, toks_b):
    """Kernels vs use_kernels(False) on the same engine and weights."""
    seen = []
    orig = lm.finalize

    def grab(i, x):
        seen.append(x.detach().clone())
        return orig(i, x)

    lm.finalize = grab
    try:
        ops.use_kernels(True)
        tk, _ = lm.generate(prompt, 2)
        hk = list(seen)
        seen.clear()
        ops.use_kernels(False)
        tp, _ = lm.generate(prompt, 2)
        hp = list(seen)
        seen.clear()
        toks_plain, _ = lm.generate(prompt, GEN)
    finally:
        ops.use_kernels(True)
        lm.finalize = orig
    torch.cuda.synchronize()
    res = {}
    for name, a, b in (("prefill", hk[0], hp[0]), ("decode1", hk[1], hp[1])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        res[name + "_rel_err"] = rel
        if not math.isfinite(rel) or not torch.isfinite(a).all():
            raise RuntimeError(f"{name}: non-finite hidden states")
    res["prefill_tokens_equal"] = bool((tk[:, 0] == tp[:, 0]).all())
    res["greedy_agreement_run_b"] = float((toks_b == toks_plain).mean())
    res["tolerance_rel"] = HIDDEN_RTOL
    log(json.dumps({"whole_path": res}))
    if res["prefill_rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"prefill hidden states differ: {res}")
    if res["prefill_tokens_equal"] and res["decode1_rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"decode hidden states differ: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 6: serving, create_engine(plan) -> OffloadedServingEngine
# ---------------------------------------------------------------------------

def serving_requests(n: int):
    """``n`` requests: prompt lengths in [32, 160] and max_new_tokens in
    [16, 64], drawn from ``default_rng(0)``."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 161, n)
    news = rng.integers(16, 65, n)
    return [(rng.integers(0, 32000, (int(l),)).astype(np.int32), int(m))
            for l, m in zip(lens, news)]


def serve_once(torch, ops, eng, reqs, rid0: int, preempt_after=None):
    """Submit every request, then drive ``step`` until the engine is
    idle, timing each step; launch counts zeroed before and read after.
    With ``preempt_after``, the first occupied slot is preempted after
    that many steps and resumes from its spilled rows."""
    from repro_torch.serving.base import Request
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated() / 2**30
    before = dict(eng.stats)
    for i, (p, m) in enumerate(reqs):
        eng.submit(Request(rid=rid0 + i, prompt=p.copy(), max_new=m))
    done, steps, preempted = [], [], None
    t0 = time.perf_counter()
    while not eng.idle():
        ts = time.perf_counter()
        eng.step(done)
        steps.append(time.perf_counter() - ts)
        if preempt_after is not None and len(steps) == preempt_after:
            slot = next(i for i, r in enumerate(eng.slots) if r is not None)
            preempted = eng.slots[slot].rid - rid0
            eng.preempt_slot(slot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: eng.stats[k] - before.get(k, 0) for k in (
        "prefills", "decode_steps", "tokens_out", "slot_saves",
        "slot_restores")}
    outs = {r.rid - rid0: list(r.out) for r in done}
    return dict(outs=outs, steps=steps, wall=wall, stats=stats,
                counts=dict(ops.LAUNCHES), preempted=preempted,
                device_allocated_at_start_gb=at_start,
                device_max_allocated_gb=torch.cuda.max_memory_allocated()
                / 2**30)


def run_serving(torch, ops, name, plan, reqs, decode_kernel, preempt=False):
    """Build the engine with ``create_engine``, serve ``reqs`` once (and,
    with ``preempt``, once more with a slot preempted mid-run, which must
    give the same tokens); fails on bad tokens or launch counts other
    than flash = layers x prefills and ``decode_kernel`` = layers x
    decode steps (the other decode kernel 0), and, with packed weights,
    int4_matmul = 7 projections x layers x (prefills + decode steps)."""
    from repro_torch.serving.spec import create_engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    r = serve_once(torch, ops, eng, reqs, 0)
    report = eng.pipeline_report()
    other = ({"decode_attention", "decode_attention_int4"}
             - {decode_kernel}).pop()
    n = plan.model_config().num_layers
    vocab = plan.model_config().vocab_size
    st = r["stats"]
    check_launches(name, r["counts"], {
        "flash_attention": n * st["prefills"],
        decode_kernel: n * st["decode_steps"], other: 0,
        "int4_matmul": (7 * n * (st["prefills"] + st["decode_steps"])
                        if plan.quant == "int4" else 0)}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != m or not all(0 <= t < vocab for t in outs[i])
            for i, (_, m) in enumerate(reqs)):
        raise RuntimeError(f"run {name}: bad tokens {outs}")
    steps_ms = sorted(1e3 * s for s in r["steps"])
    pk = report["per_kind"]
    summary = {
        "run": name, "plan": f"quant={plan.quant} kv_mode={plan.kv_mode} "
        f"pipeline={plan.pipeline} depth={plan.depth} b_max={plan.b_max} "
        f"max_len={plan.max_len} placement={plan.placement}",
        "build_s": build_s, "build_device_peak_gb": build_peak,
        "requests": len(reqs),
        "prompt_lens": [len(p) for p, _ in reqs],
        "max_new": [m for _, m in reqs], **st, "wall_s": r["wall"],
        "tok_s": st["tokens_out"] / r["wall"],
        "step_ms_median": statistics.median(steps_ms),
        "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
        "busy_s": {k: pk[k]["busy_s"] for k in pk},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "compute_busy": eng.trace.busy_fraction("compute"),
        "host_peak_gb": eng.host.peak_bytes / 2**30,
        "device_peak_gb": eng.device.peak_bytes / 2**30,
        "device_allocated_at_start_gb": r["device_allocated_at_start_gb"],
        "device_max_allocated_gb": r["device_max_allocated_gb"],
        "kv_dequant_bytes": eng.kvstore.dequant_bytes_total,
        "launches": r["counts"]}
    if preempt:
        p = serve_once(torch, ops, eng, reqs, 100, preempt_after=6)
        summary["preempt"] = {
            "slot_request": p["preempted"], **p["stats"],
            "tokens_equal": p["outs"] == outs, "launches": p["counts"]}
        if p["stats"]["slot_restores"] != 1 or p["outs"] != outs:
            raise RuntimeError(f"run {name}: the preempted run differs: "
                               f"{summary['preempt']}")
    log(json.dumps({"serving": summary}))
    return eng, r["counts"], summary


def serving_whole_path(torch, ops, eng, reqs):
    """Kernels vs use_kernels(False) on the serving engine's weights:
    hidden states of the first prefill and the first decode step, and
    greedy-token agreement over the run."""
    seen = []
    orig = eng.finalize

    def grab(i, x):
        seen.append((eng._phase, x.detach().clone()))
        return orig(i, x)

    eng.finalize = grab
    try:
        ops.use_kernels(True)
        rk = serve_once(torch, ops, eng, reqs, 200)
        hk, seen[:] = list(seen), []
        ops.use_kernels(False)
        rp = serve_once(torch, ops, eng, reqs, 300)
        hp = list(seen)
    finally:
        ops.use_kernels(True)
        eng.finalize = orig
    res = {}
    for phase in ("prefill", "decode"):
        a = next(x for ph, x in hk if ph == phase)
        b = next(x for ph, x in hp if ph == phase)
        if not torch.isfinite(a).all():
            raise RuntimeError(f"serving {phase}: non-finite hidden states")
        res[phase + "_rel_err"] = ((a - b).abs().max()
                                   / b.abs().max()).item()
    pairs = [(x, y) for i in rk["outs"] for x, y in
             zip(rk["outs"][i], rp["outs"].get(i, []))]
    res["tokens_compared"] = len(pairs)
    res["greedy_agreement"] = sum(x == y for x, y in pairs) / len(pairs)
    res["first_tokens_equal"] = all(rk["outs"][i][0] == rp["outs"][i][0]
                                    for i in rk["outs"])
    res["tolerance_rel"] = {"prefill": HIDDEN_RTOL, "decode": BF16_HIDDEN_RTOL}
    log(json.dumps({"serving_whole_path": res}))
    if res["prefill_rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"serving prefill hidden states differ: {res}")
    if res["first_tokens_equal"] and res["decode_rel_err"] > BF16_HIDDEN_RTOL:
        raise RuntimeError(f"serving decode hidden states differ: {res}")
    return res


# ---------------------------------------------------------------------------
# phases 7-9: the plan entry point, the CLI and the resident engine
# ---------------------------------------------------------------------------

def host_mem_gb() -> float:
    """The host's RAM (``MemTotal``) in GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemTotal in /proc/meminfo")


def modeled_device_bytes(plan) -> int:
    """The memory model's device footprint of the plan's window: the
    depth-0 peak plus ``depth`` in-flight layers, each at its weights
    (quant-scaled) and its KV slab — the terms behind the plan's depth
    provenance (``core.autoconfig.serving_depth_decision``)."""
    from repro_torch.core.memory_model import (estimate, quant_kv_ratio,
                                               quant_weight_ratio)
    cfg = plan.model_config()
    est0 = estimate(cfg, batch=plan.b_max, seq=plan.max_len, p=4, preload=0)
    per = (int(max(est0.w_mha, est0.w_mlp) * quant_weight_ratio(4, plan.quant))
           + int(est0.kv_cache // cfg.num_layers
                 * quant_kv_ratio(4, plan.kv_mode)))
    return max(est0.peak_prefill, est0.peak_decode) + plan.depth * per


def run_paper(torch, ops, np):
    """Run (g): Llama-3.1-8B, INT4 weights, through ``EngineSpec.resolve``
    and ``create_engine`` on the default budget; 4 ragged requests, then
    the whole path against ``use_kernels(False)``."""
    from repro_torch.serving.spec import EngineSpec
    plan = EngineSpec(arch="llama3.1-8b", quant="int4").resolve()
    cfg = plan.model_config()
    log(f"(g) plan: {plan.summary()}")
    log(f"(g) depth: {plan.provenance['depth']}")
    log(f"(g) host RAM (MemTotal): {host_mem_gb():.1f} GiB")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32),
             PAPER_NEW) for n in rng.integers(32, 129, PAPER_REQS)]
    eng, counts, summary = run_serving(torch, ops, "g", plan, reqs,
                                       "decode_attention")
    short = [(p, 4) for p, _ in reqs]
    summary["profiled"] = {"requests": PAPER_REQS, "max_new": 4, **busy_share(
        device_events(torch, lambda: serve_once(torch, ops, eng, short, 400)))}
    summary.update(
        host_mem_gb=host_mem_gb(), device_budget_gb=plan.device_budget / 2**30,
        modeled_device_gb=modeled_device_bytes(plan) / 2**30,
        params=cfg.param_count(), depth=eng.sched.depth,
        depth_provenance=plan.provenance["depth"])
    log(json.dumps({"paper_config": summary}))
    whole = serving_whole_path(torch, ops, eng, [(p, 2) for p, _ in reqs])
    eng.shutdown()
    return eng, counts, summary, whole


def run_cli(torch, ops):
    """Run (h): ``launch.serve.main`` in-process at full width; the depth
    the adaptive window chose at each decode step is recorded by wrapping
    ``PipelineScheduler.set_depth`` for the call."""
    import contextlib
    import io
    from repro_torch.core.pipeline import PipelineScheduler
    from repro_torch.launch import serve
    depths, orig = [], PipelineScheduler.set_depth

    def set_depth(self, depth):
        depths.append(orig(self, depth))
        return depths[-1]

    out = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    PipelineScheduler.set_depth = set_depth
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            eng = serve.main(CLI_ARGV)
    finally:
        PipelineScheduler.set_depth = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    text = out.getvalue()
    for line in text.splitlines():
        log(f"(h) {line}")
    n, st = eng.cfg.num_layers, eng.stats
    if "completed=8 " not in text or "pipeline[performance] depth=" not in text:
        raise RuntimeError(f"run h: the CLI printed {text!r}")
    check_launches("h", counts, {
        "flash_attention": n * st["prefills"],
        "decode_attention_int4": n * st["decode_steps"],
        "decode_attention": 0,
        "int4_matmul": 7 * n * (st["prefills"] + st["decode_steps"])},
        exact=True)
    if len(depths) != st["decode_steps"] or not all(1 <= d <= 8
                                                    for d in depths):
        raise RuntimeError(f"run h: depths {depths} over "
                           f"{st['decode_steps']} decode steps")
    summary = {"run": "h", "argv": CLI_ARGV, "wall_s": wall,
               "stats": st, "depth_per_step": depths, "launches": counts}
    log(json.dumps({"cli": summary}))
    return counts, summary


def logit_margin(torch, eng, tokens):
    """(top-1 minus top-2 logit, top-1 id, top-2 id) of ``eng``'s model
    (a resident engine) at the last position of ``tokens``."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    t = torch.tensor(np.asarray(tokens, np.int32)[None], device=eng.dev)
    ctx = L.Ctx(cfg=eng.cfg, mode="prefill", angles=T._angles(
        eng.cfg, torch.arange(t.shape[1], device=eng.dev)))
    x, _ = T._run_stack(eng.params, L.embed_tokens(eng.params["embed"], t),
                        ctx, None, eng.cfg)
    x = L.rms_norm(x[:, -1], eng.params["final_norm"]["scale"],
                   eng.cfg.norm_eps)
    p = eng.params["embed"]
    w = p["emb"].T if eng.cfg.tie_embeddings else p["w_out"]
    top = torch.topk((x @ w)[0, :eng.cfg.vocab_size], 2)
    return ((top.values[0] - top.values[1]).item(),
            int(top.indices[0]), int(top.indices[1]))


def run_resident(torch, ops, reqs):
    """Run (i): the resident engine through ``EngineSpec.resolve`` ->
    ``create_engine``; its whole path against ``use_kernels(False)`` (the
    final hidden states of a prefill and of a decode step, caught at the
    head); its tokens against the offloaded engine's on the same weights
    (both draw them from the plan's seed)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch="tinyllama-1.1b").resolve()
    log(f"(i) plan: {plan.summary()}; engine: {plan.provenance['engine']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if type(eng) is not ServingEngine:
        raise RuntimeError(f"run i: built {type(eng).__name__}")
    r = serve_once(torch, ops, eng, reqs, 0)
    n, st = eng.cfg.num_layers, r["stats"]
    check_launches("i", r["counts"], {
        "flash_attention": n * st["prefills"],
        "decode_attention": n * st["decode_steps"],
        "decode_attention_int4": 0, "int4_matmul": 0}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != m for i, (_, m) in enumerate(reqs)):
        raise RuntimeError(f"run i: bad tokens {outs}")
    steps_ms = sorted(1e3 * x for x in r["steps"])
    summary = {"run": "i", "plan": plan.summary(), "build_s": build_s,
               **st, "wall_s": r["wall"], "tok_s": st["tokens_out"] / r["wall"],
               "step_ms_median": statistics.median(steps_ms),
               "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
               "device_max_allocated_gb": r["device_max_allocated_gb"],
               "launches": r["counts"]}
    summary["profiled"] = {"requests": B, "max_new": 8, **busy_share(
        device_events(torch, lambda: serve_once(
            torch, ops, eng, [(p, 8) for p, _ in reqs[:B]], 400)))}

    # kernels vs plain: hidden states at the head, prefill and decode
    seen, head = [], T._head

    def grab(params, x, cfg):
        seen.append(x[:, -1].detach().clone())
        return head(params, x, cfg)

    T._head = grab
    try:
        short = [(p, 2) for p, _ in reqs[:B]]
        serve_once(torch, ops, eng, short, 200)
        hk, seen[:] = list(seen), []
        ops.use_kernels(False)
        serve_once(torch, ops, eng, short, 300)
        hp = list(seen)
    finally:
        ops.use_kernels(True)
        T._head = head
    whole = {}
    for phase, a, b in (("prefill", hk[0], hp[0]),
                        ("decode", hk[B], hp[B])):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"run i {phase}: non-finite hidden states")
        whole[phase + "_rel_err"] = ((a - b).abs().max()
                                     / b.abs().max()).item()
    whole["tolerance_rel"] = {"prefill": HIDDEN_RTOL,
                              "decode": BF16_HIDDEN_RTOL}
    log(json.dumps({"resident_whole_path": whole}))
    if whole["prefill_rel_err"] > HIDDEN_RTOL \
            or whole["decode_rel_err"] > BF16_HIDDEN_RTOL:
        raise RuntimeError(f"run i: hidden states differ: {whole}")

    # the offloaded engine on the same weights (same seed), same requests
    oplan = EngineSpec(arch="tinyllama-1.1b", offload=True).resolve()
    oeng = create_engine(oplan)
    ro = serve_once(torch, ops, oeng, reqs, 0)
    oeng.shutdown()
    pairs = [(x, y) for i in outs for x, y in zip(outs[i], ro["outs"][i])]
    agree = {"offloaded_plan": oplan.summary(),
             "tokens_compared": len(pairs),
             "tokens_equal": sum(x == y for x, y in pairs),
             "requests_equal": sum(outs[i] == ro["outs"][i] for i in outs)}
    first = next(((i, k) for i in sorted(outs) for k, (x, y) in
                  enumerate(zip(outs[i], ro["outs"][i])) if x != y), None)
    if first is not None:
        i, k = first
        prefix = list(reqs[i][0]) + outs[i][:k]
        agree["first_divergence"] = {
            "request": i, "step": k, "resident": outs[i][k],
            "offloaded": ro["outs"][i][k],
            "resident_logit_margin": logit_margin(torch, eng, prefix)}
    summary["vs_offloaded"] = agree
    log(json.dumps({"resident": summary}))
    eng.shutdown()
    return r["counts"], summary


def run_tinyllama(torch, ops, np, rng, counts, summaries, reqs, release):
    """Runs (a)-(f): tinyllama-1.1b, generation and offloaded serving."""
    # 4. the main path: batch generation (a)-(d)
    prompt = rng.integers(0, 32000, (B, PROMPT)).astype(np.int32)
    n_layers = 22
    attn_expect = {"flash_attention": n_layers,
                   "decode_attention": n_layers * (GEN - 1),
                   "decode_attention_int4": 0}
    int4_expect = {**attn_expect, "int4_matmul": 7 * n_layers * GEN}
    lm, _, counts["a"], summaries["a"] = run_main(
        torch, ops, "a", make_plan(None, "performance"), prompt, attn_expect)
    release(lm)
    lm, toks_b, counts["b"], summaries["b"] = run_main(
        torch, ops, "b", make_plan("int4", "performance"), prompt,
        int4_expect)

    # 5. the whole path against the plain versions, same weights
    whole_path_check(torch, ops, lm, prompt, toks_b)
    release(lm)
    lm, _, counts["c"], summaries["c"] = run_main(
        torch, ops, "c", make_plan("int4", "sequential"), prompt, int4_expect)
    release(lm)
    lm, _, counts["d"], summaries["d"] = run_main(
        torch, ops, "d", make_plan("int4", "performance", "int4"), prompt,
        {**int4_expect, "decode_attention": 0,
         "decode_attention_int4": n_layers * (GEN - 1)})
    release(lm)
    log(json.dumps({"kv_load_bytes": {
        "b_fp32_kv": summaries["b"]["bytes"]["kv_load"],
        "d_int4_kv": summaries["d"]["bytes"]["kv_load"],
        "ratio": summaries["b"]["bytes"]["kv_load"]
        / summaries["d"]["bytes"]["kv_load"]}}))

    # 6. serving: (e) int4 KV with a preempted rerun and the whole-path
    # check, (f) fp32 KV over bf16 caches
    eng, counts["e"], summaries["e"] = run_serving(
        torch, ops, "e", make_plan("int4", "performance", "int4"), reqs,
        "decode_attention_int4", preempt=True)
    serving_whole_path(torch, ops, eng, [(p, 8) for p, _ in reqs[:B]])
    eng.shutdown()
    release(eng)
    eng, counts["f"], summaries["f"] = run_serving(
        torch, ops, "f", make_plan("int4", "performance"), reqs[:B],
        "decode_attention")
    eng.shutdown()
    release(eng)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels", "plan"), default=None,
                    help="stop after the kernel checks (kernels), or run "
                         "them and runs (g)-(i) only (plan)")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    dev = resolve_device("cuda")

    # 1. the card
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(json.dumps({"build": {"wall_s": time.perf_counter() - t0,
                              "per_source_s": secs}}))
    for name in _build.SOURCES:
        logf = _build.build_dir() / f"{name}.log"
        fn = "?"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1] if "'" in line else line
                elif "registers" in line or "spill" in line:
                    log(f"ptxas {name} {fn}: "
                        f"{line.split(':', 1)[-1].strip()}")

    # 3. kernels vs plain versions
    rng = np.random.default_rng(0)
    checks = {"int4_matmul": check_int4(torch, rng, dev),
              "flash_attention": check_flash(torch, rng, dev),
              "decode_attention": check_decode(torch, rng, dev),
              "decode_attention_int4": check_decode_int4(torch, rng, dev)}
    torch.cuda.synchronize()
    failed = []
    for name, rows in checks.items():
        for row in rows:
            log(json.dumps({"kernel_check": name, **row}))
            if not row["ok"]:
                failed.append(f"{name} {row['shape']}")
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{failed}")
    if args.only == "kernels":
        return 0

    counts, summaries = {}, {}
    reqs = serving_requests(SERVE_REQS)

    def release(lm):
        del lm
        gc.collect()
        torch.cuda.empty_cache()

    if args.only != "plan":
        run_tinyllama(torch, ops, np, rng, counts, summaries, reqs, release)
        gc.collect()                # the engines hold reference cycles
        torch.cuda.empty_cache()

    # 7.-9. the plan entry point: (g) the paper's Llama-3.1-8B, (h) the
    # CLI, (i) the resident engine
    eng, counts["g"], summaries["g"], _ = run_paper(torch, ops, np)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    counts["h"], summaries["h"] = run_cli(torch, ops)
    gc.collect()
    torch.cuda.empty_cache()
    counts["i"], summaries["i"] = run_resident(torch, ops, reqs)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. the kernels line: each kernel's launches in the run its timed
    # shape comes from, and per run
    home = {"flash_attention": "b", "decode_attention": "b",
            "int4_matmul": "b", "decode_attention_int4": "e"}
    kernels = []
    for name, rows in checks.items():
        m = next(r for r in rows if r["main"])
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": counts[home[name]][name] if home[name] in counts
            else max(c[name] for c in counts.values()),
            "launches_run": home[name] if home[name] in counts else None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "call_ms": m["call_ms"],
            "parity": "ok", "shape": m["shape"],
            "launches_by_run": {k: c[name] for k, c in counts.items()}}
        entry.update({k: m[k] for k in ("bound_rate", "bound_fp32_ms")
                      if k in m})
        variants = [r for r in rows
                    if isinstance(r["main"], str) and r is not m]
        for v in variants:
            entry[v["main"]] = {k: v[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "call_ms",
                "bound_ms", "bound_by", "bound_rate", "bound_fp32_ms",
                "max_abs_err") if k in v}
        kernels.append(entry)
    torch.cuda.synchronize()
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
