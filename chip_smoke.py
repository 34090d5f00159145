#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # everything (needs one H100-class card)
    python3 chip_smoke.py --only kernels  # build + kernel checks only

Phases, each synchronized before the next; any failure exits non-zero
before the result line:

1. report the card (``nvidia-smi`` name and power limit);
2. build the three kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes; time kernel, plain version and
   one library call computing the same function (device time per call
   from a torch.profiler trace) and compute the roofline bound;
4. run tinyllama-1.1b at full width and depth through
   ``build_lm(plan).generate`` in three configurations — (a) fp32
   performance, (b) int4 fused performance, (c) int4 fused sequential —
   ``REPEATS`` times each on one engine, with every launch counter
   zeroed before and read after each run, and report the medians; then
   one profiled run per configuration for the card's busy share;
5. hold the whole path with kernels against ``use_kernels(False)`` on
   the same weights: final hidden states of a prefill and one decode step,
   and greedy-token agreement over run (b);
6. print the ``kernels`` JSON line, then the result line.

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
ATTN_ATOL = 2e-5         # tests/test_kernels.py, fp32 attentions
INT4_RTOL = 1e-5         # tests/test_kernels.py, fp32 int4 matmul
HIDDEN_RTOL = 1e-4       # whole path: max|kernels - plain| / max|plain|
REPEATS = 5              # generate calls per main-path configuration
PROFILE_GEN = 8          # tokens in the profiled run (busy share only)
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
    "decode_attention": "src/repro/kernels/decode_attention.py:76",
    "int4_matmul": "src/repro/kernels/int4_matmul.py:52",
}

# main path: tinyllama-1.1b, b=4, prompt 128, gen 32, max_len 256
B, PROMPT, GEN, MAX_LEN = 4, 128, 32, 256


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


def device_events(torch, fn):
    """(start, end) in µs of every kernel and copy ``fn()`` ran on the
    card, from a ``torch.profiler`` (CUPTI) trace.  Raises when the trace
    holds none, so no other measure stands in for device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    return dev


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


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BPS, flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_int4(torch, rng, dev):
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import dequantize_int4, quantize_int4
    cases = [(M, K, N, 128, True) for M in (4, 512)
             for K, N in ((2048, 2048), (2048, 256), (2048, 5632),
                          (5632, 2048))]
    cases += [(1, 2048, 2048, 128, False), (3, 384, 256, 32, False),
              (16, 512, 384, 128, False), (512, 384, 200, 32, False),
              (3, 96, 10, 32, False), (16, 64, 6, 32, False)]
    rows = []
    for M, K, N, G, main in cases:
        x = torch.tensor(rng.standard_normal((M, K)), dtype=torch.float32,
                         device=dev)
        w = torch.tensor(rng.standard_normal((K, N)) * 0.05,
                         dtype=torch.float32, device=dev)
        packed, scale = quantize_int4(w, G)
        out = int4_matmul(x, packed, scale, group=G)
        ref = plain(x, packed, scale, G)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = INT4_RTOL * ref.abs() + INT4_RTOL * ref.abs().max()
        ok = bool(((out - ref).abs() <= tol).all())
        row = dict(shape=f"M={M} K={K} N={N} G={G}", max_abs_err=err,
                   ok=ok, main=main)
        if main:
            wd = dequantize_int4(packed, scale, torch.float32, G)
            row.update(timings(
                torch, lambda: int4_matmul(x, packed, scale, group=G),
                lambda: plain(x, packed, scale, G),
                lambda: torch.matmul(x, wd), 50 if M <= 16 else 10))
            nbytes = 4 * M * K + K * N // 2 + 4 * (K // G) * N + 4 * M * N
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * M * K * N)
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
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, plain
    # (b, sq, sk, h, hkv, dh, causal, window, q_offset, main)
    cases = [(B, PROMPT, PROMPT, 32, 4, 64, True, 0, 0, True),
             (2, 77, 77, 8, 2, 32, True, 0, 0, False),
             (2, 45, 65, 8, 2, 32, True, 13, 20, False),
             (1, 50, 70, 4, 4, 16, False, 0, 0, False),
             (2, 33, 33, 4, 1, 128, True, 0, 0, False)]
    rows = []
    for b, sq, sk, h, hkv, dh, causal, window, q_offset, main in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, k, v = mk(b, sq, h, dh), mk(b, sk, hkv, dh), mk(b, sk, hkv, dh)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        row = dict(shape=f"b={b} sq={sq} sk={sk} h={h} hkv={hkv} dh={dh} "
                   f"causal={causal} window={window} q_offset={q_offset}",
                   max_abs_err=err, ok=err <= ATTN_ATOL, main=main)
        if main:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row.update(timings(
                torch, lambda: flash_attention(q, k, v, **kw),
                lambda: plain(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 20))
            nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, _attn_flops(torch, sq, sk, h, dh, b, causal, window,
                                    q_offset))
        rows.append(row)
    return rows


def check_decode(torch, rng, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention, plain
    from repro_torch.core.kvstore import KV_LEN_BUCKET
    last = PROMPT + GEN - 2            # the last decode step's position
    S = -(-(last + 1) // KV_LEN_BUCKET) * KV_LEN_BUCKET
    # (b, S, h, hkv, dh, pos, main)
    cases = [(B, S, 32, 4, 64, [last] * B, True),
             (B, S, 32, 4, 64, [0, 37, S - 1, 100], False),
             (B, 100, 32, 4, 64, [0, 50, 99, 77], False),
             (3, 77, 8, 2, 32, [76, 0, 40], False),
             (2, 64, 4, 4, 16, [63, 5], False)]
    rows = []
    for b, S_, h, hkv, dh, pos, main in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, kc, vc = mk(b, h, dh), mk(b, S_, hkv, dh), mk(b, S_, hkv, dh)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, pos_t)
        ref = plain(q, kc, vc, pos_t)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} pos={pos}",
                   max_abs_err=err, ok=err <= ATTN_ATOL, main=main)
        if main:
            qt = q[:, :, None]
            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
            mask = (torch.arange(S_, device=dev)[None, :]
                    <= pos_t[:, None].long())[:, None, None]
            row.update(timings(
                torch, lambda: decode_attention(q, kc, vc, pos_t),
                lambda: plain(q, kc, vc, pos_t),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), 50))
            live = sum(p + 1 for p in pos)
            nbytes = 4 * (2 * q.numel() + 2 * live * hkv * dh) + 4 * b
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 4.0 * h * dh * live)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------

def make_plan(quant, pipeline):
    from repro_torch.serving.spec import ResolvedPlan
    return ResolvedPlan(
        arch="tinyllama-1.1b", scaled=False, engine="offloaded", b_max=B,
        max_len=MAX_LEN, seed=0, placement="host", pipeline=pipeline,
        quant=quant, kv_mode="fp32", fused_int4=True, moe_quant=None,
        warm=pipeline == "performance", depth=1, depth_policy="static",
        spill_cap=32, cache_on="host", disk_root="",
        block_bytes=8 * 2**20, n_io_threads=3, cold_reads=False,
        sim_bw=None, draft_arch=None, spec_k=None)


def generate_once(torch, ops, lm, name, prompt, expect):
    """One main-path ``generate`` on a fresh trace (the engine's trace
    otherwise accumulates across calls), its launch counts zeroed before
    and read after; fails on bad tokens or a kernel launched too
    rarely."""
    from repro_torch.core.tasks import Trace
    lm.trace = Trace()
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = lm.generate(prompt, GEN)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    if toks.shape != (B, GEN) or not ((toks >= 0) & (toks < 32000)).all():
        raise RuntimeError(f"run {name}: bad tokens {toks.shape}")
    for k, n in expect.items():
        if counts[k] < n:
            raise RuntimeError(f"run {name}: {k} launched {counts[k]} "
                               f"times, expected >= {n}")
    return toks, stats, counts


def run_main(torch, ops, name, plan, prompt, expect):
    """``REPEATS`` runs on one engine (medians and every value of the
    end-to-end metrics), then one profiled ``PROFILE_GEN``-token run for
    the card's busy share."""
    from repro_torch.serving.spec import build_lm
    t0 = time.perf_counter()
    lm = build_lm(plan)
    build_s = time.perf_counter() - t0
    runs = [generate_once(torch, ops, lm, name, prompt, expect)
            for _ in range(REPEATS)]
    toks, _, counts = runs[0]
    keys = ("throughput_tok_s", "decode_tok_s", "ttft_s", "total_s",
            "compute_busy")
    stats = [s for _, s, _ in runs]
    pk = stats[0]["pipeline"]["per_kind"]
    summary = {
        "run": name, "plan": f"quant={plan.quant} pipeline={plan.pipeline} "
        f"depth={plan.depth} placement={plan.placement} cache_on="
        f"{plan.cache_on}", "build_s": build_s, "repeats": REPEATS,
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
    return lm, toks, counts


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the kernel checks")
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
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")

    # 3. kernels vs plain versions
    rng = np.random.default_rng(0)
    checks = {"int4_matmul": check_int4(torch, rng, dev),
              "flash_attention": check_flash(torch, rng, dev),
              "decode_attention": check_decode(torch, rng, dev)}
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

    # 4. the main path, three configurations
    prompt = rng.integers(0, 32000, (B, PROMPT)).astype(np.int32)
    n_layers = 22
    attn_expect = {"flash_attention": n_layers,
                   "decode_attention": n_layers * (GEN - 1)}
    int4_expect = {**attn_expect, "int4_matmul": 7 * n_layers * GEN}
    lm, _, counts_a = run_main(torch, ops, "a", make_plan(
        None, "performance"), prompt, attn_expect)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    lm, toks_b, counts_b = run_main(torch, ops, "b", make_plan(
        "int4", "performance"), prompt, int4_expect)

    # 5. the whole path against the plain versions, same weights
    whole_path_check(torch, ops, lm, prompt, toks_b)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    lm, _, counts_c = run_main(torch, ops, "c", make_plan(
        "int4", "sequential"), prompt, int4_expect)
    del lm

    # 6. the kernels line (launches: run (b), the slice's configuration)
    kernels = []
    for name, rows in checks.items():
        m = next(r for r in rows if r["main"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts_b[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "call_ms": m["call_ms"],
            "parity": "ok", "launches_run_a": counts_a[name],
            "launches_run_c": counts_c[name]})
    torch.cuda.synchronize()
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
