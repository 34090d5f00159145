#!/usr/bin/env python3
"""Where ``flash_attention``'s kernel spends its time, on the card.

    python3 tools/flash_phases.py        # one CUDA card and nvcc

1. Builds a copy of ``src/repro_torch/csrc/flash_attention.cu`` (under
   the git-ignored ``build/``) in which every warp sums its SM clock
   cycles per phase (``clock64``): the first K/V copies issued and Q's
   fragments loaded, waiting for a K/V tile (and issuing the next),
   Q.K on the tensor cores, the online softmax, P.V, the output; and its
   ``%globaltimer`` span.  Runs it once at the main-path shapes after an
   idle gap and prints, for the warps of the longest rows (the most
   tiles) and over all warps, the median cycles of each phase.
2. Prints the device time per call (``torch.profiler``) of the unchanged
   kernel with 1, 2 and 4 warps per block at each shape (the plan's
   choice marked), beside SDPA.  ``clocks.sm`` (``nvidia-smi``) turns
   cycles into time.
"""
from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line, device_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import _ARGS, flash_plan  # noqa: E402

# (b, sq, h, hkv, dh): generation prefill, serving prefill of one slot
SHAPES = [(4, 128, 32, 4, 64), (1, 37, 32, 4, 64), (1, 141, 32, 4, 64)]
PHASES = ["start", "tile_wait", "qk", "softmax", "pv", "output"]
# (phase that ends at this mark, source text the mark goes before)
MARKS = [(0, "  float o[NKS][4];"),
         (1, "    const float* ks_ = smem + (t % STAGES) * STAGE;"),
         (2, "    // mask by position, then the online softmax"),
         (3, "    // O += P V: k-step kk"),
         (4, "  }\n  cp_async_wait<0>();")]
SLOTS = 8                       # per warp: 6 phases, tiles, span (ns)
HEAD = ("{ long long t_ = clock64(); ph_[P] += t_ - tp_; tp_ = t_; }\n")


def stamped_source() -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    src = src.replace("namespace {\n", "__device__ long long stamps[8 * 65536];"
                      "\nnamespace {\n", 1)
    start = "                       float scale, int n_groups) {\n"
    end = ("          make_float2(o[dn][2] / l[1], o[dn][3] / l[1]);\n  }\n")
    for anchor in [start, end] + [a for _, a in MARKS]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"flash_phases: no single anchor {anchor!r}")
    src = src.replace(start, start + (
        "  long long ph_[6] = {0, 0, 0, 0, 0, 0}; long long tp_ = clock64();\n"
        "  unsigned long long g0_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
        " : \"=l\"(g0_));\n"))
    for p, anchor in MARKS:
        src = src.replace(anchor, HEAD.replace("P", str(p)) + anchor)
    src = src.replace(end, end + HEAD.replace("P", "5") + (
        "  { unsigned long long g1_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
        " : \"=l\"(g1_));\n"
        "    const size_t w_ = (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *"
        " gridDim.x + blockIdx.x) * (blockDim.x >> 5) + warp;\n"
        "    if (lane == 0 && w_ < 65536) {\n"
        "      for (int i = 0; i < 6; ++i) stamps[w_ * 8 + i] = ph_[i];\n"
        "      stamps[w_ * 8 + 6] = n_tiles;\n"
        "      stamps[w_ * 8 + 7] = (long long)(g1_ - g0_); } }\n"))
    return src + ('\nextern "C" int read_stamps(long long* h, int n)'
                  ' { return (int)cudaMemcpyFromSymbol(h, stamps, n * 8); }\n')


def build() -> ctypes.CDLL:
    out = _build.build_dir() / "flash_phases"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention_phases.cu"
    src.write_text(stamped_source())
    lib = out / "libflash_phases.so"
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    dll = ctypes.CDLL(str(lib))
    dll.flash_attention_launch.argtypes = _ARGS
    dll.flash_attention_launch.restype = ctypes.c_int
    dll.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.read_stamps.restype = ctypes.c_int
    return dll


def launch(fn, q, k, v, out, warps):
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             sk, h, hkv, dh, 1, 0, 0, 1.0 / math.sqrt(dh), warps,
             _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"launch failed: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    stamped = build()
    plain_fn = _build.launcher("flash_attention", "flash_attention_launch",
                               _ARGS)
    g = torch.Generator(device=dev).manual_seed(0)
    for b, sq, h, hkv, dh in SHAPES:
        q = torch.randn(b, sq, h, dh, device=dev, generator=g)
        k = torch.randn(b, sq, hkv, dh, device=dev, generator=g)
        v = torch.randn(b, sq, hkv, dh, device=dev, generator=g)
        out = torch.empty_like(q)
        w_plan, blocks = flash_plan(b, sq, h, hkv)
        print(f"\nshape b={b} sq={sq} h={h} hkv={hkv} dh={dh}: plan "
              f"{w_plan} warps, {blocks} blocks")
        launch(stamped.flash_attention_launch, q, k, v, out, w_plan)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)          # an idle gap, as in a run
        launch(stamped.flash_attention_launch, q, k, v, out, w_plan)
        torch.cuda.synchronize()
        n_warps = blocks * w_plan
        buf = (ctypes.c_longlong * (8 * n_warps))()
        if stamped.read_stamps(buf, 8 * n_warps):
            raise RuntimeError("read_stamps failed")
        rows = [list(buf[i * 8:(i + 1) * 8]) for i in range(n_warps)]
        most = max(r[6] for r in rows)
        for label, sel in (("longest rows", [r for r in rows if r[6] == most]),
                           ("all warps", rows)):
            med = {p: statistics.median(r[i] for r in sel)
                   for i, p in enumerate(PHASES)}
            span = statistics.median(r[7] for r in sel)
            print(f"  {label} ({len(sel)} warps, median tiles "
                  f"{statistics.median(r[6] for r in sel)}): cycles "
                  + ", ".join(f"{p} {med[p]:.0f}" for p in PHASES)
                  + f"; span {span / 1e3:.2f} us")
        for w in (1, 2, 4):
            if (h // hkv) % w:
                continue
            ms = device_ms(torch, lambda: launch(plain_fn, q, k, v, out, w),
                           20)
            print(f"  {w} warps per block: {ms:.5f} ms"
                  f"{'  (plan)' if w == w_plan else ''}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = device_ms(torch, lambda: torch.nn.functional.
                       scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                    enable_gqa=True), 20)
        print(f"  SDPA: {ms:.5f} ms")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"\nclocks (sm, max sm): {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
