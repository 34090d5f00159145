#!/usr/bin/env python3
"""Where ``flash_attention``'s kernel spends its time, and what each block
layout costs, on the card.

    python3 tools/flash_phases.py        # one CUDA card and nvcc

1. Builds a copy of ``src/repro_torch/csrc/flash_attention.cu`` (under
   the git-ignored ``build/``) in which every warp of the f32 instance
   sums its SM clock cycles per phase (``clock64``): the first K/V copies
   issued and Q's fragments loaded, waiting for a K/V tile (and issuing
   the next, or skipping a tile the warp's rows do not attend), Q.K on the
   tensor cores, the online softmax, P.V, the output (with a key split:
   the ranks' merge); and its ``%globaltimer`` span.  Runs it once at the
   main-path shapes under the plan after an idle gap and prints, for the
   warps of the longest rows (the most tiles) and over all warps, the
   median cycles of each phase.
2. Prints the device time per call (``torch.profiler``) of the unchanged
   kernel, f32 and bf16, under each block layout at each shape: the plan
   ``flash_plan`` picks (marked), the one-tile layout (the most of 4, 2, 1
   heads dividing the group, one row tile, no split), and 4 and 8 warps
   a block with key splits 1 to 8 where shared memory allows, beside
   SDPA.
   ``clocks.sm`` (``nvidia-smi``) turns cycles into time.
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

from chip_smoke import _sdpa_args, card_line, device_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _ARGS, SMEM_MAX, _launch, flash_plan, smem_bytes)

# (b, sq, sk, h, hkv, dh, causal, window, q_offset): generation prefill,
# serving prefill of one slot, whisper's encoder and cross prefill (group
# 1), DeepSeek-V3's MLA prefill (group 1, dh 192), Gemma 3's window
# (group 2, dh 256), a short chunk over a long prefix
SHAPES = [(4, 128, 128, 32, 4, 64, True, 0, 0),
          (1, 141, 141, 32, 4, 64, True, 0, 0),
          (1, 1500, 1500, 8, 8, 64, False, 0, 0),
          (1, 48, 1500, 8, 8, 64, False, 0, 0),
          (1, 114, 114, 128, 128, 192, True, 0, 0),
          (1, 1500, 1500, 8, 4, 256, True, 1024, 0),
          (1, 32, 1500, 32, 8, 128, True, 0, 1468)]
PHASES = ["start", "tile_wait", "qk", "softmax", "pv", "output"]
# (phase that ends at this mark, source text the mark goes before), in the
# f32 instance
MARKS = [(0, "  float o[NKS][4];"),
         (1, "    const float* ks_ = smem + (t % NST) * STAGE;"),
         (2, "    // mask by position, then the online softmax"),
         (3, "    // O += P V: k-step kk"),
         (4, "  }\n  cp_async_wait<0>();")]
SLOTS = 8                       # per warp: 6 phases, tiles, span (ns)
HEAD = ("{ long long t_ = clock64(); ph_[P] += t_ - tp_; tp_ = t_; }\n")


def stamped_source() -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    cut = src.index("// ---- the bf16 instance")
    f32, rest = src[:cut], src[cut:]
    f32 = f32.replace("namespace {\n", "__device__ long long stamps[8 * 65536];"
                      "\nnamespace {\n", 1)
    start = "flash_attention_kernel(const Params p) {\n"
    end = "  finish<DH, float>(p, s, o, m, l, smem);\n"
    for anchor in [start, end] + [a for _, a in MARKS]:
        if f32.count(anchor) != 1:
            raise RuntimeError(f"flash_phases: no single anchor {anchor!r}")
    f32 = f32.replace(start, start + (
        "  long long ph_[6] = {0, 0, 0, 0, 0, 0}; long long tp_ = clock64();\n"
        "  unsigned long long g0_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
        " : \"=l\"(g0_));\n"))
    for p, anchor in MARKS:
        f32 = f32.replace(anchor, HEAD.replace("P", str(p)) + anchor)
    f32 = f32.replace(end, end + HEAD.replace("P", "5") + (
        "  { unsigned long long g1_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
        " : \"=l\"(g1_));\n"
        "    const size_t w_ = (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *"
        " gridDim.x + blockIdx.x) * (blockDim.x >> 5) + warp;\n"
        "    if (lane == 0 && w_ < 65536) {\n"
        "      for (int i = 0; i < 6; ++i) stamps[w_ * 8 + i] = ph_[i];\n"
        "      stamps[w_ * 8 + 6] = max(0, min(s.wt1, s.t0 + s.n - 1)"
        " - max(s.wt0, s.t0) + 1);\n"
        "      stamps[w_ * 8 + 7] = (long long)(g1_ - g0_); } }\n"))
    return f32 + rest + (
        '\nextern "C" int read_stamps(long long* h, int n)'
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


def stamped_launch(fn, q, k, v, out, kw, plan):
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             sk, h, hkv, dh, int(kw["causal"]), kw["window"], kw["q_offset"],
             1.0 / math.sqrt(dh), *plan, 0, _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"launch failed: {err}")


def smem_fits(dtype, dh: int, warps: int, splits: int) -> bool:
    """Whether a block of ``warps`` warps fits the shared memory."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return smem_bytes(dh, itemsize, warps, splits) <= SMEM_MAX


def layouts(dtype, b, sq, sk, h, hkv, dh, causal, window, q_offset):
    """{label: plan} to time at one shape."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    wh, wr, splits, blocks = flash_plan(b, sq, sk, h, hkv, causal, window,
                                        q_offset, dh=dh,
                                        itemsize=torch.tensor(
                                            [], dtype=dtype).element_size(),
                                        n_sms=n_sms)
    g = h // hkv
    one = next(w for w in (4, 2, 1) if g % w == 0)
    out = {f"plan wh={wh} wr={wr} splits={splits} ({blocks} blocks)":
           (wh, wr, splits)}
    if (one, 1, 1) != (wh, wr, splits):
        out[f"one-tile wh={one} wr=1"] = (one, 1, 1)
    for warps in (4, 8):
        for s in (1, 2, 4, 8):
            lay = (wh, warps // wh, s)
            if lay not in out.values() and smem_fits(dtype, dh, warps, s):
                out[f"wh={wh} wr={warps // wh} splits={s}"] = lay
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    stamped = build()
    g = torch.Generator(device=dev).manual_seed(0)
    for b, sq, sk, h, hkv, dh, causal, window, q_offset in SHAPES:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        q = torch.randn(b, sq, h, dh, device=dev, generator=g)
        k = torch.randn(b, sk, hkv, dh, device=dev, generator=g)
        v = torch.randn(b, sk, hkv, dh, device=dev, generator=g)
        out = torch.empty_like(q)
        plan = flash_plan(b, sq, sk, h, hkv, causal, window, q_offset, dh=dh)
        print(f"\nshape b={b} sq={sq} sk={sk} h={h} hkv={hkv} dh={dh} "
              f"causal={causal} window={window} q_offset={q_offset}: plan "
              f"wh={plan[0]} wr={plan[1]} splits={plan[2]}, {plan[3]} blocks")
        fn = stamped.flash_attention_launch
        stamped_launch(fn, q, k, v, out, kw, plan[:3])
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)          # an idle gap, as in a run
        stamped_launch(fn, q, k, v, out, kw, plan[:3])
        torch.cuda.synchronize()
        n_warps = plan[3] * plan[0] * plan[1]
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
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            od = torch.empty_like(qd)
            for label, lay in layouts(dtype, b, sq, sk, h, hkv, dh, causal,
                                      window, q_offset).items():
                ms = device_ms(torch, lambda: _launch(
                    qd, kd, vd, od, causal, window, q_offset, lay), 20)
                print(f"  {str(dtype)[6:]} {label}: {ms:.5f} ms")
            s_args, s_kw = _sdpa_args(torch, qd, kd, vd, causal, window,
                                      q_offset)
            qt, kt, vt, mask = s_args
            ms = device_ms(torch, lambda: torch.nn.functional.
                           scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=mask, **s_kw), 20)
            print(f"  {str(dtype)[6:]} SDPA: {ms:.5f} ms")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"\nclocks (sm, max sm): {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
