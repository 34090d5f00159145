#!/usr/bin/env python3
"""Where ``int4_matmul``'s decode kernel spends its time, on the card.

    python3 tools/int4_phases.py         # one CUDA card and nvcc

1. Builds a copy of ``src/repro_torch/csrc/int4_matmul.cu`` (under the
   git-ignored ``build/``) with a ``%globaltimer`` stamp from each block at
   every phase boundary of ``int4_gemv_kernel``, runs the kernel once at
   each decode shape after an idle gap, and prints for each boundary the
   median and the latest time across blocks, from the first block's start.
2. Prints the device time per call (``torch.profiler``) of the unchanged
   kernel at the plan ``decode_plan`` picks and at the next narrower
   column tile (twice the blocks), beside ``torch.matmul`` on the
   dequantized weights.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.int4_matmul import decode_plan, decode_smem  # noqa: E402
from repro_torch.kernels.int4_matmul import SMEM_MAX, int4_matmul  # noqa: E402
from repro_torch.quant.int4 import dequantize_int4, quantize_int4  # noqa: E402

SHAPES = [(4, 2048, 2048), (4, 2048, 256), (4, 2048, 5632), (4, 5632, 2048)]
# (phase boundary, source text the stamp goes before; the last one, after)
MARKS = [("start", "  // 1. the slice into shared memory"),
         ("landed", "  // 2. each thread: 16 columns of rows tr, tr + rp, ..."),
         ("summed", "  // 3. rows of one warp that share columns"),
         ("warps", "  // 4. the warps summed in order"),
         ("sent", "  cluster.sync();\n  for (int el = tid"),
         ("barrier", "  for (int el = tid; el < per_rank"),
         ("end", "    out[(size_t)(m0 + m) * N + n] = s;\n  }\n")]
STAMP = ("{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
         ": \"=l\"(t_)); if (threadIdx.x == 0) stamps[(blockIdx.y * gridDim.x "
         "+ blockIdx.x) * 8 + P] = t_; }\n")


def stamped_source() -> str:
    src = (_build.CSRC / "int4_matmul.cu").read_text()
    src = src.replace("namespace {\n", "__device__ unsigned long long "
                      "stamps[8 * 4096];\nnamespace {\n", 1)
    for p, (_, anchor) in enumerate(MARKS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"int4_phases: no single anchor {anchor!r}")
        stamp = STAMP.replace("P", str(p))
        src = (src.replace(anchor, anchor + stamp) if p == len(MARKS) - 1
               else src.replace(anchor, stamp + anchor))
    return src + ('\nextern "C" int read_stamps(unsigned long long* h, int n)'
                  ' { return (int)cudaMemcpyFromSymbol(h, stamps, n * 8); }\n')


def build():
    out = _build.build_dir() / "int4_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "phases.cu").write_text(stamped_source())
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out / "libphases.so"), str(out / "phases.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"int4_phases: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out / "libphases.so"))
    lib.int4_matmul_launch.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def device_ms(fn, iters=50) -> float:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("int4_phases: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build()
    launch = _build.launcher("int4_matmul", "int4_matmul_launch",
                             lib.int4_matmul_launch.argtypes)
    gen = torch.Generator().manual_seed(0)
    print(torch.cuda.get_device_name(0))
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen).to(dev)
        packed, scale = quantize_int4(
            (torch.randn(K, N, generator=gen) * 0.05).to(dev), 128)
        out = torch.empty(M, N, device=dev)
        lg, splits, gps = decode_plan(M, K, N, 128, n_sms)
        stream = torch.cuda.current_stream().cuda_stream
        args = lambda f, lg_: f(x.data_ptr(), packed.data_ptr(),  # noqa: E731
                                scale.data_ptr(), out.data_ptr(), M, K, N,
                                128, lg_, splits, gps, 7, stream)
        for _ in range(10):
            args(lib.int4_matmul_launch, lg)
        torch.cuda._sleep(1_000_000)
        args(lib.int4_matmul_launch, lg)
        torch.cuda.synchronize()
        blocks = -(-(N // 2) // (8 << lg)) * splits
        buf = (ctypes.c_ulonglong * (8 * blocks))()
        lib.read_stamps(buf, 8 * blocks)
        t = [[buf[b * 8 + p] for p in range(len(MARKS))]
             for b in range(blocks)]
        t0 = min(r[0] for r in t)
        print(f"M={M} K={K} N={N} lg_tpr={lg} splits={splits} "
              f"blocks={blocks}: ns from the first block's start, "
              f"median / latest block")
        for p, (name, _) in enumerate(MARKS):
            v = [r[p] - t0 for r in t]
            print(f"  {name:8s} {statistics.median(v):8.0f} {max(v):8.0f}")
        wd = dequantize_int4(packed, scale, torch.float32, 128)
        row = {"torch.matmul": device_ms(lambda: torch.matmul(x, wd)),
               f"plan lg_tpr={lg}": device_ms(lambda: int4_matmul(
                   x, packed, scale))}
        if lg > 0 and decode_smem(128, lg - 1, gps) <= SMEM_MAX:
            row[f"lg_tpr={lg - 1} ({2 * blocks} blocks)"] = device_ms(
                lambda: args(launch, lg - 1))
        print("  device ms per call: " + ", ".join(
            f"{k} {v:.5f}" for k, v in row.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
