#!/usr/bin/env python3
"""Where ``int4_matmul``'s decode kernel spends its time, and what its
bf16 tensor-core path's choices cost, on the card.

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
3. The bf16 tensor-core path (bf16 x, M > 16: ``int4_tc_bf16_kernel``):
   at run (aa)'s prefill (M 512, 2048x5632) and the 8B's M 128
   (4096x14336), the device time per call under the plan's K split and
   the other splits, with text-patched copies of the kernel whose ring
   holds 4, 6 (the kernel's) or 8 stages, beside the f32 instance on the
   widened x and ``torch.matmul`` at bf16 on the dequantized weights.
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
from repro_torch.kernels.int4_matmul import _ARGS, decode_plan  # noqa: E402
from repro_torch.kernels.int4_matmul import SMEM_MAX, decode_smem  # noqa: E402
from repro_torch.kernels.int4_matmul import int4_matmul, prefill_plan  # noqa: E402
from repro_torch.quant.int4 import dequantize_int4, quantize_int4  # noqa: E402

SHAPES = [(4, 2048, 2048), (4, 2048, 256), (4, 2048, 5632), (4, 5632, 2048)]
TC_SHAPES = [(512, 2048, 5632), (128, 4096, 14336)]   # (M, K, N), bf16 x
STAGES = (4, 6, 8)              # ring stages of the bf16 path's copies
# (phase boundary, source text the stamp goes before; the last one, after)
MARKS = [("start", "  // 1. the slice into shared memory"),
         ("landed", "  // 2. each thread: 16 columns of rows tr, tr + rp, ..."),
         ("summed", "  // 3. rows of one warp that share columns"),
         ("warps", "  // 4. the warps summed in order"),
         ("sent", "  cluster.sync();\n  for (int el = tid"),
         ("barrier", "  for (int el = tid; el < per_rank"),
         ("end", "    store(out + (size_t)(m0 + m) * N + n, s);\n  }\n")]
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


def build(src: str, name: str):
    out = _build.build_dir() / "int4_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"int4_phases: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out / f"lib{name}.so"))
    lib.int4_matmul_launch.argtypes = _ARGS
    lib.int4_matmul_launch.restype = ctypes.c_int
    if hasattr(lib, "read_stamps"):
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def staged_source(stages: int) -> str:
    """The kernel with the bf16 path's ring at ``stages`` stages."""
    src = (_build.CSRC / "int4_matmul.cu").read_text()
    anchor = "constexpr int BT_STAGES = 6;"
    if src.count(anchor) != 1:
        raise RuntimeError(f"int4_phases: no single anchor {anchor!r}")
    return src.replace(anchor, f"constexpr int BT_STAGES = {stages};")


def tc_bf16(n_sms: int):
    """Part 3: the bf16 tensor-core path's K splits and ring depths."""
    gen = torch.Generator().manual_seed(1)
    libs = {st: build(staged_source(st), f"stages{st}") for st in STAGES}
    for M, K, N in TC_SHAPES:
        x = torch.randn(M, K, generator=gen).to(torch.bfloat16).cuda()
        packed, scale = quantize_int4(
            (torch.randn(K, N, generator=gen) * 0.05).cuda(), 128)
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        plan = prefill_plan(M, K, N, 128, n_sms)
        stream = torch.cuda.current_stream().cuda_stream
        flags = 8 * int((N // 2) % 16 == 0)
        ref = int4_matmul(x, packed, scale)
        row = {}
        for st, lib in libs.items():
            for splits in sorted({1, 2, 4, 8, plan[0]}):
                gps = -(-(K // 128) // splits)
                splits_ = -(-(K // 128) // gps)
                f = lambda: lib.int4_matmul_launch(  # noqa: E731
                    x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), M, K, N, 128, 0, splits_, gps, flags, 1,
                    stream)
                if f():
                    raise RuntimeError("int4_phases: launch failed")
                torch.cuda.synchronize()
                same = bool(torch.equal(out, ref)) if (splits_, st) == (
                    plan[0], 6) else None
                mark = " (plan)" if (splits_ == plan[0] and st == 6) else ""
                row[f"stages={st} splits={splits_}{mark}"] = (
                    device_ms(f), same)
        wd = dequantize_int4(packed, scale, torch.bfloat16, 128)
        xf = x.float()
        print(f"bf16 x M={M} K={K} N={N}: device ms per call")
        for k, (ms, same) in row.items():
            print(f"  {k}: {ms:.5f}" + ("" if same is None
                                         else f" (equal to the wrapper's: {same})"))
        print(f"  f32 instance on the widened x: "
              f"{device_ms(lambda: int4_matmul(xf, packed, scale)):.5f}")
        print(f"  torch.matmul at bf16: "
              f"{device_ms(lambda: torch.matmul(x, wd)):.5f}")


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
    lib = build(stamped_source(), "phases")
    launch = _build.launcher("int4_matmul", "int4_matmul_launch", _ARGS)
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
                                128, lg_, splits, gps, 7, 0, stream)
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
    tc_bf16(n_sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
