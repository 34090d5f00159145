#!/usr/bin/env python3
"""Where the one-token decode step (``decode_attention`` and
``decode_attention_int4``) spends its time, and what its cluster size and
ring depth cost, on the card.

    python3 tools/decode_phases.py       # one CUDA card and nvcc

1. Builds a copy of ``src/repro_torch/csrc/decode_attention.cu`` (under
   the git-ignored ``build/``) in which thread 0 of every block reads
   ``%globaltimer`` and ``clock64`` at each phase boundary of the step in
   ``decode_attention_common.cuh`` (its ``DA_PHASE`` marks): set-up (the
   first copies issued, q loaded), ring wait (each tile's copies landed),
   scores, softmax, P.V, warp merge, cluster combine.  Runs it once at
   Gemma 3's global slab (bf16 q and caches, dh 256), whisper's cross rows
   (bf16, group 1) and tinyllama's generation step (f32) after an idle
   gap, and prints for each boundary the median and the latest stamp
   across blocks (from the first block's start), each phase's median and
   longest sum of SM cycles a block, and the stamped kernel's own time.
2. Prints the device time per call (``torch.profiler``) of the unchanged
   kernels at those shapes and at ``decode_attention_int4``'s (tinyllama
   serving, Gemma 3's packed slab) under the plan's cluster size
   (``CLUSTER``) and the other size (8 or 16), beside SDPA over the same
   rows.
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

from chip_smoke import _sdpa_decode, card_line, device_ms  # noqa: E402
from repro_torch.core.kvstore import (PackedRows, kv_group,  # noqa: E402
                                      quantize_kv_rows)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention_int4 as D4  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    _ARGS, CLUSTER, _launch, copy_bytes, row_stride)

# (label, b, S, h, hkv, dh, pos, q dtype, cache dtype)
SHAPES = [("gemma3-4b global bf16", 4, 1536, 8, 4, 256,
           [1515, 1031, 315, 129], torch.bfloat16, torch.bfloat16),
          ("whisper cross bf16", 4, 1500, 8, 8, 64, [1499] * 4,
           torch.bfloat16, torch.bfloat16),
          ("tinyllama f32", 4, 160, 32, 4, 64, [158] * 4, torch.float32,
           torch.float32)]
# (label, b, S, h, hkv, dh, pos, cache dtype): with the fresh row
INT4_SHAPES = [("tinyllama serving int4", 4, 160, 32, 4, 64,
                [159, 0, 77, 131], torch.bfloat16),
               ("gemma3-4b packed S=2048", 4, 2048, 8, 4, 256,
                [1515, 1031, 315, 129], torch.bfloat16)]
# boundary k of DA_PHASE(k), in the order a block passes them
PHASES = [(6, "set-up"), (0, "ring wait"), (1, "scores"), (2, "softmax"),
          (3, "P.V"), (4, "warp merge"), (5, "cluster combine")]
SLOTS = 16                      # a block: start, 7 sums, 7 latest stamps
MAX_BLOCKS = 4096
PRELUDE = f"""#include <stdint.h>
__device__ unsigned long long da_stamps[{SLOTS * MAX_BLOCKS}];
__device__ __forceinline__ unsigned long long da_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define DA_PHASE(k) {{ da_sum_[k] += clock64() - da_c_; \\
  da_last_[k] = da_now(); da_c_ = clock64(); }}
#define DA_PHASE_BEGIN const unsigned long long da_t0_ = da_now(); \\
  long long da_c_ = clock64(); \\
  long long da_sum_[7] = {{0, 0, 0, 0, 0, 0, 0}}; \\
  unsigned long long da_last_[7] = {{0, 0, 0, 0, 0, 0, 0}};
#define DA_PHASE_END if (threadIdx.x == 0) {{ \\
  const size_t b_ = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x \\
      + blockIdx.x; \\
  if (b_ < {MAX_BLOCKS}) {{ unsigned long long* o_ = da_stamps + b_ * {SLOTS}; \\
    o_[0] = da_t0_; \\
    for (int i_ = 0; i_ < 7; ++i_) {{ o_[1 + i_] = da_sum_[i_]; \\
      o_[8 + i_] = da_last_[i_]; }} }} }}
"""
READ = ('\nextern "C" int read_stamps(unsigned long long* h, int n)'
        ' { return (int)cudaMemcpyFromSymbol(h, da_stamps, n * 8); }\n'
        'extern "C" int clear_stamps() { void* p; cudaError_t e = '
        'cudaGetSymbolAddress(&p, da_stamps); return (int)(e != cudaSuccess'
        ' ? e : cudaMemset(p, 0, sizeof(da_stamps))); }\n')


def build() -> ctypes.CDLL:
    out = _build.build_dir() / "decode_phases"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "decode_attention_phases.cu"
    src.write_text(PRELUDE + (_build.CSRC / "decode_attention.cu").read_text()
                   + READ)
    lib = out / "libdecode_phases.so"
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    dll = ctypes.CDLL(str(lib))
    dll.decode_attention_launch.argtypes = _ARGS
    dll.decode_attention_launch.restype = ctypes.c_int
    dll.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.read_stamps.restype = ctypes.c_int
    dll.clear_stamps.argtypes = []
    dll.clear_stamps.restype = ctypes.c_int
    return dll


def stamped_launch(dll, q, kc, vc, pos_t, out):
    """``_launch``'s call into the stamped library, at the plan's
    cluster size."""
    b, h, dh = q.shape
    _, S, hkv, _ = kc.shape
    err = dll.decode_attention_launch(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos_t.data_ptr(),
        out.data_ptr(), b, S, h, hkv, dh, int(kc.dtype == torch.bfloat16),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), CLUSTER,
        copy_bytes(dh * kc.element_size(), kc.data_ptr(), vc.data_ptr()),
        row_stride(q, "q"), 0, _build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"decode_phases: launch failed ({err})")


def print_stamps(dll, mhz: float):
    """The stamps of the blocks the last launch ran (the buffer was
    cleared before it: a block that ran has a start)."""
    buf = (ctypes.c_ulonglong * (SLOTS * MAX_BLOCKS))()
    if dll.read_stamps(buf, SLOTS * MAX_BLOCKS):
        raise RuntimeError("decode_phases: read_stamps failed")
    blocks = [r for r in (list(buf[i * SLOTS:(i + 1) * SLOTS])
                          for i in range(MAX_BLOCKS)) if r[0]]
    t0 = min(r[0] for r in blocks)
    print(f"  {len(blocks)} blocks; boundary: median / latest %globaltimer "
          f"stamp from the first start (us); phase: median / longest a "
          f"block in clock64 cycles (us at {mhz:.0f} MHz)")
    for k, name in PHASES:
        ends = [r[8 + k] - t0 for r in blocks if r[8 + k]]
        sums = [r[1 + k] for r in blocks if r[8 + k]]
        if not ends:
            print(f"    {name:16s} (no block passed it)")
            continue
        med, top = statistics.median(sums), max(sums)
        print(f"    {name:16s} {statistics.median(ends) / 1e3:8.2f} / "
              f"{max(ends) / 1e3:8.2f}   phase {med:9.0f} / {top:9.0f} "
              f"cycles ({med / mhz:6.2f} / {top / mhz:6.2f} us, "
              f"{len(ends)} blocks)")


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_phases: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    dll = build()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    g = torch.Generator(device=dev).manual_seed(0)
    other = 16 if CLUSTER == 8 else 8
    for label, b, S, h, hkv, dh, pos, qdt, cdt in SHAPES:
        q = torch.randn(b, h, dh, device=dev, generator=g).to(qdt)
        kc, vc = (torch.randn(b, S, hkv, dh, device=dev, generator=g).to(cdt)
                  for _ in range(2))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        print(f"\n{label}: b={b} S={S} h={h} hkv={hkv} dh={dh} pos={pos} "
              f"q {str(qdt)[6:]} cache {str(cdt)[6:]}")
        stamped_launch(dll, q, kc, vc, pos_t, out)
        torch.cuda.synchronize()
        if dll.clear_stamps():
            raise RuntimeError("decode_phases: clear_stamps failed")
        torch.cuda._sleep(50_000_000)          # an idle gap, as in a run
        stamped_launch(dll, q, kc, vc, pos_t, out)
        torch.cuda.synchronize()
        print_stamps(dll, mhz)
        ms = device_ms(torch, lambda: stamped_launch(dll, q, kc, vc, pos_t,
                                                     out), 20)
        print(f"  the stamped kernel: {ms:.5f} ms")
        for cluster in (CLUSTER, other):
            ms = device_ms(torch, lambda: _launch(q, kc, vc, pos_t, 0, out,
                                                  cluster), 20)
            print(f"  cluster {cluster}: {ms:.5f} ms"
                  + ("  (the plan)" if cluster == CLUSTER else ""))
        ms = device_ms(torch, _sdpa_decode(torch, q, kc.to(qdt), vc.to(qdt),
                                           pos_t), 20)
        print(f"  SDPA at {str(qdt)[6:]}: {ms:.5f} ms")
    for label, b, S, h, hkv, dh, pos, cdt in INT4_SHAPES:
        F = hkv * dh
        grp = kv_group(F)
        q = torch.randn(b, h, dh, device=dev, generator=g)
        kq, ks = quantize_kv_rows(torch.randn(b, S, F, device=dev,
                                              generator=g), grp)
        vq, vs = quantize_kv_rows(torch.randn(b, S, F, device=dev,
                                              generator=g), grp)
        kn, vn = (torch.randn(b, hkv, dh, device=dev, generator=g)
                  for _ in range(2))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        kw = dict(hkv=hkv, group=grp, k_new=kn, v_new=vn, cache_dtype=cdt)
        print(f"\n{label}: b={b} S={S} h={h} hkv={hkv} dh={dh} pos={pos} "
              f"fresh row, cache {str(cdt)[6:]}")
        for cluster in (CLUSTER, other):
            ms = device_ms(torch, lambda: D4._launch(
                q, kq, ks, vq, vs, pos_t, 0, out, **kw, cluster=cluster), 20)
            print(f"  cluster {cluster}: {ms:.5f} ms"
                  + ("  (the plan)" if cluster == CLUSTER else ""))
        kd, vd = (PackedRows(p_, s_, grp, cdt, (hkv, dh)).dequantize()
                  for p_, s_ in ((kq, ks), (vq, vs)))
        ms = device_ms(torch, _sdpa_decode(torch, q.to(cdt), kd, vd, pos_t),
                       20)
        print(f"  SDPA at {str(cdt)[6:]} over the dequantized rows: "
              f"{ms:.5f} ms")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                             "clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(f"\nclocks (sm, max sm): {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
