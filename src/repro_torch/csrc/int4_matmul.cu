// Fused INT4-dequant matmul for Hopper (sm_90a).
//
//   out (M, N) = x (M, K) @ W,  W[k, n] = (nibble(k, n) - 8) * scale[k / G, n]
//   x and out f32, or both bf16 (the bf16 instance; accumulation f32)
//
// packed (K, N/2) uint8 holds column pairs: column 2j in the low nibble of
// byte j, column 2j+1 in the high nibble (the JAX package's quant/int4.py
// layout).  Replaces the TPU kernel src/repro/kernels/int4_matmul.py:
// int4_matmul (body _kernel), whose grid walked K sequentially with an
// accumulator in VMEM.  Both paths split K in whole quantization groups
// across the blocks of one thread-block cluster (at most 8) and sum the
// slices from distributed shared memory in rank order, inside the one
// launch: deterministic, no atomics, no scratch in device memory.
//
// Decode (M <= 16, int4_gemv_kernel): bound by bytes.  A matrix-vector
// product reads K*N/2 packed bytes once for 2*M*K*N flops, far below the
// card's flop-per-byte balance.  Each block copies its whole slice (packed
// rows, x, scales) into shared memory with cp.async, every copy in flight
// at once, so the slice costs one memory round trip; threads then unpack 16
// columns of a row from one 8-byte shared load, nibbles to floats with the
// magic-number conversion (0x4B000000 | nibble is 2^23 + nibble), scales
// read once per group.  Rows that share columns are summed by warp
// shuffles and then across warps in warp order; each block sends its sums
// to the rank that owns them and, after one cluster barrier, every rank
// adds its inbox in rank order.  kernels/int4_matmul.py decode_plan picks
// the column tile (8 to 128 packed bytes) and the K split.  Where the time
// goes (tools/int4_phases.py, PERF.md): mostly to the unpacking and
// multiply-adds (about 8 instructions for 4 multiply-adds per weight),
// then to the copy round trip and the two reductions, not to the bytes.
//
// Prefill at f32 x (M > 16, int4_tc_kernel): bound by operations, run on the tensor
// cores (wgmma m64n128k8 TF32, f32 accumulation) at fp32 accuracy.  The
// weights are exact small integers q in [-8, 7], exact in TF32, so the
// scale factors out of each group's product:
//   out[m, n] = sum_g scale[g, n] * sum_{k in g} x[m, k] * q[k, n].
// x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi); each group's
// sum runs as two products (x_lo first, then x_hi) into a group
// accumulator, which folds into the output accumulator in registers at the
// group's end (acc = fma(scale, acc_g, acc)), groups in order.  One
// warpgroup per 64 x 128 output tile: raw x and packed tiles arrive through
// a 4-deep cp.async ring; each 32-deep k tile is converted into shared
// operand slabs (x_hi, x_lo, q in the K-major no-swizzle core-matrix
// layout) while the previous tile's wgmmas run.
// Error analysis: x_hi keeps 11 significant bits, x_lo the next 11, so
// |x - x_hi - x_lo| <= 2^-22 |x|; x_hi * q and x_lo * q (<= 15 bits) are
// exact, and the tensor core adds them in f32 (its internal alignment
// truncates, a relative error of a few 2^-23 per step).  Over a group of
// 128 terms that is ~1e-6 of sum |x q|, against the tolerance
// rtol 1e-5 + 1e-5 * max|ref| (tests/test_kernels.py:29); the CPU test
// test_torch_kernels.py emulates this arithmetic against the Pallas
// kernel at K = 2048 and 5632, and shows one term is not enough.  Bound:
// 2 TF32 terms at 495 TFLOP/s.
//
// ptxas (-Xptxas -v, sm_90a): registers, shared memory and spills are
// printed by chip_smoke.py from the build log and recorded in PERF.md.
//
// bf16 x (the TPU kernel takes "x (M, K) bf16/f32", widens it in its body
// and writes out_dtype): the bf16 instance reads x as raw 16 bits and
// writes the output in bf16, rounded to nearest even.  Decode (a template
// on x's element type XT) copies the raw bf16 slice into shared memory
// (half the bytes) and widens each x as it is used: it gives what widening
// x, the f32 instance and a cast back give.
//
// Prefill at bf16 x (M > 16, int4_tc_bf16_kernel): bf16 x and the nibbles
// -8..7 are both exact in bf16, so the function runs at the bf16
// tensor-core rate (the earlier design widened every x tile into a TF32
// slab and multiplied at the TF32 rate, 12-14x from that bound).  The
// products run on wgmma.m64nNk16.f32.bf16.bf16 with the roles swapped,
// out^T = W^T x^T: the weights are the A operand, converted from the packed
// bytes straight into registers, and x's rows are N (128, or 64 where M <=
// 64).  Each of two warpgroups owns 64 of the block's 128 output columns; a
// thread's two A rows stand for the two columns of one packed byte, so its
// k16 fragment is 4 byte loads, one byte permute and two fma.bf16x2 (bf16
// (0x4300 | v) is 128 + v, and fma(., 1, -136) is v - 8 exactly) - no
// converted slab makes a round trip through shared memory.  x tiles (64 k,
// one 128-byte row a row) arrive by TMA in the 128-byte swizzle, the wgmma's
// K-major layout; packed tiles by TMA in the 64-byte swizzle, so a warp's
// byte loads fall in distinct banks; a ring of 6 stages and one mbarrier a
// stage, 4 tiles ahead, one barrier a tile (8 stages measured no faster).  Two A fragment buffers
// alternate, so a tile converts while the last one's products run.  (On
// the H100, tools/int4_phases.py and PERF.md: copies issued by threads
// with cp.async took 40 % of the time, and a converted B slab's round trip
// through shared memory held the products to under half their rate.)
// Each group's products sum in an f32 group accumulator and fold into the
// output with the group's scales, in group order, as the f32 instance's;
// the K split (prefill_plan's partition of the groups) and its cluster sum
// are the same.  The products are exact and the sums f32; only the order in
// which the tensor core adds inside a k16 step differs from the k8 TF32
// steps, so the output is within one bf16 ulp of widening x, the f32
// instance and a cast back, not bit-equal by construction.  Requires G % 16
// == 0.
//
// Requires K % G == 0 and an even N; decode a power-of-two G, prefill
// G % 8 == 0.  Tails in M, N and K are masked.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

// ---- shared helpers -----------------------------------------------------------
__device__ __forceinline__ float nib_f(uint32_t v) {   // v in [0, 15] -> v - 8
  return __uint_as_float(0x4B000000u | v) - 8388616.0f;
}

// x and output elements (XT): f32 as they are; bf16 (raw 16 bits) widened
// on load, rounded to nearest even on store
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// cp.async of B bytes (16, 8 or 4) of which the first n come from src and
// the rest are zero
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(B), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- decode: M <= 16, split-K matrix-vector in one cluster --------------------
constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_MT = 4;            // rows of x per block
constexpr int GV_LB = 8;            // packed bytes per thread and row
constexpr int GV_C = 2 * GV_LB;     // columns per thread

// grid (column tiles, splits, ceil(M / 4)), cluster (1, splits, 1).  A
// block owns 2^lg_tpr * 8 packed bytes of every row of its K slice and
// copies the whole slice (weights, x, scales) into shared memory with
// cp.async, every copy in flight at once; 2^lg_tpr threads share a row and
// GV_THREADS / 2^lg_tpr rows are summed in parallel.  flags: bit 0 = packed rows
// in 16-byte (2^lg_tpr >= 2) or 8-byte chunks, else byte loads; bit 1 = x
// in 16-byte chunks; bit 2 = scales in 16-byte chunks.  Shared memory:
// gv_smem() (x's slice as XT, in a region sized for f32).
template <typename XT>
__global__ void __launch_bounds__(GV_THREADS)
int4_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, XT* __restrict__ out,
                 int M, int K, int N, int lg_group, int lg_tpr, int gps, int flags) {
  extern __shared__ __align__(16) uint8_t gsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tpr = 1 << lg_tpr;                  // threads per row
  const int rp = GV_THREADS >> lg_tpr;          // rows in parallel
  const int cb = tpr * GV_LB;                   // packed bytes per column tile
  const int cols = 2 * cb;                      // output columns per tile
  const int N2 = N / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tc = tid & (tpr - 1), tr = tid >> lg_tpr;
  const int m0 = blockIdx.z * GV_MT;
  const int n_groups = K >> lg_group;
  const int g_begin = min(n_groups, (int)blockIdx.y * gps);
  const int g_end = min(n_groups, g_begin + gps);
  const int k_begin = g_begin << lg_group;
  const int nk = (g_end - g_begin) << lg_group;
  const int nkp = gps << lg_group;              // rows reserved
  const int splits = (int)gridDim.y;
  const int per_rank = (GV_MT * cols + splits - 1) / splits;

  uint8_t* ws = gsm;                                          // [nkp][cb]
  XT* xs = reinterpret_cast<XT*>(ws + (size_t)nkp * cb);     // [GV_MT][nkp]
  float* ss = reinterpret_cast<float*>(ws + (size_t)nkp * cb) + (size_t)GV_MT * nkp;  // [gps][cols]
  float* wred = ss + (size_t)gps * cols;                      // [GV_WARPS][GV_MT][cols]
  float* inbox = wred + (size_t)GV_WARPS * GV_MT * cols;      // [splits][per_rank]

  // 1. the slice into shared memory, every copy in flight at once
  if (flags & 2) {
    constexpr int EPC = 16 / sizeof(XT);        // x elements per 16-byte copy
    const int c4 = nk / EPC;
    for (int i = tid; i < GV_MT * c4; i += GV_THREADS) {
      const int m = i / c4, c = (i - m * c4) * EPC;
      const bool ok = m0 + m < M;
      cp_async<16>(xs + m * nkp + c, ok ? x + (size_t)(m0 + m) * K + k_begin + c : x, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < GV_MT * nk; i += GV_THREADS) {
      const int m = i / nk, c = i - m * nk;
      xs[m * nkp + c] = m0 + m < M ? __ldg(x + (size_t)(m0 + m) * K + k_begin + c) : (XT)0;
    }
  }
  if (flags & 4) {
    const int c4 = cols >> 2;
    for (int i = tid; i < (g_end - g_begin) * c4; i += GV_THREADS) {
      const int gl = i / c4, c = (i - gl * c4) << 2;
      const int n0 = blockIdx.x * cols + c;
      const int n = max(0, min(4, N - n0)) * 4;
      cp_async<16>(ss + gl * cols + c, scale + (size_t)(g_begin + gl) * N + (n ? n0 : 0), n);
    }
  } else {
    for (int i = tid; i < (g_end - g_begin) * cols; i += GV_THREADS) {
      const int gl = i / cols, c = i - gl * cols;
      const int n = blockIdx.x * cols + c;
      ss[i] = n < N ? __ldg(scale + (size_t)(g_begin + gl) * N + n) : 0.f;
    }
  }
  const long long pcb = (long long)blockIdx.x * cb;   // the tile's first packed byte
  if ((flags & 1) && cb >= 16) {
    const int cpr = cb >> 4;
    for (int i = tid; i < nk * cpr; i += GV_THREADS) {
      const int r = i / cpr, c = (i - r * cpr) << 4;
      const int n = (int)max(0LL, min(16LL, (long long)N2 - pcb - c));
      cp_async<16>(ws + r * cb + c, packed + (size_t)(k_begin + r) * N2 + (n ? pcb + c : 0), n);
    }
  } else if (flags & 1) {
    for (int r = tid; r < nk; r += GV_THREADS) {
      const int n = (int)max(0LL, min(8LL, (long long)N2 - pcb));
      cp_async<8>(ws + r * cb, packed + (size_t)(k_begin + r) * N2 + (n ? pcb : 0), n);
    }
  } else {
    for (int i = tid; i < nk * cb; i += GV_THREADS) {
      const int r = i / cb, c = i - r * cb;
      ws[r * cb + c] = pcb + c < N2 ? __ldg(packed + (size_t)(k_begin + r) * N2 + pcb + c)
                                    : (uint8_t)0x88;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. each thread: 16 columns of rows tr, tr + rp, ...
  float acc[GV_MT][GV_C];
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int j = 0; j < GV_C; ++j) acc[m][j] = 0.f;
  if (pcb + tc * GV_LB < N2) {
    float sc[GV_C];
    int cur = -1;
#pragma unroll 4
    for (int r = tr; r < nk; r += rp) {
      const int gl = r >> lg_group;
      if (gl != cur) {
        cur = gl;
        const float4* sp = reinterpret_cast<const float4*>(ss + gl * cols + tc * GV_C);
#pragma unroll
        for (int j = 0; j < GV_C / 4; ++j) {
          const float4 s4 = sp[j];
          sc[4 * j] = s4.x; sc[4 * j + 1] = s4.y; sc[4 * j + 2] = s4.z; sc[4 * j + 3] = s4.w;
        }
      }
      const uint2 wv = *reinterpret_cast<const uint2*>(ws + r * cb + tc * GV_LB);
      const float x0 = to_f32(xs[r]), x1 = to_f32(xs[nkp + r]), x2 = to_f32(xs[2 * nkp + r]),
                  x3 = to_f32(xs[3 * nkp + r]);
#pragma unroll
      for (int j = 0; j < GV_C; ++j) {
        const uint32_t word = j < 8 ? wv.x : wv.y;
        const float w = nib_f((word >> (4 * (j & 7))) & 0xFu) * sc[j];
        acc[0][j] = fmaf(x0, w, acc[0][j]);
        acc[1][j] = fmaf(x1, w, acc[1][j]);
        acc[2][j] = fmaf(x2, w, acc[2][j]);
        acc[3][j] = fmaf(x3, w, acc[3][j]);
      }
    }
  }

  // 3. rows of one warp that share columns (lane = tc + tpr * row):
  // butterfly; each warp's sums to shared memory
  for (int o = 16; o >= tpr; o >>= 1) {         // 64 independent shuffles a round
#pragma unroll
    for (int m = 0; m < GV_MT; ++m)
#pragma unroll
      for (int j = 0; j < GV_C; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  }
  if (lane < tpr) {
#pragma unroll
    for (int m = 0; m < GV_MT; ++m)
#pragma unroll
      for (int j = 0; j < GV_C; j += 4)
        *reinterpret_cast<float4*>(wred + (warp * GV_MT + m) * cols + tc * GV_C + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
  __syncthreads();

  // 4. the warps summed in order, each sum sent to the rank that writes its
  // output; after one cluster barrier every rank sums its inbox in rank order
  const int rank = (int)cluster.block_rank();
  for (int e = tid; e < GV_MT * cols; e += GV_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < GV_WARPS; ++wi) s += wred[wi * GV_MT * cols + e];
    const int owner = e / per_rank;
    cluster.map_shared_rank(inbox, owner)[rank * per_rank + e - owner * per_rank] = s;
  }
  cluster.sync();
  for (int el = tid; el < per_rank; el += GV_THREADS) {
    const int e = rank * per_rank + el;
    if (e >= GV_MT * cols) break;
    const int m = e / cols, c = e - m * cols;
    const int n = blockIdx.x * cols + c;
    if (m0 + m >= M || n >= N) continue;
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += inbox[p * per_rank + el];
    store(out + (size_t)(m0 + m) * N + n, s);
  }
}

size_t gv_smem(int group, int lg_tpr, int gps) {
  const size_t cb = (size_t)GV_LB << lg_tpr, cols = 2 * cb, nkp = (size_t)gps * group;
  return nkp * cb + sizeof(float) * (GV_MT * nkp + gps * cols + (GV_WARPS + 1) * GV_MT * cols + 8);
}

// ---- prefill: M > 16, wgmma over exact integer weights --------------------------
constexpr int WG_M = 64, WG_N = 128, WG_K = 32;
constexpr int WG_THREADS = 128;                 // one warpgroup
constexpr int WG_RAW = 4;                       // raw tiles in flight (cp.async ring)
constexpr int WG_XLD = WG_K + 4;                // raw x row: f32, padded by 4 floats
constexpr int WG_CA = WG_M * 8;                 // floats of one A slab (64 rows x 8 k)
constexpr int WG_CB = WG_N * 8;                 // floats of one B slab (128 rows x 8 k)
constexpr int RED_LD = WG_N + 4;

// Operand slabs for one k8 step, 64 (A) or 128 (B) rows x 8 k, tf32, in the
// K-major no-swizzle core-matrix layout: 8 rows x 16 bytes per core matrix,
// the two k halves 128 bytes apart (LBO), row blocks 256 bytes apart (SBO).
__device__ __forceinline__ int wg_off(int row, int k) {
  return (row >> 3) * 64 + (k >> 2) * 32 + (row & 7) * 4 + (k & 3);
}

// the no-swizzle descriptor: LBO 128 bytes (the next core matrix along K),
// SBO 256 bytes (the next 8 rows along M or N)
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

struct WgSmem {
  float x[WG_RAW][WG_M][WG_XLD];                // raw x tiles (cp.async ring)
  uint8_t p[WG_RAW][WG_K][WG_N / 2];            // raw packed tiles
  float ahi[2][WG_K / 8][WG_CA];                // tf32(x), two tiles in flight
  float alo[2][WG_K / 8][WG_CA];                // tf32(x - tf32(x))
  alignas(16) float b[2][WG_K / 8][WG_CB];      // q, exact
};

__device__ __forceinline__ void wg_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, this thread's 64) = A (64 x 8) * B (8 x 128) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

__device__ __forceinline__ void wg_load(WgSmem& sm, int st, const float* x, const uint8_t* packed,
                                        int M, int K, int N2, int m0, int n0, int k0,
                                        int k_end, int bvec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (WG_M * WG_K / 4) / WG_THREADS; ++i) {
    const int c = tid + i * WG_THREADS;
    const int r = c / (WG_K / 4), kc = (c % (WG_K / 4)) * 4;
    const bool ok = m0 + r < M && k0 + kc < k_end;
    cp_async<16>(&sm.x[st][r][kc], ok ? x + (size_t)(m0 + r) * K + k0 + kc : x, ok ? 16 : 0);
  }
  if (bvec) {
    if (tid < WG_K * (WG_N / 2) / 16) {
      const int r = tid / (WG_N / 32), bc = (tid % (WG_N / 32)) * 16;
      const bool ok = k0 + r < k_end && n0 / 2 + bc < N2;
      cp_async<16>(&sm.p[st][r][bc], ok ? packed + (size_t)(k0 + r) * N2 + n0 / 2 + bc : packed,
                   ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < WG_K * (WG_N / 2); i += WG_THREADS) {
      const int r = i / (WG_N / 2), bc = i % (WG_N / 2);
      const bool ok = k0 + r < k_end && n0 / 2 + bc < N2;
      sm.p[st][r][bc] = ok ? __ldg(packed + (size_t)(k0 + r) * N2 + n0 / 2 + bc) : (uint8_t)0x88;
    }
  }
}

// split K, once every rank of the cluster wrote its slice of the (rows x
// WG_N) output tile to red (RED_LD floats a row): the slices summed in rank
// order from distributed shared memory, each rank writing its share
template <typename XT>
__device__ __forceinline__ void cluster_sum(float* red, XT* out, int M, int N, int m0, int n0,
                                            int rows) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)gridDim.z;
  const int rank = (int)cluster.block_rank();
  for (int e = rank * (int)blockDim.x + (int)threadIdx.x; e < rows * WG_N;
       e += splits * (int)blockDim.x) {
    const int r = e / WG_N, c = e - r * WG_N;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      v[p] = p < splits ? cluster.map_shared_rank(red, p)[r * RED_LD + c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (p < splits) s += v[p];
    store(out + (size_t)m * N + n, s);
  }
  cluster.sync();
}

// grid (ceil(N / 128), ceil(M / 64), splits), cluster (1, 1, splits); one
// warpgroup per 64 x 128 output tile of f32 x.  bvec: 16-byte packed tile
// copies.
__global__ void __launch_bounds__(WG_THREADS)
int4_tc_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int N, int group, int gps, int bvec) {
  extern __shared__ __align__(128) uint8_t wsm[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>(wsm);
  const int N2 = N / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * WG_M, n0 = blockIdx.x * WG_N;
  const int n_groups = K / group;
  const int g_begin = min(n_groups, (int)blockIdx.z * gps);
  const int g_end = min(n_groups, g_begin + gps);
  const int k_begin = g_begin * group, k_end = g_end * group;
  const int n_tiles = (k_end - k_begin + WG_K - 1) / WG_K;

  // accumulator element i: row 16 warp + gq + 8 ((i >> 1) & 1), column
  // 8 (i >> 2) + 2 tq + (i & 1)
  float acc[64], accg[64], sc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = accg[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

#pragma unroll
  for (int r = 0; r < WG_RAW - 1; ++r) {
    if (r < n_tiles) wg_load(sm, r, x, packed, M, K, N2, m0, n0, k_begin + r * WG_K, k_end, bvec);
    cp_async_commit();
  }
  int kg = 0, g = g_begin;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, rs = t % WG_RAW;
    const int k0 = k_begin + t * WG_K;
    if (t + WG_RAW - 1 < n_tiles)
      wg_load(sm, (t + WG_RAW - 1) % WG_RAW, x, packed, M, K, N2, m0, n0,
              k0 + (WG_RAW - 1) * WG_K, k_end, bvec);
    cp_async_commit();
    cp_async_wait<WG_RAW - 1>();
    // the slabs of tile t - 2 are free once at most one group is in flight
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncthreads();
    // convert: x -> (tf32 hi, tf32 lo), packed -> q, into the operand slabs
#pragma unroll
    for (int i = 0; i < (WG_M * WG_K / 4) / WG_THREADS; ++i) {
      const int c = tid + i * WG_THREADS;
      const int r = c % WG_M, kq = (c / WG_M) * 4;   // 8 lanes: 8 rows of a core
      const int o = wg_off(r, kq & 7);
      const float4 v = *reinterpret_cast<const float4*>(&sm.x[rs][r][kq]);
      const float vs[4] = {v.x, v.y, v.z, v.w};
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __uint_as_float(to_tf32(vs[e]));
        lo[e] = __uint_as_float(to_tf32(vs[e] - hi[e]));
      }
      *reinterpret_cast<float4*>(&sm.ahi[st][kq >> 3][o]) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(&sm.alo[st][kq >> 3][o]) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
#pragma unroll
    for (int i = 0; i < (WG_K / 4) * (WG_N / 2) / WG_THREADS; ++i) {
      const int u = tid + i * WG_THREADS;
      const int bc = u % (WG_N / 2), kq = (u / (WG_N / 2)) * 4;
      float lo4[4], hi4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t byte = sm.p[rs][kq + e][bc];
        lo4[e] = nib_f(byte & 0xFu);
        hi4[e] = nib_f(byte >> 4);
      }
      *reinterpret_cast<float4*>(&sm.b[st][kq >> 3][wg_off(2 * bc, kq & 7)]) =
          make_float4(lo4[0], lo4[1], lo4[2], lo4[3]);
      *reinterpret_cast<float4*>(&sm.b[st][kq >> 3][wg_off(2 * bc + 1, kq & 7)]) =
          make_float4(hi4[0], hi4[1], hi4[2], hi4[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // tile t's products, asynchronous: they run while tile t + 1 converts
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WG_K / 8; ++kk) {
      if (k0 + kk * 8 < k_end) {
        if (kg == 0) {                               // a group starts: its scales
#pragma unroll
          for (int j = 0; j < WG_N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + 8 * j + 2 * tq + e;
              sc[2 * j + e] = n < N ? __ldg(scale + (size_t)g * N + n) : 0.f;
            }
        }
        wgmma_tf32(accg, wg_desc(sm.alo[st][kk]), wg_desc(sm.b[st][kk]), kg != 0);
        wgmma_tf32(accg, wg_desc(sm.ahi[st][kk]), wg_desc(sm.b[st][kk]), 1);
        kg += 8;
        if (kg == group) {                           // the group ends: fold it
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          wg_fence_acc(accg);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = fmaf(sc[2 * (i >> 2) + (i & 1)], accg[i], acc[i]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          kg = 0;
          ++g;
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(accg);
  cp_async_wait<0>();

  if (gridDim.z == 1) {
#pragma unroll
    for (int j = 0; j < WG_N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * warp + gq + 8 * h;
        const int n = n0 + 8 * j + 2 * tq;
        if (m >= M) continue;
        if (n + 1 < N) {
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else if (n < N) {
          store(out + (size_t)m * N + n, acc[4 * j + 2 * h]);
        }
      }
    return;
  }
  // split K: this slice into red, then the cluster's sum
  float* red = reinterpret_cast<float*>(wsm);     // WG_M x RED_LD floats
  static_assert(sizeof(WgSmem) >= sizeof(float) * WG_M * RED_LD, "red fits");
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = 16 * warp + gq + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
    red[r * RED_LD + c] = acc[i];
  }
  cluster_sum(red, out, M, N, m0, n0, WG_M);
}

// ---- prefill at bf16 x: wgmma bf16, the weights in registers ------------------
constexpr int BT_K = 64;                        // k a tile: one 128-byte row of bf16 x
constexpr int BT_THREADS = 256;                 // two warpgroups, 64 columns each
constexpr int BT_STAGES = 6;                    // ring stages (tiles in flight: 4)

// TM rows of x (64 or 128: the wgmma's N) land by TMA as 128-byte rows in
// the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), the wgmma
// K-major B layout (8-row groups 1024 bytes apart); raw packed tiles land
// by TMA as 64 k rows of 64 bytes in the 64-byte swizzle (16-byte chunk c
// of row k at c ^ ((k / 2) % 4)), so that each thread's four byte loads of
// a k16 step fall in distinct banks across its warp
template <int TM>
struct BtSmem {
  uint16_t x[BT_STAGES][TM * BT_K];
  uint8_t p[BT_STAGES][BT_K * WG_N / 2];
  uint64_t full[BT_STAGES];                     // a stage's TMA bytes arrived
};
constexpr size_t BT_ALIGN = 1024;               // the 128-byte swizzle's atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the K-major 128-byte-swizzle descriptor: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return ((uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// two k-adjacent packed bytes (lo in bits 0-7, hi in bits 16-23) -> their
// low nibbles and their high nibbles as bf16 pairs (nibble - 8): bf16
// (0x4300 | v) is 128 + v, and fma(., 1, -136) is v - 8 exactly
__device__ __forceinline__ void q_pairs(uint32_t t, uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 one = __floats2bfloat162_rn(1.f, 1.f);
  const __nv_bfloat162 off = __floats2bfloat162_rn(-136.f, -136.f);
  uint32_t l = (t & 0x000F000Fu) | 0x43004300u, h = ((t >> 4) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 lb = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&l), one, off);
  __nv_bfloat162 hb = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&h), one, off);
  lo = *reinterpret_cast<uint32_t*>(&lb);
  hi = *reinterpret_cast<uint32_t*>(&hb);
}

// d (64 x TM f32) = A (64 x 16 bf16, registers) * B (16 x TM bf16, K-major
// smem) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// what a block of the bf16 path knows of its slice and of this thread
struct BtCtx {
  int k_begin, k_end, n_tiles, group, N, n_even, jb, tq;
  const float* scale;
};

// One k tile t of the bf16 path: wait until tile t - 2's products are done
// (the last reads of qa and of tile t - 2's stage), refill that stage, wait
// for tile t's bytes, convert this thread's A fragments of the tile's four
// k16 steps into qa while tile t - 1's products run, then issue the tile's
// products, folding each group that ends into acc with its scales.
template <int TM, typename Load>
__device__ __forceinline__ void bt_tile(BtSmem<TM>& sm, Load& load, const BtCtx& c, int t,
                                        uint32_t (&qa)[BT_K / 16][4], float (&acc)[TM / 2],
                                        float (&accg)[TM / 2], float (&sc)[2], int& kg, int& g) {
  constexpr int R = TM / 2, AHEAD = BT_STAGES - 2;
  const int st = t % BT_STAGES, k0 = c.k_begin + t * BT_K;
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  __syncthreads();
  if (t + AHEAD < c.n_tiles) load(t + AHEAD);   // into tile t - 2's stage
  mbar_wait(&sm.full[st], (t / BT_STAGES) & 1);   // tile t landed
  // rows (columns n_even, n_even + 1) x k 2 tq, + 1, + 8, + 9 of each step
  const uint8_t* pt = sm.p[st];
#pragma unroll
  for (int kk = 0; kk < BT_K / 16; ++kk) {
    uint32_t b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * kk + 2 * c.tq + (e & 1) + 8 * (e >> 1);
      b[e] = pt[k * (WG_N / 2) + (c.jb ^ (((k >> 1) & 3) << 4))];
    }
    q_pairs(b[0] | (b[1] << 16), qa[kk][0], qa[kk][1]);
    q_pairs(b[2] | (b[3] << 16), qa[kk][2], qa[kk][3]);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BT_K / 16; ++kk) {
    if (k0 + kk * 16 < c.k_end) {
      if (kg == 0) {                                 // a group starts: its scales
        sc[0] = c.n_even < c.N ? __ldg(c.scale + (size_t)g * c.N + c.n_even) : 0.f;
        sc[1] = c.n_even + 1 < c.N ? __ldg(c.scale + (size_t)g * c.N + c.n_even + 1) : 0.f;
      }
      wgmma_rs(accg, qa[kk], sw128_desc(reinterpret_cast<const uint8_t*>(sm.x[st]) + kk * 32),
               kg != 0);
      kg += 16;
      if (kg == c.group) {                           // the group ends: fold it
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(accg);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = fmaf(sc[(i >> 1) & 1], accg[i], acc[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        kg = 0;
        ++g;
      }
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// out^T = W^T x^T: the weights are the wgmma's A operand, 64 output columns
// n a warpgroup, in registers; x's rows are its N.  Warp w of warpgroup wg
// holds A rows 16 w + gid and 16 w + gid + 8, which stand for the columns n
// = 64 wg + 16 w + 2 gid and n + 1, the two nibbles of one packed byte, so
// each thread converts the 8 values of its k16 fragment from 4 bytes.
// grid (ceil(N / 128), ceil(M / TM), splits), cluster (1, 1, splits).  tmx:
// x (M, K) bf16, box (64, TM), 128-byte swizzle; tmp: packed (K, N/2), box
// (64, 64), 64-byte swizzle, when bvec (N/2 a multiple of 16); else every
// thread copies its share of the packed bytes into the same layout.
template <int TM>
__global__ void __launch_bounds__(BT_THREADS, 1)
int4_tc_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmp,
                    const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                    uint16_t* __restrict__ out, int M, int K, int N, int group, int gps,
                    int bvec) {
  constexpr int R = TM / 2;                     // accumulators a thread
  constexpr int AHEAD = BT_STAGES - 2;          // tiles in flight
  extern __shared__ __align__(16) uint8_t bsm_raw[];
  uint8_t* bsm = bsm_raw + ((BT_ALIGN - (smem_u32(bsm_raw) & (BT_ALIGN - 1))) & (BT_ALIGN - 1));
  BtSmem<TM>& sm = *reinterpret_cast<BtSmem<TM>*>(bsm);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int gid = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * WG_N;
  const int n_groups = K / group;
  const int g_begin = min(n_groups, (int)blockIdx.z * gps);
  const int g_end = min(n_groups, g_begin + gps);
  const int k_begin = g_begin * group, k_end = g_end * group;
  const int n_tiles = (k_end - k_begin + BT_K - 1) / BT_K;
  const int jb = 32 * wg + 8 * warp + gid;     // this thread's packed byte column
  const int n_even = n0 + 2 * jb;               // its A rows' columns: n_even, + 1

  if (tid == 0) {
    for (int i = 0; i < BT_STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&sm.full[i])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t into stage t % BT_STAGES: thread 0 asks TMA for x (and the
  // packed bytes when bvec), the stage's barrier expecting their bytes
  const int N2 = N / 2;
  auto load = [&](int t) {
    const int st = t % BT_STAGES, k0 = k_begin + t * BT_K;
    if (tid == 0) {
      // the stage's earlier byte reads (generic) before TMA's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_u32(&sm.full[st])),
                   "r"(TM * BT_K * 2 + (bvec ? BT_K * WG_N / 2 : 0))
                   : "memory");
      tma_2d(sm.x[st], &tmx, k0, m0, &sm.full[st]);
      if (bvec) tma_2d(sm.p[st], &tmp, n0 / 2, k0, &sm.full[st]);
    }
    if (!bvec) {
      for (int u = tid; u < BT_K * (WG_N / 2); u += BT_THREADS) {
        const int r = u / (WG_N / 2), c = u % (WG_N / 2);
        const bool ok = k0 + r < k_end && n0 / 2 + c < N2;
        sm.p[st][r * (WG_N / 2) + (c ^ (((r >> 1) & 3) << 4))] =
            ok ? __ldg(packed + (size_t)(k0 + r) * N2 + n0 / 2 + c) : (uint8_t)0x88;
      }
    }
  };

  // accumulator element i: A row 16 warp + gid + 8 ((i >> 1) & 1), that is
  // column n_even + ((i >> 1) & 1); x row 8 (i >> 2) + 2 tq + (i & 1)
  float acc[R], accg[R], sc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = accg[i] = 0.f;

  for (int t = 0; t < AHEAD && t < n_tiles; ++t) load(t);
  const BtCtx ctx = {k_begin, k_end, n_tiles, group, N, n_even, jb, tq, scale};
  // two A fragment buffers, tiles alternating: a tile's conversion writes
  // the one tile t - 2's products (done) read, while tile t - 1's run
  uint32_t qa[BT_K / 16][4], qb[BT_K / 16][4];
  int kg = 0, g = g_begin;
  for (int t = 0; t < n_tiles; t += 2) {
    bt_tile(sm, load, ctx, t, qa, acc, accg, sc, kg, g);
    if (t + 1 < n_tiles) bt_tile(sm, load, ctx, t + 1, qb, acc, accg, sc, kg, g);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(accg);

  if (gridDim.z == 1) {
    if (n_even < N) {
#pragma unroll
      for (int i = 0; i < R; i += 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * (i >> 2) + 2 * tq + e;
          if (m >= M) continue;
          if (n_even + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n_even) =
                __floats2bfloat162_rn(acc[i + e], acc[i + 2 + e]);
          } else {
            store(out + (size_t)m * N + n_even, acc[i + e]);
          }
        }
    }
    return;
  }
  // split K: this slice into red (x rows by output columns), then the
  // cluster's sum
  float* red = reinterpret_cast<float*>(bsm);   // TM x RED_LD floats
  static_assert(sizeof(BtSmem<TM>) >= sizeof(float) * TM * RED_LD, "red fits");
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i)
    red[(8 * (i >> 2) + 2 * tq + (i & 1)) * RED_LD + 2 * jb + ((i >> 1) & 1)] = acc[i];
  cluster_sum(red, out, M, N, m0, n0, TM);
}

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kernel, dim3 grid, dim3 block, dim3 cluster,
                           size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D tensor map of rows x cols elements, rows `pitch` bytes apart
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                       uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
                       uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// the bf16 tensor-core path with TM rows a block (its own record of the
// shared memory it allowed)
template <int TM>
cudaError_t launch_bf16(const uint16_t* x, const uint8_t* packed, const float* scale,
                        uint16_t* out, int M, int K, int N, int group, int splits, int gps,
                        int bvec, cudaStream_t s) {
  const size_t smem = sizeof(BtSmem<TM>) + BT_ALIGN;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_tc_bf16_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  CUtensorMap tmx, tmp;
  memset(&tmp, 0, sizeof(tmp));
  cudaError_t e = tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2,
                             BT_K, TM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess && bvec)
    e = tensor_map(&tmp, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, N / 2, K, N / 2, WG_N / 2, BT_K,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  dim3 grid((N + WG_N - 1) / WG_N, (M + TM - 1) / TM, splits);
  return launch_cluster(int4_tc_bf16_kernel<TM>, grid, dim3(BT_THREADS), dim3(1, 1, splits),
                        smem, s, tmx, tmp, packed, scale, out, M, K, N, group, gps, bvec);
}

// one instance's launch (its own record of the shared memory it allowed)
template <typename XT>
cudaError_t launch_xt(const XT* x, const uint8_t* packed, const float* scale, XT* out, int M,
                      int K, int N, int group, int lg_tpr, int splits, int gps, int flags,
                      cudaStream_t s) {
  cudaError_t e;
  if (M <= 16) {                                // group is a power of two
    int lg_group = 0;
    while ((1 << lg_group) < group) ++lg_group;
    const int cols = GV_C << lg_tpr;
    const size_t smem = gv_smem(group, lg_tpr, gps);
    static size_t smem_set = 48 * 1024;
    if (smem > smem_set) {
      e = cudaFuncSetAttribute(int4_gemv_kernel<XT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      smem_set = smem;
    }
    dim3 grid((N + cols - 1) / cols, splits, (M + GV_MT - 1) / GV_MT);
    e = launch_cluster(int4_gemv_kernel<XT>, grid, dim3(GV_THREADS), dim3(1, splits, 1),
                       smem, s, x, packed, scale, out, M, K, N, lg_group, lg_tpr,
                       gps, flags & 7);
  } else if constexpr (sizeof(XT) == 4) {
    static bool smem_set = false;
    if (!smem_set) {
      e = cudaFuncSetAttribute(int4_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(WgSmem));
      if (e != cudaSuccess) return e;
      smem_set = true;
    }
    dim3 grid((N + WG_N - 1) / WG_N, (M + WG_M - 1) / WG_M, splits);
    e = launch_cluster(int4_tc_kernel, grid, dim3(WG_THREADS), dim3(1, 1, splits),
                       sizeof(WgSmem), s, x, packed, scale, out, M, K, N, group, gps,
                       (flags >> 3) & 1);
  } else if (M <= WG_M) {                       // bf16 x: 64 rows a block
    e = launch_bf16<WG_M>(x, packed, scale, out, M, K, N, group, splits, gps,
                          (flags >> 3) & 1, s);
  } else {                                      // 128 rows a block
    e = launch_bf16<2 * WG_M>(x, packed, scale, out, M, K, N, group, splits, gps,
                              (flags >> 3) & 1, s);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Decode (M <= 16, a power-of-two group): lg_tpr, splits and gps from
// decode_plan; flags bits 0-2 as int4_gemv_kernel's.  Prefill: splits and
// gps from prefill_plan (bf16 x: group % 16 == 0); flags bit 3 = 16-byte
// packed tile copies.  x_bf16: 0 for f32 x and
// output, 1 for bf16 (passed as raw 16 bits).
int int4_matmul_launch(const void* x, const uint8_t* packed, const float* scale, void* out,
                       int M, int K, int N, int group, int lg_tpr, int splits, int gps,
                       int flags, int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && M > 16 && group % 16) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return (int)launch_xt(static_cast<const uint16_t*>(x), packed, scale,
                          static_cast<uint16_t*>(out), M, K, N, group, lg_tpr, splits, gps,
                          flags, s);
  return (int)launch_xt(static_cast<const float*>(x), packed, scale, static_cast<float*>(out),
                        M, K, N, group, lg_tpr, splits, gps, flags, s);
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
