// Fused INT4-dequant matmul for Hopper (sm_90a).
//
//   out (M, N) f32 = x (M, K) f32 @ W,  W[k, n] = (nibble(k, n) - 8) * scale[k / G, n]
//
// packed (K, N/2) uint8 holds column pairs: column 2j in the low nibble of
// byte j, column 2j+1 in the high nibble (the JAX package's quant/int4.py
// layout).  Replaces the TPU kernel src/repro/kernels/int4_matmul.py:
// int4_matmul (body _kernel), whose grid walked K sequentially with an
// accumulator in VMEM.
//
// What bounds it on this card, and what the design does about it:
//  * Decode (M = batch < 16) is a matrix-vector product: it reads K*N/2
//    packed bytes once and does 2*M*K*N flops, far below the card's
//    flop-per-byte balance, so it is bound by bytes.  Packed bytes are the
//    only weight traffic: each lane loads 4 packed bytes (8 columns) per
//    row and unpacks the nibbles in registers.  A matrix this small
//    (<= 6 MB) cannot fill 132 SMs with one block per column tile, so K is
//    split across blocks in whole quantization groups; a second small
//    kernel sums the slices in a fixed order (deterministic, no atomics).
//  * Prefill (M = batch * prompt) is bound by fp32 operations (the
//    slice runs in fp32: no tensor cores, whose TF32 would cost the
//    1e-5 tolerance).  A classic shared-memory tiled SGEMM: 64x64 output
//    tiles, 32-deep K steps, 4x4 outputs per thread; each K step dequantizes
//    its 32x64 weight tile once into shared memory for all 64 rows.
// Tails in M, N and K are masked; K % G == 0 and an even N are required.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- small M: split-K matrix-vector ----------------------------------------
constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_MT = 4;                        // rows of x per block
constexpr int GV_BYTES = 4;                     // packed bytes per lane
constexpr int GV_COLS = 32 * GV_BYTES * 2;      // 256 output columns per block

__global__ void __launch_bounds__(GV_THREADS)
int4_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, float* __restrict__ partial,
                 int M, int K, int N, int group, int groups_per_split, int vec) {
  const int N2 = N / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pc0 = blockIdx.x * (32 * GV_BYTES) + lane * GV_BYTES;  // packed col
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * GV_MT;
  const int g_begin = split * groups_per_split;
  const int g_end = min(K / group, g_begin + groups_per_split);

  float acc[GV_MT][2 * GV_BYTES];
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * GV_BYTES; ++j) acc[m][j] = 0.f;

  const bool full = vec && (pc0 + GV_BYTES <= N2);
  for (int g = g_begin; g < g_end; ++g) {
    float sc[2 * GV_BYTES];
#pragma unroll
    for (int j = 0; j < 2 * GV_BYTES; ++j) {
      const int n = 2 * pc0 + j;
      sc[j] = n < N ? __ldg(scale + (size_t)g * N + n) : 0.f;
    }
    for (int r = warp; r < group; r += GV_WARPS) {
      const int k = g * group + r;
      const uint8_t* prow = packed + (size_t)k * N2 + pc0;
      uint32_t word;
      if (full) {
        word = __ldg(reinterpret_cast<const uint32_t*>(prow));
      } else {
        word = 0x88888888u;                     // nibble 8 dequantizes to 0
#pragma unroll
        for (int j = 0; j < GV_BYTES; ++j)
          if (pc0 + j < N2)
            word = (word & ~(0xFFu << (8 * j))) | ((uint32_t)__ldg(prow + j) << (8 * j));
      }
      float xv[GV_MT];
#pragma unroll
      for (int m = 0; m < GV_MT; ++m)
        xv[m] = (m0 + m < M) ? __ldg(x + (size_t)(m0 + m) * K + k) : 0.f;
#pragma unroll
      for (int j = 0; j < GV_BYTES; ++j) {
        const uint32_t byte = (word >> (8 * j)) & 0xFFu;
        const float w0 = (float)((int)(byte & 0xFu) - 8) * sc[2 * j];
        const float w1 = (float)((int)(byte >> 4) - 8) * sc[2 * j + 1];
#pragma unroll
        for (int m = 0; m < GV_MT; ++m) {
          acc[m][2 * j] = fmaf(xv[m], w0, acc[m][2 * j]);
          acc[m][2 * j + 1] = fmaf(xv[m], w1, acc[m][2 * j + 1]);
        }
      }
    }
  }

  // sum the 8 warps' row slices: red[warp][m][j][lane] (padded rows)
  __shared__ float red[GV_WARPS][GV_MT][2 * GV_BYTES][33];
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * GV_BYTES; ++j) red[warp][m][j][lane] = acc[m][j];
  __syncthreads();
  const int c = threadIdx.x;                    // output column in the tile
  const int n = blockIdx.x * GV_COLS + c;
  const int src_lane = c / (2 * GV_BYTES), src_j = c % (2 * GV_BYTES);
#pragma unroll
  for (int m = 0; m < GV_MT; ++m) {
    if (m0 + m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < GV_WARPS; ++w) s += red[w][m][src_j][src_lane];
    partial[((size_t)split * M + (m0 + m)) * N + n] = s;
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * MN + i];
  out[i] = s;
}

// ---- large M: tiled SGEMM with the weight tile dequantized in smem -----------
constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int GM_THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(GM_THREADS)
int4_gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int K, int N, int group) {
  __shared__ float As[BM][BK + 1];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int N2 = N / 2;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 64 rows x 32 cols, lanes along K (coalesced)
#pragma unroll
    for (int i = 0; i < (BM * BK) / GM_THREADS; ++i) {
      const int idx = tid + i * GM_THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.f;
    }
    // weight tile: 32 rows x 32 packed bytes, 4 bytes (8 columns) per thread
    {
      const int r = tid / 8, cb = (tid % 8) * 4;
      const int gk = k0 + r;
      const int g = gk / group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pc = n0 / 2 + cb + j;
        float w0 = 0.f, w1 = 0.f;
        if (gk < K && pc < N2) {
          const uint32_t byte = __ldg(packed + (size_t)gk * N2 + pc);
          w0 = (float)((int)(byte & 0xFu) - 8) * __ldg(scale + (size_t)g * N + 2 * pc);
          w1 = (float)((int)(byte >> 4) - 8) * __ldg(scale + (size_t)g * N + 2 * pc + 1);
        }
        Bs[r][2 * (cb + j)] = w0;
        Bs[r][2 * (cb + j) + 1] = w1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty * TM + i][kk];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// partial: (splits, M, N) scratch when splits > 1 (may alias out when 1).
int int4_matmul_launch(const float* x, const uint8_t* packed, const float* scale,
                       float* out, float* partial, int M, int K, int N, int group,
                       int splits, int groups_per_split, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    dim3 grid((N + GV_COLS - 1) / GV_COLS, splits, (M + GV_MT - 1) / GV_MT);
    int4_gemv_kernel<<<grid, GV_THREADS, 0, s>>>(
        x, packed, scale, splits > 1 ? partial : out, M, K, N, group,
        groups_per_split, vec);
    if (splits > 1) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      const int MN = M * N;
      splitk_reduce_kernel<<<(MN + 255) / 256, 256, 0, s>>>(partial, out, MN, splits);
    }
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int4_gemm_kernel<<<grid, GM_THREADS, 0, s>>>(x, packed, scale, out, M, K, N, group);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
