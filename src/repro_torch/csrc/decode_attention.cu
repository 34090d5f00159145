// One-token GQA decode attention for Hopper (sm_90a).
//
//   q (b, h, dh) f32; k/v caches (b, S, hkv, dh) f32; pos (b,) int32
//   out[r, head] = softmax_{t <= pos[r]}(q . k_t / sqrt(dh)) @ v_t
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_kernel (body _kernel), which took a scalar pos, asserted
// S % block_s == 0 and walked S as a sequential grid axis with (m, l, acc)
// in VMEM scratch.  Here the loop over S runs inside the block.
//
// What bounds it on this card, and what the design does about it: it reads
// each live K and V row once and does ~4*h*dh flops per row, so it is bound
// by bytes.  One block serves one (batch row, kv head) and its g = h/hkv query
// heads, so each K/V row is read from memory once for all g heads.  Rows
// stream through shared memory in tiles of 32 positions, only up to pos[r]
// (rows past it are never read; a partial last tile is masked), with the
// online-softmax state (m, l) in shared memory and the g x dh accumulator in
// registers.  A fully masked history gives alpha = 0 and an output of 0.
// With b * hkv blocks the card is far from full at small batch; splitting
// S across blocks (flash-decoding) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 32;                 // positions per tile (one per lane)
constexpr int MAX_ACC = 32;              // g * dh <= THREADS * MAX_ACC
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                        const float* __restrict__ vc, const int* __restrict__ pos,
                        float* __restrict__ out, int S, int h, int hkv, int dh,
                        float scale) {
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int g = h / hkv;
  const int gd = g * dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                      // g * dh
  float* ks = qs + gd;                   // TILE * (dh + 1)
  float* vs = ks + TILE * (dh + 1);      // TILE * dh
  float* ps = vs + TILE * dh;            // g * TILE  scores, then probs
  float* ms = ps + g * TILE;             // g  running max
  float* ls = ms + g;                    // g  running denominator
  float* as = ls + g;                    // g  this tile's rescale

  const float* qb = q + ((size_t)bi * h + (size_t)kh * g) * dh;
  for (int i = tid; i < gd; i += THREADS) qs[i] = qb[i];
  for (int i = tid; i < g; i += THREADS) { ms[i] = NEG_INF; ls[i] = 0.f; }

  float acc[MAX_ACC];
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) acc[r] = 0.f;

  const int last = min(pos[bi], S - 1);  // attend rows 0..last
  const size_t row_stride = (size_t)hkv * dh;
  const float* kb = kc + (size_t)bi * S * row_stride + (size_t)kh * dh;
  const float* vb = vc + (size_t)bi * S * row_stride + (size_t)kh * dh;
  __syncthreads();

  for (int t0 = 0; t0 <= last; t0 += TILE) {
    const int nt = min(TILE, last - t0 + 1);
    for (int i = tid; i < TILE * dh; i += THREADS) {
      const int t = i / dh, d = i - t * dh;
      float kv = 0.f, vv = 0.f;
      if (t < nt) {
        const size_t off = (size_t)(t0 + t) * row_stride + d;
        kv = __ldg(kb + off);
        vv = __ldg(vb + off);
      }
      ks[t * (dh + 1) + d] = kv;
      vs[t * dh + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < g * TILE; i += THREADS) {
      const int gi = i / TILE, t = i - gi * TILE;
      float s = NEG_INF;
      if (t < nt) {
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(qs[gi * dh + d], ks[t * (dh + 1) + d], a);
        s = a * scale;
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NWARPS) {
      const float s = ps[gi * TILE + lane];
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < nt ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[gi * TILE + lane] = p;
      if (lane == 0) {
        const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = m_new;
        as[gi] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_ACC; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < gd) {
        const int gi = idx / dh, d = idx - gi * dh;
        float a = acc[r] * as[gi];
        for (int t = 0; t < nt; ++t) a = fmaf(ps[gi * TILE + t], vs[t * dh + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)bi * h + (size_t)kh * g) * dh;
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < gd) ob[idx] = acc[r] / fmaxf(ls[idx / dh], 1e-30f);
  }
}

}  // namespace

extern "C" {

int decode_attention_launch(const float* q, const float* k, const float* v,
                            const int* pos, float* out, int b, int S, int h,
                            int hkv, int dh, float scale, void* stream) {
  const int g = h / hkv;
  const size_t smem = sizeof(float) * ((size_t)g * dh + (size_t)TILE * (dh + 1) +
                                       (size_t)TILE * dh + (size_t)g * TILE + 3 * (size_t)g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, b);
  decode_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, pos, out, S, h, hkv, dh, scale);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
