// One-token GQA decode attention for Hopper (sm_90a).
//
//   q (b, h, dh) f32 or bf16 (row stride q_rs); k/v caches (b, S, hkv, dh)
//   f32 or bf16; pos (b,) int32, or null and every row at pos0
//   out[r, head] = softmax_{t <= pos[r]}(q . k_t / sqrt(dh)) @ v_t   (q's type)
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_kernel (body _kernel), which took a scalar pos, asserted
// S % block_s == 0 and walked S as a sequential grid axis with (m, l, acc)
// in VMEM scratch.
//
// What bounds it on this card, and what the design does about it: it reads
// each live K and V row once and does ~4*h*dh flops per row, so it is bound
// by bytes, and at decode sizes (~1.3 MB at f32, b = 4, S = 160) by
// latency: one block per (row, kv head) is 16 blocks on 132 SMs, each
// walking the whole sequence.  So the sequence is spread over the card:
// flash-decoding over a
// thread-block cluster, shared with decode_attention_int4.cu through
// decode_attention_common.cuh (its header has the scores, the softmax, P.V
// and the in-launch combine of the ranks' partials).  What is this file's
// own is how a chunk is staged: every thread loads one 16-byte piece of a K
// or V row (a float4 of f32, or 8 bf16 widened to f32 exactly as they
// load) into the chunk's f32 tile; rows past pos[r] are never read.  All
// arithmetic stays f32.  A bf16 q is read and the bf16 output written by the
// kernel itself (decode_attention_common.cuh), as the TPU kernel widens q in
// its body and writes q.dtype: instances over (q, cache) in {f32, bf16}^2.
#include <stdint.h>

#include "decode_attention_common.cuh"

namespace {

// vec cache elements (p aligned to vec) into f32: f32 as is; bf16 (raw 16
// bits) into the top half
__device__ __forceinline__ void load_vec(float (&x)[8], const float* p, int vec) {
  if (vec == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if (vec == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = __ldg(p);
  }
}

__device__ __forceinline__ void load_vec(float (&x)[8], const uint16_t* p, int vec) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (vec == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else if (vec == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = a.x; w[1] = a.y;
  } else if (vec == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(p);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

// grid (hkv, b, C), cluster (1, 1, C)
template <int HPW, int DPL, typename T, typename QT>
__global__ void __launch_bounds__(da::THREADS)
decode_attention_kernel(const QT* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ pos,
                        QT* __restrict__ out, int S, int h, int hkv, int dh, float scale,
                        int cpr, int vec, int q_rs, int pos0) {
  extern __shared__ __align__(16) float smem[];
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int g = h / hkv;
  const int p = pos != nullptr ? pos[bi] : pos0;
  const size_t rs = (size_t)hkv * dh;
  const T* kb = kc + (size_t)bi * S * rs + (size_t)kh * dh;
  const T* vb = vc + (size_t)bi * S * rs + (size_t)kh * dh;
  const int nvec = dh / vec;

  auto stage = [&](const da::Smem& sm, int t0, int nt) {
    // one vec-element piece of a K or V row per thread
    for (int i = threadIdx.x; i < 2 * nt * nvec; i += da::THREADS) {
      const int tensor = i / (nt * nvec);
      const int rem = i - tensor * nt * nvec;
      const int t = rem / nvec, d0 = (rem - t * nvec) * vec;
      float x[8];
      load_vec(x, (tensor == 0 ? kb : vb) + (size_t)(t0 + t) * rs + d0, vec);
      float* dst = tensor == 0 ? sm.ks + t * (dh + 1) + d0 : sm.vs + t * dh + d0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < vec) dst[j] = x[j];
    }
  };
  da::decode_block<HPW, DPL>(smem, q + (size_t)bi * q_rs + (size_t)kh * g * dh,
                        out + ((size_t)bi * h + (size_t)kh * g) * dh,
                        max(0, min(p + 1, S)), g, dh, scale, cpr, stage);
}

template <int DPL, typename T, typename QT>
cudaError_t launch(const QT* q, const void* k, const void* v, const int* pos, QT* out,
                   int b, int S, int h, int hkv, int dh, float scale, int n_ranks, int cpr,
                   int vec, int q_rs, int pos0, cudaStream_t s) {
  const int g = h / hkv;
  const dim3 grid(hkv, b, n_ranks);
  const size_t smem = da::smem_bytes(g, dh);
  const int hpw = (g + da::NWARPS - 1) / da::NWARPS;
  const T* kc = static_cast<const T*>(k);
  const T* vc = static_cast<const T*>(v);
#define DA_LAUNCH(H)                                                                     \
  da::launch_cluster(decode_attention_kernel<H, DPL, T, QT>, grid, smem, s, q, kc, vc, pos,  \
                     out, S, h, hkv, dh, scale, cpr, vec, q_rs, pos0)
  return hpw <= 1 ? DA_LAUNCH(1) : hpw <= 2 ? DA_LAUNCH(2) : hpw <= 4 ? DA_LAUNCH(4)
                                                                      : DA_LAUNCH(8);
#undef DA_LAUNCH
}

template <typename T, typename QT>
cudaError_t launch_dh(const QT* q, const void* k, const void* v, const int* pos,
                      QT* out, int b, int S, int h, int hkv, int dh, float scale,
                      int n_ranks, int cpr, int vec, int q_rs, int pos0, cudaStream_t s) {
  if (dh > da::MAX_DH) return cudaErrorInvalidValue;
  return da::dpl_for(dh) == 4
             ? launch<4, T, QT>(q, k, v, pos, out, b, S, h, hkv, dh, scale, n_ranks, cpr, vec,
                                q_rs, pos0, s)
             : launch<8, T, QT>(q, k, v, pos, out, b, S, h, hkv, dh, scale, n_ranks, cpr, vec,
                                q_rs, pos0, s);
}

}  // namespace

extern "C" {

// n_ranks blocks per (row, kv head), each walking cpr chunks of 32
// positions; vec = cache elements per load (f32: 4, 2, 1; bf16: 8, 4, 2,
// 1); cache_bf16 / q_bf16: 0 for f32 caches / q and output, 1 for bf16
// (passed as raw 16 bits); dh at most 256.
int decode_attention_launch(const void* q, const void* k, const void* v, const int* pos,
                            void* out, int b, int S, int h, int hkv, int dh, int cache_bf16,
                            int q_bf16, float scale, int n_ranks, int cpr, int vec, int q_rs,
                            int pos0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_DH(T, QT)                                                                        \
  launch_dh<T, QT>(static_cast<const QT*>(q), k, v, pos, static_cast<QT*>(out), b, S, h, hkv, \
                   dh, scale, n_ranks, cpr, vec, q_rs, pos0, st)
  const cudaError_t e = cache_bf16 ? (q_bf16 ? DA_DH(uint16_t, uint16_t) : DA_DH(uint16_t, float))
                                   : (q_bf16 ? DA_DH(float, uint16_t) : DA_DH(float, float));
#undef DA_DH
  return (int)e;
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
