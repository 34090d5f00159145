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
// What bounds it on this card: it reads each live K and V row once and does
// about 4 h dh flops a row, so it is bound by bytes (12 MB at Gemma 3's
// global slab in bf16, 3.7 us at 3.35 TB/s), and at serving sizes (1.3 MB
// at f32, b 4, S 160) by latency.  What the design does: the step of
// decode_attention_common.cuh (shared with decode_attention_int4.cu) splits
// each row over a cluster by its own live positions, spreads a tile's
// positions over the warps for every head, reads K across lanes and keeps
// a ring of tiles in flight.  What is this file's own is the cache: a
// warp's 8 positions of a tile land by cp.async in the cache's own type
// (16-byte copies, or 8 or 4 where a row or a base address is not 16-byte
// aligned), K rows then V rows, rows past pos[r] never read; a lane widens its 8 K
// features (two float4s, or one 16-byte piece of bf16) and its DPL V
// features in registers.  All arithmetic stays f32.  A bf16 q is read and
// the bf16 output written by the kernel itself, as the TPU kernel widens q
// in its body and writes q.dtype: instances over (q, cache) in {f32, bf16}^2.
#include <stdint.h>

#include "decode_attention_common.cuh"

namespace {

// n cache elements at p (shared memory, aligned to n elements) into f32:
// f32 as they are, bf16 (raw 16 bits) into the top half
template <int N>
__device__ __forceinline__ void widen(const float* p, float (&x)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
    }
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = p[0];
  }
}

__device__ __forceinline__ void unpack2(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xFFFF0000u);
}

template <int N>
__device__ __forceinline__ void widen(const uint16_t* p, float (&x)[N]) {
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    unpack2(a.x, x); unpack2(a.y, x + 2); unpack2(a.z, x + 4); unpack2(a.w, x + 6);
  } else if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    unpack2(a.x, x); unpack2(a.y, x + 2);
  } else if constexpr (N == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), x);
  } else {
    x[0] = __uint_as_float((uint32_t)p[0] << 16);
  }
}

// A warp's stage: K rows [TW][dh] then V rows [TW][dh], in the cache's type T
template <typename T>
struct Cache {
  const T* kb;                           // (row, kv head)'s position 0
  const T* vb;
  size_t rs;                             // elements between positions
  int dh, n, cpy;                        // features, live positions, copy bytes

  __device__ __forceinline__ int row_bytes() const { return dh * (int)sizeof(T); }

  __device__ __forceinline__ void issue(char* st, int p0, int lane) const {
    const int rb = row_bytes();
    const int nt = min(da::TW, n - p0);
    da::for_pieces(2 * nt, rb / cpy, lane, [&](int r, int c) {
      const int tensor = r >= nt, t = r - tensor * nt;
      const char* src =
          reinterpret_cast<const char*>((tensor ? vb : kb) + (size_t)(p0 + t) * rs) + c * cpy;
      da::cp_async(st + (tensor * da::TW + t) * rb + c * cpy, src, cpy);
    });
  }

  struct Early {};
  __device__ __forceinline__ Early fetch() const { return {}; }
  __device__ __forceinline__ void prepare(float*, Early, int, int) const {}

  __device__ __forceinline__ void k8(const char* st, int t, int, int f0, float (&x)[8]) const {
    widen<8>(reinterpret_cast<const T*>(st + t * row_bytes()) + f0, x);
  }

  template <int DPL>
  __device__ __forceinline__ void vrow(const char* st, int t, int, int f0,
                                       float (&x)[DPL]) const {
    widen<DPL>(reinterpret_cast<const T*>(st + (da::TW + t) * row_bytes()) + f0, x);
  }
};

// grid (hkv * g / G, b, C), cluster (1, 1, C): block x = (kv head, chunk
// of G query heads)
template <int DPL, int G, typename T, typename QT>
__global__ void __launch_bounds__(da::THREADS)
decode_attention_kernel(const QT* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ pos,
                        QT* __restrict__ out, int S, int h, int hkv, int dh, float scale,
                        int ranks, int nst, int cpy, int q_rs, int pos0) {
  extern __shared__ __align__(16) float smem[];
  const int g = h / hkv, nhc = g / G;
  const int kh = blockIdx.x / nhc, bi = blockIdx.y;
  const int h0 = kh * g + (blockIdx.x - kh * nhc) * G;
  const int p = pos != nullptr ? pos[bi] : pos0;
  const size_t rs = (size_t)hkv * dh;
  const Cache<T> cache{kc + (size_t)bi * S * rs + (size_t)kh * dh,
                       vc + (size_t)bi * S * rs + (size_t)kh * dh, rs, dh,
                       max(0, min(p + 1, S)), cpy};
  const int stage = 2 * da::TW * dh * (int)sizeof(T);   // a warp's
  const da::Layout lay(G, dh, da::NWARPS * stage, nst, 0);
  da::decode_block<DPL, G>(smem, lay, q + (size_t)bi * q_rs + (size_t)h0 * dh,
                           out + ((size_t)bi * h + h0) * dh, cache.n, ranks, dh, scale, stage,
                           nst, cache);
}

template <int DPL, int G, typename T, typename QT>
cudaError_t launch(const QT* q, const void* k, const void* v, const int* pos, QT* out, int b,
                   int S, int h, int hkv, int dh, float scale, int cluster, int cpy, int q_rs,
                   int pos0, cudaStream_t s) {
  const int stage = da::NWARPS * 2 * da::TW * dh * (int)sizeof(T);   // the block's
  const int nst = da::ring_stages(stage);
  const da::Layout lay(G, dh, stage, nst, 0);
  return da::launch_cluster(decode_attention_kernel<DPL, G, T, QT>,
                            dim3(h / G, b, da::cluster_blocks(cluster, S)), (size_t)lay.bytes, s,
                            q, static_cast<const T*>(k), static_cast<const T*>(v), pos, out, S,
                            h, hkv, dh, scale, cluster, nst, cpy, q_rs, pos0);
}

template <typename T, typename QT>
cudaError_t launch_dh(const QT* q, const void* k, const void* v, const int* pos, QT* out,
                      int b, int S, int h, int hkv, int dh, float scale, int cluster, int cpy,
                      int q_rs, int pos0, cudaStream_t s) {
  if (dh > da::MAX_DH || dh % 8 || cluster < 1 || cluster > da::MAX_CLUSTER)
    return cudaErrorInvalidValue;
  const int dpl = da::dpl_for(dh), G = da::heads_per_block(h / hkv, dpl);
#define DA_G(D, G_)                                                                      \
  launch<D, G_, T, QT>(q, k, v, pos, out, b, S, h, hkv, dh, scale, cluster, cpy, q_rs, pos0, s)
#define DA_DPL(D)                                                                        \
  (G == 1 ? DA_G(D, 1) : G == 2 ? DA_G(D, 2) : G == 4 ? DA_G(D, 4) : DA_G(D, (D <= 4 ? 8 : 4)))
  switch (dpl) {
    case 1: return DA_DPL(1);
    case 2: return DA_DPL(2);
    case 4: return DA_DPL(4);
    default: return DA_DPL(8);
  }
#undef DA_DPL
#undef DA_G
}

}  // namespace

extern "C" {

// cluster: the plan's ranks per (row, kv head) (1 to 16; CLUSTER is 16),
// of which a launch holds as many as a row of the slab can use;
// cpy =
// bytes per copy (16, 8 or 4: divides a row and keeps every base address
// aligned); cache_bf16 / q_bf16: 0 for f32 caches / q and output, 1 for
// bf16 (passed as raw 16 bits); dh a multiple of 8, at most 256.
int decode_attention_launch(const void* q, const void* k, const void* v, const int* pos,
                            void* out, int b, int S, int h, int hkv, int dh, int cache_bf16,
                            int q_bf16, float scale, int cluster, int cpy, int q_rs, int pos0,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_DH(T, QT)                                                                        \
  launch_dh<T, QT>(static_cast<const QT*>(q), k, v, pos, static_cast<QT*>(out), b, S, h, hkv, \
                   dh, scale, cluster, cpy, q_rs, pos0, st)
  const cudaError_t e = cache_bf16 ? (q_bf16 ? DA_DH(uint16_t, uint16_t) : DA_DH(uint16_t, float))
                                   : (q_bf16 ? DA_DH(float, uint16_t) : DA_DH(float, float));
#undef DA_DH
  return (int)e;
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
