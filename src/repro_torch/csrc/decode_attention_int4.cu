// One-token GQA decode attention over packed INT4 KV rows, for Hopper
// (sm_90a).
//
//   q (b, h, dh) f32 or bf16 (row stride q_rs); history K/V as the KV store's
//     packed rows: packed (b, S, F/2) uint8, feature 2i in the low nibble of
//     byte i, scales (b, S, F/group) f32, F = hkv * dh, value =
//     (nibble - 8) * scale, group a power of two (gcd(F, 32))
//   pos (b,) int32, or null and every row at pos0; optional fresh row
//     k_new/v_new (b, hkv, dh) f32 or bf16 (row stride kn_rs / vn_rs)
//   out (b, h, dh) in q's type:
//     without a fresh row, row r attends packed positions t <= pos[r];
//     with one, it attends packed positions t < pos[r] plus the fresh row
//     (the decode step's own K/V at pos[r], never quantized before use).
//   round_bf16: each dequantized value (and the fresh row) is rounded to
//   bf16 before use, the serving cache's compute dtype; otherwise f32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_int4_kernel (bodies _kernel_int4 and _unpack_rows), which
// took a scalar pos, asserted S % block_s == 0 and dequantized whole VMEM
// blocks with the store's jnp codec.
//
// What bounds it on this card, and what the design does about it: a KV row
// of tinyllama is 128 packed bytes + 8 scales (160 B against 1024 B at f32),
// read once for ~4*h*dh flops, so the kernel is bound by bytes, and at decode
// sizes (~0.2 MB) by latency.  So the design spreads the sequence over the
// card: flash-decoding over a thread-block cluster, shared with
// decode_attention.cu through decode_attention_common.cuh (its header has
// the scores, the softmax, P.V and the in-launch combine).  What is this
// file's own is how a chunk is staged: every thread loads one 16-byte (or
// 8-byte) segment of a packed K or V row, the segment's scales once per
// group (a shift, not a divide), and unpacks the nibbles in registers into
// the chunk's f32 tile.  A scale is indexed by the flattened feature
// (feature >> log2 group), so a group that spans two heads is read right.
// Over the same chunk plan, this kernel without a fresh row at f32 computes
// what decode_attention.cu computes over the dequantized cache, in the same
// order.  q and the output are f32 or bf16 (the template's QT: a bf16 q is
// widened as it loads and the output rounded as it stores, all arithmetic
// f32, as the TPU kernel widens q in its body and writes q.dtype); a bf16
// fresh row is widened as it is staged.
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_attention_common.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float nib_f(uint32_t v) {   // v in [0, 15] -> v - 8
  return __uint_as_float(0x4B000000u | v) - 8388616.0f;
}

// seg packed bytes (16, 8, 4, 2 or 1; p aligned to seg) into words
__device__ __forceinline__ void load_seg(uint32_t (&wd)[4], const uint8_t* p, int seg) {
  wd[0] = wd[1] = wd[2] = wd[3] = 0u;
  if (seg == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
  } else if (seg == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = v.x; wd[1] = v.y;
  } else if (seg == 4) {
    wd[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    for (int j = 0; j < seg; ++j) wd[0] |= (uint32_t)__ldg(p + j) << (8 * j);
  }
}

// grid (hkv, b, C), cluster (1, 1, C)
template <int HPW, int DPL, typename QT>
__global__ void __launch_bounds__(da::THREADS)
decode_attention_int4_kernel(const QT* __restrict__ q,
                             const uint8_t* __restrict__ kq,
                             const float* __restrict__ ksc,
                             const uint8_t* __restrict__ vq,
                             const float* __restrict__ vsc,
                             const int* __restrict__ pos,
                             const void* __restrict__ k_new,
                             const void* __restrict__ v_new,
                             QT* __restrict__ out, int S, int h, int hkv,
                             int dh, int lg_group, int has_new, int new_bf16, int bf16,
                             float scale, int cpr, int seg, int q_rs,
                             int kn_rs, int vn_rs, int pos0) {
  extern __shared__ __align__(16) float smem[];
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int g = h / hkv;
  const int F2 = hkv * dh / 2, Fg = (hkv * dh) >> lg_group;
  const int group = 1 << lg_group;
  // packed history rows 0..n_hist-1, then the fresh row (if any) as the
  // last position of the sequence
  const int p = pos != nullptr ? pos[bi] : pos0;
  const int n_hist = has_new ? max(0, min(p, S)) : max(0, min(p + 1, S));
  const size_t row0 = (size_t)bi * S;
  const int nseg = (dh / 2) / seg;

  auto stage = [&](const da::Smem& sm, int t0, int nt) {
    // one packed segment of a K or V row per thread
    for (int i = threadIdx.x; i < 2 * nt * nseg; i += da::THREADS) {
      const int tensor = i / (nt * nseg);
      const int rem = i - tensor * nt * nseg;
      const int t = rem / nseg, sg = rem - t * nseg;
      const int row = t0 + t;
      const int d0 = sg * 2 * seg;
      float* dst = tensor == 0 ? sm.ks + t * (dh + 1) + d0 : sm.vs + t * dh + d0;
      if (row < n_hist) {
        const uint8_t* src = (tensor == 0 ? kq : vq) + (row0 + row) * F2 + kh * dh / 2 + sg * seg;
        const float* sb = (tensor == 0 ? ksc : vsc) + (row0 + row) * Fg;
        uint32_t wd[4];
        load_seg(wd, src, seg);
        const int f0 = kh * dh + d0;
        float sc = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (j < 2 * seg) {
            if (j == 0 || ((f0 + j) & (group - 1)) == 0) sc = __ldg(sb + ((f0 + j) >> lg_group));
            float v = nib_f((wd[j >> 3] >> (4 * (j & 7))) & 0xFu) * sc;
            dst[j] = bf16 ? round_bf16(v) : v;
          }
        }
      } else {                           // the fresh row
        const size_t off = (size_t)bi * (tensor == 0 ? kn_rs : vn_rs) + kh * dh + d0;
        const void* src = tensor == 0 ? k_new : v_new;
        for (int j = 0; j < 2 * seg; ++j) {
          const float v = new_bf16 ? da::to_f32(static_cast<const uint16_t*>(src)[off + j])
                                   : static_cast<const float*>(src)[off + j];
          dst[j] = bf16 ? round_bf16(v) : v;
        }
      }
    }
  };
  da::decode_block<HPW, DPL>(smem, q + (size_t)bi * q_rs + (size_t)kh * g * dh,
                        out + ((size_t)bi * h + (size_t)kh * g) * dh,
                        n_hist + (has_new ? 1 : 0), g, dh, scale, cpr, stage);
}

}  // namespace

extern "C" {

// n_ranks blocks per (row, kv head), each walking cpr chunks of 32
// positions; seg = packed bytes per load (16, 8, 4, 2 or 1); q_bf16 /
// new_bf16: 0 for f32 q and output / fresh rows, 1 for bf16 (passed as raw
// 16 bits); dh at most 256.
int decode_attention_int4_launch(const void* q, const uint8_t* kq,
                                 const float* ks, const uint8_t* vq,
                                 const float* vs, const int* pos,
                                 const void* k_new, const void* v_new,
                                 void* out, int b, int S, int h, int hkv,
                                 int dh, int lg_group, int has_new, int q_bf16,
                                 int new_bf16, int bf16, float scale, int n_ranks,
                                 int cpr, int seg, int q_rs, int kn_rs, int vn_rs,
                                 int pos0, void* stream) {
  const int g = h / hkv;
  const dim3 grid(hkv, b, n_ranks);
  const size_t smem = da::smem_bytes(g, dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpw = (g + da::NWARPS - 1) / da::NWARPS;
  if (dh > da::MAX_DH) return (int)cudaErrorInvalidValue;
#define DA4_LAUNCH(H, D, QT)                                                                   \
  da::launch_cluster(decode_attention_int4_kernel<H, D, QT>, grid, smem, s,                    \
                     static_cast<const QT*>(q), kq, ks, vq, vs, pos, k_new, v_new,             \
                     static_cast<QT*>(out), S, h, hkv, dh, lg_group, has_new, new_bf16, bf16,  \
                     scale, cpr, seg, q_rs, kn_rs, vn_rs, pos0)
#define DA4_HPW(D, QT)                                                                         \
  (hpw <= 1 ? DA4_LAUNCH(1, D, QT) : hpw <= 2 ? DA4_LAUNCH(2, D, QT)                           \
   : hpw <= 4 ? DA4_LAUNCH(4, D, QT) : DA4_LAUNCH(8, D, QT))
  cudaError_t e;
  if (da::dpl_for(dh) == 4)
    e = q_bf16 ? DA4_HPW(4, uint16_t) : DA4_HPW(4, float);
  else
    e = q_bf16 ? DA4_HPW(8, uint16_t) : DA4_HPW(8, float);
#undef DA4_HPW
#undef DA4_LAUNCH
  return (int)e;
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
