// One-token GQA decode attention over packed INT4 KV rows, for Hopper
// (sm_90a).
//
//   q (b, h, dh) f32 or bf16 (row stride q_rs); history K/V as the KV store's
//     packed rows: packed (b, S, F/2) uint8, feature 2i in the low nibble of
//     byte i, scales (b, S, F/group) f32, F = hkv * dh, value =
//     (nibble - 8) * scale, group a power of two of at least 8 (gcd(F, 32))
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
// What bounds it on this card: a KV row of tinyllama is 128 packed bytes +
// 8 scales (160 B against 1024 B at f32), read once for about 4 h dh flops,
// so the kernel is bound by bytes, and at decode sizes (0.2-1.3 MB) by
// latency and by the unpacking, which is work per byte that the f32 cache
// does not have.  What the design does: the step of
// decode_attention_common.cuh (shared with decode_attention.cu) splits each
// row over a cluster by its own live positions (the packed rows and the
// fresh row), spreads a tile's positions over the warps for every head,
// reads K across lanes and keeps a ring of tiles in flight.  What is this
// file's own is the cache: a warp's 8 positions of a tile land by
// cp.async as they are stored, the packed bytes of the kv head's slice (16-, 8- or 4-byte
// copies) and its f32 scales (4-byte copies; a group may span two heads, so
// a scale is indexed by the flattened feature, feature >> log2 group); a
// lane unpacks 8 nibbles from one 32-bit word (nib_f: exact, no convert)
// under the one scale of their group.  The fresh row is widened (and
// rounded) into shared memory once, by the rank whose run holds it.  Over
// the same plan and step, this kernel without a fresh row at f32 computes
// what decode_attention.cu computes over the dequantized cache, bit for
// bit.  q and the output are f32 or bf16 (the template's QT: a bf16 q is
// widened as it loads and the output rounded as it stores, all arithmetic
// f32, as the TPU kernel widens q in its body and writes q.dtype).
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

// A warp's stage: K's packed slices [TW][dh / 2], V's, then K's scales
// [TW][ns] and V's (ns scales cover the kv head's slice of a row)
struct Cache {
  const uint8_t* kq;                     // row position 0, this kv head's slice
  const uint8_t* vq;
  const float* ksc;                      // row position 0, the slice's first scale
  const float* vsc;
  const void* k_new;                     // the fresh row (this row and kv head) or null
  const void* v_new;
  const float* fresh;                    // its widened copy in shared memory (prepare)
  int F2, Fg, dh, ns, lg, f_base;
  int n_hist;                            // packed rows
  int fresh_at;                          // the fresh row's position, or -1
  int cpy, scpy;                         // packed and scale bytes per copy
  int new_bf16, bf16;

  __device__ __forceinline__ int pbytes() const { return dh / 2; }
  __device__ __forceinline__ int kscales() const { return 2 * da::TW * pbytes(); }

  __device__ __forceinline__ void issue(char* st, int p0, int lane) const {
    const int pb = pbytes(), per = pb / cpy, sper = ns * 4 / scpy;
    const int nt = max(0, min(da::TW, n_hist - p0));
    da::for_pieces(2 * nt, per + sper, lane, [&](int rr, int c) {
      const int tensor = rr >= nt, t = rr - tensor * nt;
      const size_t r = (size_t)(p0 + t);
      if (c < per) {
        da::cp_async(st + (tensor * da::TW + t) * pb + c * cpy,
                     (tensor ? vq : kq) + r * F2 + c * cpy, cpy);
      } else if (const int j = (c - per) * scpy / 4; (f_base >> lg) + j < Fg) {
        // (a slice may touch fewer scales than ns)
        da::cp_async(st + kscales() + ((tensor * da::TW + t) * ns + j) * 4,
                     (tensor ? vsc : ksc) + r * Fg + j, scpy);
      }
    });
  }

  // the fresh row, widened and rounded as the packed values are: loaded by
  // every block (2 dh <= 512 values, 4 a thread) before its run is known,
  // kept by the rank whose positions [first, stop) hold it
  static constexpr int FPT = 2 * da::MAX_DH / da::THREADS;
  struct Early {
    float x[FPT];
  };

  __device__ __forceinline__ Early fetch() const {
    Early e;
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      const int i = threadIdx.x + j * da::THREADS;
      e.x[j] = 0.f;
      if (k_new != nullptr && i < 2 * dh) {
        const void* src = i < dh ? k_new : v_new;
        const int d = i < dh ? i : i - dh;
        const float x = new_bf16 ? da::to_f32(static_cast<const uint16_t*>(src)[d])
                                 : static_cast<const float*>(src)[d];
        e.x[j] = bf16 ? round_bf16(x) : x;
      }
    }
    return e;
  }

  __device__ __forceinline__ void prepare(float* ex, const Early& e, int first, int stop) const {
    if (fresh_at < first || fresh_at >= stop) return;
#pragma unroll
    for (int j = 0; j < FPT; ++j)
      if (threadIdx.x + j * da::THREADS < 2 * dh) ex[threadIdx.x + j * da::THREADS] = e.x[j];
  }

  // n nibbles of a stage row from feature f0 (within one 32-bit word),
  // times the scale of their group
  template <int N>
  __device__ __forceinline__ void unpack(const char* st, int tensor, int t, int f0,
                                         float (&x)[N]) const {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        st + (tensor * da::TW + t) * pbytes() + (f0 >> 3) * 4);
    const float sc = reinterpret_cast<const float*>(st + kscales())
        [(tensor * da::TW + t) * ns + ((f_base + f0) >> lg) - (f_base >> lg)];
    const int sh = (f0 & 7) * 4;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v = nib_f((w >> (sh + 4 * j)) & 0xFu) * sc;
      x[j] = bf16 ? round_bf16(v) : v;
    }
  }

  __device__ __forceinline__ void k8(const char* st, int t, int p, int f0, float (&x)[8]) const {
    if (p == fresh_at) {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = fresh[f0 + j];
    } else {
      unpack<8>(st, 0, t, f0, x);
    }
  }

  template <int DPL>
  __device__ __forceinline__ void vrow(const char* st, int t, int p, int f0,
                                       float (&x)[DPL]) const {
    if (p == fresh_at) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) x[j] = fresh[dh + f0 + j];
    } else {
      unpack<DPL>(st, 1, t, f0, x);
    }
  }
};

// Scale bytes per copy: the most of 16, 8 and 4 that divides the
// slice's ns scales, a row of them and the slice's first, at both bases
__device__ __forceinline__ int scale_copy(const float* ks, const float* vs, int Fg, int ns,
                                          int first) {
  for (int n = 16; n > 4; n >>= 1) {
    const int e = n / 4;
    if (ns % e == 0 && Fg % e == 0 && first % e == 0 && (uintptr_t)ks % n == 0 &&
        (uintptr_t)vs % n == 0)
      return n;
  }
  return 4;
}

// grid (hkv * g / G, b, C), cluster (1, 1, C): block x = (kv head, chunk
// of G query heads)
template <int DPL, int G, typename QT>
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
                             float scale, int ranks, int nst, int ns, int cpy, int q_rs,
                             int kn_rs, int vn_rs, int pos0) {
  extern __shared__ __align__(16) float smem[];
  const int g = h / hkv, nhc = g / G;
  const int kh = blockIdx.x / nhc, bi = blockIdx.y;
  const int h0 = kh * g + (blockIdx.x - kh * nhc) * G;
  const int F2 = hkv * dh / 2, Fg = (hkv * dh) >> lg_group;
  const int p = pos != nullptr ? pos[bi] : pos0;
  // packed history rows 0 .. n_hist - 1, then the fresh row (if any) as the
  // last position of the row
  const int n_hist = has_new ? max(0, min(p, S)) : max(0, min(p + 1, S));
  const int f_base = kh * dh;
  const size_t row0 = (size_t)bi * S;
  const int stage = 2 * da::TW * (dh / 2 + 4 * ns);   // a warp's
  const da::Layout lay(G, dh, da::NWARPS * stage, nst, 2 * dh);
  const size_t kn_off = (size_t)bi * kn_rs + f_base, vn_off = (size_t)bi * vn_rs + f_base;
  const Cache cache{
      kq + row0 * F2 + f_base / 2, vq + row0 * F2 + f_base / 2,
      ksc + row0 * Fg + (f_base >> lg_group), vsc + row0 * Fg + (f_base >> lg_group),
      has_new ? (new_bf16 ? (const void*)(static_cast<const uint16_t*>(k_new) + kn_off)
                          : (const void*)(static_cast<const float*>(k_new) + kn_off))
              : nullptr,
      has_new ? (new_bf16 ? (const void*)(static_cast<const uint16_t*>(v_new) + vn_off)
                          : (const void*)(static_cast<const float*>(v_new) + vn_off))
              : nullptr,
      smem + lay.ex, F2, Fg, dh, ns, lg_group, f_base, n_hist, has_new ? n_hist : -1, cpy,
      scale_copy(ksc, vsc, Fg, ns, f_base >> lg_group), new_bf16, bf16};
  da::decode_block<DPL, G>(smem, lay, q + (size_t)bi * q_rs + (size_t)h0 * dh,
                           out + ((size_t)bi * h + h0) * dh, n_hist + (has_new ? 1 : 0), ranks,
                           dh, scale, stage, nst, cache);
}

template <int DPL, int G, typename QT>
cudaError_t launch(const void* q, const uint8_t* kq, const float* ks, const uint8_t* vq,
                   const float* vs, const int* pos, const void* k_new, const void* v_new,
                   void* out, int b, int S, int h, int hkv, int dh, int lg_group, int has_new,
                   int new_bf16, int bf16, float scale, int cluster, int cpy, int q_rs,
                   int kn_rs, int vn_rs, int pos0, cudaStream_t s) {
  // scales a kv head's slice of a row touches (the most over the heads)
  int ns = 0;
  for (int kh = 0; kh < hkv; ++kh)
    ns = max(ns, (((kh + 1) * dh - 1) >> lg_group) - ((kh * dh) >> lg_group) + 1);
  const int stage = da::NWARPS * 2 * da::TW * (dh / 2 + 4 * ns);   // the block's
  const int nst = da::ring_stages(stage);
  const da::Layout lay(G, dh, stage, nst, 2 * dh);
  return da::launch_cluster(
      decode_attention_int4_kernel<DPL, G, QT>,
      dim3(h / G, b, da::cluster_blocks(cluster, S + (has_new ? 1 : 0))), (size_t)lay.bytes,
      s, static_cast<const QT*>(q), kq, ks, vq, vs, pos, k_new, v_new, static_cast<QT*>(out), S,
      h, hkv, dh, lg_group, has_new, new_bf16, bf16, scale, cluster, nst, ns, cpy, q_rs, kn_rs,
      vn_rs, pos0);
}

}  // namespace

extern "C" {

// cluster: the plan's ranks per (row, kv head) (1 to 16; CLUSTER is 16),
// of which a launch holds as many as a row of the slab can use;
// cpy =
// packed bytes per copy (16, 8 or 4: divides a head's slice of a row, the
// row, and keeps every base address aligned); q_bf16 / new_bf16: 0 for f32
// q and output / fresh rows, 1 for bf16 (passed as raw 16 bits); dh a
// multiple of 8, at most 256; lg_group at least 3.
int decode_attention_int4_launch(const void* q, const uint8_t* kq,
                                 const float* ks, const uint8_t* vq,
                                 const float* vs, const int* pos,
                                 const void* k_new, const void* v_new,
                                 void* out, int b, int S, int h, int hkv,
                                 int dh, int lg_group, int has_new, int q_bf16,
                                 int new_bf16, int bf16, float scale, int cluster,
                                 int cpy, int q_rs, int kn_rs, int vn_rs, int pos0,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh > da::MAX_DH || dh % 8 || lg_group < 3 || cluster < 1 ||
      cluster > da::MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const int dpl = da::dpl_for(dh), G = da::heads_per_block(h / hkv, dpl);
#define DA4_LAUNCH(D, G_, QT)                                                                \
  launch<D, G_, QT>(q, kq, ks, vq, vs, pos, k_new, v_new, out, b, S, h, hkv, dh, lg_group,   \
                    has_new, new_bf16, bf16, scale, cluster, cpy, q_rs, kn_rs, vn_rs, pos0, s)
#define DA4_G(D, QT)                                                                     \
  (G == 1   ? DA4_LAUNCH(D, 1, QT)                                                       \
   : G == 2 ? DA4_LAUNCH(D, 2, QT)                                                       \
   : G == 4 ? DA4_LAUNCH(D, 4, QT)                                                       \
            : DA4_LAUNCH(D, (D <= 4 ? 8 : 4), QT))
#define DA4_DPL(QT)                                                                      \
  (dpl == 1 ? DA4_G(1, QT) : dpl == 2 ? DA4_G(2, QT) : dpl == 4 ? DA4_G(4, QT) : DA4_G(8, QT))
  const cudaError_t e = q_bf16 ? DA4_DPL(uint16_t) : DA4_DPL(float);
#undef DA4_DPL
#undef DA4_G
#undef DA4_LAUNCH
  return (int)e;
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
