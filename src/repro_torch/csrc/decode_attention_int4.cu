// One-token GQA decode attention over packed INT4 KV rows, for Hopper
// (sm_90a).
//
//   q (b, h, dh) f32 (row stride q_rs); history K/V as the KV store's
//     packed rows: packed (b, S, F/2) uint8, feature 2i in the low nibble of
//     byte i, scales (b, S, F/group) f32, F = hkv * dh, value =
//     (nibble - 8) * scale, group a power of two (gcd(F, 32))
//   pos (b,) int32, or null and every row at pos0; optional fresh row
//     k_new/v_new (b, hkv, dh) f32 (row stride kn_rs / vn_rs)
//   out (b, h, dh) f32:
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
// card (flash-decoding): grid (hkv, b, C), one cluster of C <= 8 blocks per
// (batch row, kv head), rank c walking its own run of 32-position chunks.
// Each block serves the g = h/hkv query heads of its kv head from one read
// of each packed row: every thread loads one 16-byte (or 8-byte) segment of
// a K or V row, the segment's scales once per group (a shift, not a divide),
// unpacks the nibbles in registers and writes the chunk's dequantized tile
// to shared memory, one __syncthreads per chunk.  Then a warp owns query
// heads and a lane owns a position: scores, the chunk's max and sum by warp
// shuffles, probabilities kept in registers and broadcast by shuffle into
// the P.V sums, where a lane owns output features.  Chunks past a row's last
// position are never read: such a rank keeps the empty partial (m = -1e30,
// l = 0).  The ranks' partials (m, l, o) meet in distributed shared memory
// and are combined in rank order with models/common.py's merge_partials /
// finalize_partials arithmetic, inside the same launch: deterministic, no
// scratch in device memory, no second kernel.  A scale is indexed by the
// flattened feature (feature >> log2 group), so a group that spans two
// heads is read right.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int CH = 32;                   // positions per chunk (one per lane)
constexpr int DPL = 4;                   // output features per lane: dh <= 128
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

// grid (hkv, b, C), cluster (1, 1, C); rank c walks chunks [c*cpr, c*cpr+cpr).
template <int HPW>
__global__ void __launch_bounds__(THREADS)
decode_attention_int4_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ kq,
                             const float* __restrict__ ksc,
                             const uint8_t* __restrict__ vq,
                             const float* __restrict__ vsc,
                             const int* __restrict__ pos,
                             const float* __restrict__ k_new,
                             const float* __restrict__ v_new,
                             float* __restrict__ out, int S, int h, int hkv,
                             int dh, int lg_group, int has_new, int bf16,
                             float scale, int cpr, int seg, int q_rs,
                             int kn_rs, int vn_rs, int pos0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)gridDim.z;
  const int g = h / hkv;
  const int gd = g * dh;
  const int F2 = hkv * dh / 2, Fg = (hkv * dh) >> lg_group;
  const int group = 1 << lg_group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // g * dh
  float* ks = qs + gd;                   // CH * (dh + 1)
  float* vs = ks + CH * (dh + 1);        // CH * dh
  float* pm = vs + CH * dh;              // g   this rank's max
  float* pl = pm + g;                    // g   this rank's denominator
  float* po = pl + g;                    // g * dh  this rank's unnormalized sum

  const float* qb = q + (size_t)bi * q_rs + (size_t)kh * gd;
  for (int i = tid; i < gd; i += THREADS) qs[i] = qb[i];

  // packed history rows 0..n_hist-1, then the fresh row (if any) as the
  // last position of the sequence
  const int p = pos != nullptr ? pos[bi] : pos0;
  const int n_hist = has_new ? max(0, min(p, S)) : max(0, min(p + 1, S));
  const int n_total = n_hist + (has_new ? 1 : 0);
  const int c_begin = rank * cpr;
  const int c_end = min(c_begin + cpr, (n_total + CH - 1) / CH);
  const size_t row0 = (size_t)bi * S;
  const int nseg = (dh / 2) / seg;

  float m_run[HPW], l_run[HPW], acc[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * CH;
    const int nt = min(CH, n_total - t0);
    __syncthreads();                     // qs ready; the last chunk's tiles read
    // stage the chunk: one packed segment of a K or V row per thread
    for (int i = tid; i < 2 * CH * nseg; i += THREADS) {
      const int tensor = i / (CH * nseg);
      const int rem = i - tensor * CH * nseg;
      const int t = rem / nseg, sg = rem - t * nseg;
      const int row = t0 + t;
      const int d0 = sg * 2 * seg;
      float* dst = tensor == 0 ? ks + t * (dh + 1) + d0 : vs + t * dh + d0;
      if (t < nt && row < n_hist) {
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
      } else if (t < nt) {               // the fresh row
        const float* src = (tensor == 0 ? k_new + (size_t)bi * kn_rs : v_new + (size_t)bi * vn_rs)
                           + kh * dh + d0;
        for (int j = 0; j < 2 * seg; ++j) dst[j] = bf16 ? round_bf16(src[j]) : src[j];
      } else {
        for (int j = 0; j < 2 * seg; ++j) dst[j] = 0.f;
      }
    }
    __syncthreads();

    // scores for this warp's heads: lane = position
    float s[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) s[i] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kv = ks[lane * (dh + 1) + d];
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int gi = warp + NWARPS * i;
        if (gi < g) s[i] = fmaf(qs[gi * dh + d], kv, s[i]);
      }
    }
    float pr[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const float sv = lane < nt ? s[i] * scale : NEG_INF;
      const float m_new = fmaxf(m_run[i], warp_max(sv));
      pr[i] = lane < nt ? expf(sv - m_new) : 0.f;
      const float alpha = m_run[i] > NEG_INF / 2 ? expf(m_run[i] - m_new) : 0.f;
      l_run[i] = l_run[i] * alpha + warp_sum(pr[i]);
      m_run[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
    }
    // P.V: lane = output feature (lane + 32 dd)
    for (int t = 0; t < nt; ++t) {
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const float pt = __shfl_sync(0xffffffffu, pr[i], t);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          const int d = lane + 32 * dd;
          if (d < dh) acc[i][dd] = fmaf(pt, vs[t * dh + d], acc[i][dd]);
        }
      }
    }
  }

  // this rank's partial, then the cluster's combine in rank order
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int gi = warp + NWARPS * i;
    if (gi < g) {
      if (lane == 0) {
        pm[gi] = m_run[i];
        pl[gi] = l_run[i];
      }
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < dh) po[gi * dh + d] = acc[i][dd];
      }
    }
  }
  cluster.sync();
  float* ob = out + ((size_t)bi * h + (size_t)kh * g) * dh;
  for (int e = rank * THREADS + tid; e < gd; e += n_ranks * THREADS) {
    const int gi = e / dh;
    float m = NEG_INF;
    for (int r = 0; r < n_ranks; ++r) m = fmaxf(m, cluster.map_shared_rank(pm, r)[gi]);
    float l = 0.f, o = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      const float cr = expf(cluster.map_shared_rank(pm, r)[gi] - m);
      l += cluster.map_shared_rank(pl, r)[gi] * cr;
      o += cluster.map_shared_rank(po, r)[e] * cr;
    }
    ob[e] = o / fmaxf(l, 1e-30f);
  }
  cluster.sync();
}

template <int HPW>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const float* q,
                   const uint8_t* kq, const float* ks, const uint8_t* vq,
                   const float* vs, const int* pos, const float* k_new,
                   const float* v_new, float* out, int S, int h, int hkv, int dh,
                   int lg_group, int has_new, int bf16, float scale, int cpr,
                   int seg, int q_rs, int kn_rs, int vn_rs, int pos0) {
  auto kernel = decode_attention_int4_kernel<HPW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, kq, ks, vq, vs, pos, k_new, v_new, out,
                            S, h, hkv, dh, lg_group, has_new, bf16, scale, cpr, seg,
                            q_rs, kn_rs, vn_rs, pos0);
}

}  // namespace

extern "C" {

// n_ranks blocks per (row, kv head), each walking cpr chunks of 32
// positions; seg = packed bytes per load (16, 8, 4, 2 or 1).
int decode_attention_int4_launch(const float* q, const uint8_t* kq,
                                 const float* ks, const uint8_t* vq,
                                 const float* vs, const int* pos,
                                 const float* k_new, const float* v_new,
                                 float* out, int b, int S, int h, int hkv,
                                 int dh, int lg_group, int has_new, int bf16,
                                 float scale, int n_ranks, int cpr, int seg,
                                 int q_rs, int kn_rs, int vn_rs, int pos0,
                                 void* stream) {
  const int g = h / hkv;
  const size_t smem = sizeof(float) * (2 * (size_t)g * dh + (size_t)CH * (dh + 1) +
                                       (size_t)CH * dh + 2 * (size_t)g);
  const dim3 grid(hkv, b, n_ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpw = (g + NWARPS - 1) / NWARPS;
  cudaError_t e;
#define DA4_LAUNCH(H)                                                               \
  e = launch<H>(grid, smem, s, q, kq, ks, vq, vs, pos, k_new, v_new, out, S, h, hkv, \
                dh, lg_group, has_new, bf16, scale, cpr, seg, q_rs, kn_rs, vn_rs, pos0)
  if (hpw <= 1) DA4_LAUNCH(1);
  else if (hpw <= 2) DA4_LAUNCH(2);
  else if (hpw <= 4) DA4_LAUNCH(4);
  else DA4_LAUNCH(8);
#undef DA4_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
