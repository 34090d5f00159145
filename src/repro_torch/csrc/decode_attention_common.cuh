// What the two one-token decode attention kernels share (decode_attention.cu
// over f32/bf16 caches, decode_attention_int4.cu over packed INT4 rows):
// flash-decoding over a thread-block cluster.
//
// grid (hkv, b, C), cluster (1, 1, C): the C <= 8 blocks of a cluster serve
// one (batch row, kv head) and its g = h / hkv query heads; rank c walks
// chunks [c * cpr, c * cpr + cpr) of 32 positions (the Python side's
// chunk_plan).  Per chunk a kernel stages the K and V rows into shared
// memory as f32 (its only own code); then a warp owns query heads and a lane
// owns a position: scores, the chunk's max and sum by warp shuffles,
// probabilities kept in registers and broadcast by shuffle into the P.V
// sums, where a lane owns output features.  Chunks past a row's last
// position are never staged: such a rank keeps the empty partial (m =
// -1e30, l = 0).  A lane owns DPL = dh / 32 output features (rounded up to
// 4 or 8: dh <= 128 or dh <= 256, Gemma 3's head), a template parameter of
// the kernels, so the accumulators stay in registers at either width.  The
// ranks' partials (m, l, o) meet in distributed shared
// memory and are combined in rank order with models/common.py's
// merge_partials / finalize_partials arithmetic, inside the same launch:
// deterministic, no scratch in device memory, no second kernel.
//
// q and the output have one element type QT, a template parameter of the
// block: f32, or bf16 (passed as raw 16 bits), which is widened exactly as
// it loads and the output rounded to nearest even as it stores.  All
// arithmetic stays f32, as in the TPU kernels, which widen q in-kernel
// (src/repro/kernels/decode_attention.py:52 and :152), so a bf16 q gives
// bit for bit what widening it, the f32 instance and a cast back give.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace da {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int CH = 32;                   // positions per chunk (one per lane)
constexpr int MAX_DH = 256;              // 8 output features per lane

// output features per lane for head_dim dh (the kernels' DPL): 4 or 8
inline int dpl_for(int dh) { return dh <= 128 ? 4 : 8; }
constexpr float NEG_INF = -1e30f;

// q and output elements (QT): f32 as they are; bf16 widened on load and
// rounded to nearest even on store
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

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

// A block's shared memory: q (g x dh), the chunk's K tile (CH x (dh + 1),
// padded so that lane = position reads are free of bank conflicts), its V
// tile (CH x dh), and this rank's partial: m (g), l (g), o (g x dh).
struct Smem {
  float *qs, *ks, *vs, *pm, *pl, *po;
  __device__ Smem(float* base, int g, int dh)
      : qs(base), ks(qs + g * dh), vs(ks + CH * (dh + 1)), pm(vs + CH * dh), pl(pm + g),
        po(pl + g) {}
};

inline size_t smem_bytes(int g, int dh) {
  return sizeof(float) *
         (2 * (size_t)g * dh + (size_t)CH * (dh + 1) + (size_t)CH * dh + 2 * (size_t)g);
}

// One block: q (widened to f32) into shared memory, this rank's chunks of
// the n_total positions (each staged by stage(sm, t0, nt), which writes K
// row t of the chunk to sm.ks + t * (dh + 1) and V row t to sm.vs + t * dh
// for t < nt), then the cluster's combine into ob (g x dh, stored as QT).
// Warp w serves query heads w, w + 4, ... (HPW of them); a lane owns
// features lane + 32 dd, dd < DPL.
template <int HPW, int DPL, typename QT, typename Stage>
__device__ __forceinline__ void decode_block(float* smem, const QT* qb, QT* ob,
                                             int n_total, int g, int dh, float scale, int cpr,
                                             Stage&& stage) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)gridDim.z;
  const int gd = g * dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Smem sm(smem, g, dh);

  for (int i = tid; i < gd; i += THREADS) sm.qs[i] = to_f32(qb[i]);

  float m_run[HPW], l_run[HPW], acc[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  const int c_begin = rank * cpr;
  const int c_end = min(c_begin + cpr, (n_total + CH - 1) / CH);
  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * CH;
    const int nt = min(CH, n_total - t0);
    __syncthreads();                     // qs ready; the last chunk's tiles read
    stage(sm, t0, nt);
    __syncthreads();

    // scores for this warp's heads: lane = position
    float s[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) s[i] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kv = sm.ks[lane * (dh + 1) + d];
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int gi = warp + NWARPS * i;
        if (gi < g) s[i] = fmaf(sm.qs[gi * dh + d], kv, s[i]);
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
          if (d < dh) acc[i][dd] = fmaf(pt, sm.vs[t * dh + d], acc[i][dd]);
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
        sm.pm[gi] = m_run[i];
        sm.pl[gi] = l_run[i];
      }
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < dh) sm.po[gi * dh + d] = acc[i][dd];
      }
    }
  }
  cluster.sync();
  for (int e = rank * THREADS + tid; e < gd; e += n_ranks * THREADS) {
    const int gi = e / dh;
    float m = NEG_INF;
    for (int r = 0; r < n_ranks; ++r) m = fmaxf(m, cluster.map_shared_rank(sm.pm, r)[gi]);
    float l = 0.f, o = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      const float cr = expf(cluster.map_shared_rank(sm.pm, r)[gi] - m);
      l += cluster.map_shared_rank(sm.pl, r)[gi] * cr;
      o += cluster.map_shared_rank(sm.po, r)[e] * cr;
    }
    store(ob + e, o / fmaxf(l, 1e-30f));
  }
  cluster.sync();                        // no rank leaves while others read it
}

// Launch kernel on grid (hkv, b, n_ranks) in clusters of the n_ranks blocks
// of one (row, kv head).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                           Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace da
