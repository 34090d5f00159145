// The one-token decode step that both decode attention kernels run
// (decode_attention.cu over f32/bf16 caches, decode_attention_int4.cu over
// packed INT4 rows): flash-decoding over a thread-block cluster, each row
// split by its own live positions.
//
// What bounds it on this card: every live K and V row is read once for
// about 4 g dh flops, so the step is bound by bytes (12 MB at Gemma 3's
// global slab in bf16: 3.7 us at 3.35 TB/s), and at decode sizes by
// latency: how many bytes are in flight at once, how long each tile's
// chain of dependent steps is, and how soon the last block finishes.  What
// the design does about it:
//
// * Split each row by its own live positions.  grid (h / G, b, C),
//   cluster (1, 1, C): the C blocks of a cluster serve one (row, kv head,
//   chunk of G query heads).  A row has n live positions (pos + 1, or the
//   INT4 kernel's packed rows < pos plus its fresh row); they fall into
//   ceil(n / 32) tiles of TILE = 32 positions, and rank c takes a run of
//   whole tiles: used = min(ranks, tiles) ranks, the first tiles % used of
//   them one tile more (rank_run; kernels/decode_attention.py's rank_runs is
//   the same plan).  The kernel computes the run from pos itself, and ranks
//   is a constant of the plan (CLUSTER, 16), so a row's bits depend on its
//   q, its pos and its own live rows only: not on b, S or the other rows.
//   The launch's cluster holds min(ranks, ceil(S / 32)) blocks
//   (cluster_blocks): as many as the longest row the slab can hold uses.
// * Warps over positions, not heads.  Warp w takes positions 8w .. 8w + 7
//   of each tile for every query head of the block, keeps its own online
//   softmax (m, l, o), and the four warps' partials merge in warp order in
//   shared memory: every warp is busy at any group from 1 to 32.  A block
//   takes G heads (heads_per_block: 8, 4, 2 or 1, dividing the group), a
//   template constant, so no loop over heads runs predicated-off
//   iterations (a runtime bound of 16 made group 1 issue 16x the work).
// * The dot product across lanes.  A position's K row is read by a group of
//   L = min(8, dh / 8) lanes, each group taking 2 positions at once at dh
//   >= 64 (8 positions in flight a warp); lane s takes the 8-feature chunks
//   s, s + L, ... (one 16-byte bf16 piece, two f32 float4s, or one 32-bit
//   word of 8 nibbles), and L - 1 shuffles sum the group, one tree level
//   for every (position, head) at once.  Softmax: lane (head, position),
//   max and sum by shuffles over the 8 positions.  P.V: lane i owns
//   features DPL i .. DPL i + DPL - 1 (DPL = dh / 32 rounded up to 1, 2, 4
//   or 8) of every head.
// * Bytes in flight.  Each warp keeps its own ring of NST >= 2 stages
//   (host: ring_stages, about 64 KB of ring a block), a stage the 8 K and V
//   rows it takes of a tile, filled by its own lanes' cp.async copies while
//   it computes the previous stage: a warp waits on its own copies
//   (__syncwarp), never on a block barrier per tile.  Rows stay in the
//   cache's own type (f32, bf16, or packed nibbles beside their f32
//   scales) and are widened or unpacked in registers as they are used.
//   Positions past n are never read.
// * One-launch combine.  Each rank's partial (m, l, o) lands in its shared
//   memory; every block reads each used rank's (m, l) once per head through
//   distributed shared memory, then the ranks share the output's 4-feature
//   vectors, each summed over ranks in rank order: deterministic, no
//   atomics, no scratch in device memory, no second kernel.  The remote
//   loads are issued RK = 4 ranks at a time before they are summed: a
//   distributed-shared-memory latency per 4 ranks, not per rank (all 16 at
//   once took every instance to 128 registers and whisper's group-1 grid
//   of 512 blocks into a second wave).
//
// Cost of the layout per block (128 threads; Layout below): G x DPL <= ACC
// = 32 accumulators a lane, 2 G scores and 16 K values in flight, 72-128
// registers a thread (-Xptxas -v), no spills.  Shared memory: the rings
// (NST stages of 4 warps x 2 x 8 rows: f32 dh 256 64 KB a stage, 2
// stages; bf16 dh 256 32 KB, 2 stages; bf16 dh 64 8 KB, 4 stages; INT4 dh
// 256 10 KB, 4 stages), q as f32 (G dh), the warps' scores,
// probabilities, rescales and (m, l) (4 x (2 x 8 + 3) G), the combine's
// weights (16 G), and the warp partials (4 G dh floats, in the rings'
// space once they are drained): 66-134 KB at dh 256, 10-34 KB at dh 64.
//
// q and the output have one element type QT: f32, or bf16 (passed as raw
// 16 bits), widened exactly as it loads and rounded to nearest even as it
// stores.  All arithmetic stays f32, as in the TPU kernels, which widen q
// in-kernel (src/repro/kernels/decode_attention.py:52 and :152), so a bf16
// q gives bit for bit what widening it, the f32 instance and a cast back
// give.  Both kernels run this one step over the same plan, so the INT4
// kernel at f32 without a fresh row equals decode_attention over the
// dequantized cache bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// tools/decode_phases.py defines these to stamp %globaltimer at each phase
// boundary; the kernels compile them away
#ifndef DA_PHASE
#define DA_PHASE_BEGIN
#define DA_PHASE(k)
#define DA_PHASE_END
#endif

namespace da {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 32;                 // positions per tile
constexpr int TW = TILE / NWARPS;        // positions per warp per tile
constexpr int MAX_DH = 256;
constexpr int ACC = 32;                  // accumulators a lane: heads x DPL
constexpr int MAX_CLUSTER = 16;
constexpr int RK = 4;                    // ranks' remote loads in flight at once (combine)
constexpr int RING_BYTES = 64 * 1024;    // the ring's target size
constexpr float NEG_INF = -1e30f;

// output features per lane (P.V): dh / 32 rounded up to 1, 2, 4 or 8
inline int dpl_for(int dh) { return dh <= 32 ? 1 : dh <= 64 ? 2 : dh <= 128 ? 4 : 8; }

// lanes reading one K row: min(8, dh / 8 rounded down to a power of two)
__host__ __device__ inline int lanes_per_row(int dh) {
  int l = 1;
  while (l < 8 && 16 * l <= dh) l *= 2;
  return l;
}

// blocks a cluster launches for a slab of `rows` positions at most: as
// many ranks as its longest row can use under a plan of `ranks`
inline int cluster_blocks(int ranks, int rows) {
  const int t = (rows + TILE - 1) / TILE;
  return t < 1 ? 1 : t < ranks ? t : ranks;
}

// query heads a block takes of a group of g: the most of 8, 4, 2, 1 that
// divides g and keeps G x DPL accumulators within ACC (every loop over a
// block's heads then runs exactly G times)
inline int heads_per_block(int g, int dpl) {
  int G = 8;
  while (G > 1 && (g % G || G * dpl > ACC)) G /= 2;
  return G;
}

// ring stages: about RING_BYTES of K/V tiles, 2 to 4 of them (at most 2 x
// 64 KB, f32 dh 256, so a block's shared memory stays under 140 KB)
inline int ring_stages(int stage_bytes) {
  const int n = RING_BYTES / stage_bytes;
  return n < 2 ? 2 : n > 4 ? 4 : n;
}

// q and output elements (QT): f32 as they are; bf16 widened on load and
// rounded to nearest even on store
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(uint16_t* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// bytes (16, 8 or 4) from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n groups are in flight (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::);
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::);
  else asm volatile("cp.async.wait_group 3;\n" ::);
}

// Copy pieces (row r, piece c) of a stage's 2 nt rows (K's then V's) of
// `per` pieces each, spread over a warp's lanes: a lane keeps one piece
// index where per divides 32 (no division in the loop)
template <typename Copy>
__device__ __forceinline__ void for_pieces(int rows, int per, int lane, Copy&& copy) {
  if (32 % per == 0) {
    const int c = lane % per, step = 32 / per;
    for (int r = lane / per; r < rows; r += step) copy(r, c);
  } else {
    for (int i = lane; i < rows * per; i += 32) copy(i / per, i % per);
  }
}

// A row's run on one rank: tiles [t0, t0 + nt) of the row's ceil(n / TILE),
// of the used = min(C, tiles) ranks that read any
struct Run {
  int t0, nt, used;
};

__device__ __forceinline__ Run rank_run(int n, int C, int rank) {
  const int tiles = (n + TILE - 1) / TILE;
  const int used = min(C, tiles);
  if (rank >= used) return {0, 0, used};
  const int base = tiles / used, rem = tiles % used;
  return {rank * base + min(rank, rem), base + (rank < rem ? 1 : 0), used};
}

// A block's shared memory, in floats from the base: q (gb x dh), each
// warp's scores (gb x TW) and probabilities (TW x gb), its softmax
// rescales, then its partial (m, l), the rank's partial (m, l), the
// combine's weights (C x gb) and sums, `extra` floats for the kernel
// (the INT4 kernel's fresh row), and the ring, whose space holds the
// warps' partial outputs (4 x gb x dh) and then the rank's (gb x dh) once
// it is drained.
struct Layout {
  int qs, sw, pb, al, wm, wl, rm, rl, cw, cl, ex, ring, bytes;
  __host__ __device__ Layout(int gb, int dh, int stage_bytes, int nst, int extra) {
    int o = 0;
    qs = o; o += gb * dh;
    sw = o; o += NWARPS * gb * TW;
    pb = o; o += NWARPS * TW * gb;
    al = o; o += NWARPS * gb;
    wm = o; o += NWARPS * gb;
    wl = o; o += NWARPS * gb;
    rm = o; o += gb;
    rl = o; o += gb;
    cw = o; o += MAX_CLUSTER * gb;
    cl = o; o += gb;
    ex = o; o += extra;
    o = (o + 3) & ~3;                    // the ring 16-byte aligned
    ring = o;
    const int ring_f = nst * stage_bytes / 4;
    o += ring_f > NWARPS * gb * dh ? ring_f : NWARPS * gb * dh;
    bytes = o * 4;
  }
};

// One block of the step.  qb: the block's G query heads (G x dh,
// contiguous); ob: their output; n: the row's live positions; ranks: the
// plan's cluster (the launch's holds at least min(ranks, tiles) blocks);
// stage_bytes, nst: each warp's ring (a stage holds the TW positions the
// warp takes of a tile).  Cache (the kernel's own code) provides
//   issue(stage, p0, lane): cp.async copies of positions [p0, p0 + TW) ∩
//     [0, n) into a warp's stage (the warp's lanes take part);
//   fetch(): an Early value, loads that do not wait for the row's position
//     (the INT4 kernel's fresh row), issued with q's;
//   prepare(ex, early, run_first, run_stop): anything the block needs
//     beside the tiles, into ex, before the first tile;
//   k8(stage, t, p, f0, x): K features f0 .. f0 + 7 of position p (row t
//     of the warp's stage) in f32;
//   vrow<DPL>(stage, t, p, f0, x): V features f0 .. f0 + DPL - 1.
template <int DPL, int G, typename QT, typename Cache>
__device__ __forceinline__ void decode_block(float* smem, const Layout& lay, const QT* qb, QT* ob,
                                             int n, int ranks, int dh, float scale,
                                             int stage_bytes, int nst, const Cache& cache) {
  static_assert(G * DPL <= ACC, "a lane holds G x DPL accumulators");
  constexpr int gb = G;
  // positions a lane group takes of a warp's slice: TW / PP (2 at dh >= 64,
  // 1 below), never more than 2
  constexpr int NP = DPL >= 2 ? 2 : 1;
  // q's elements a thread loads: G dh <= 32 / DPL x 32 DPL = 1024 in all
  constexpr int QPT = 32 * 32 / THREADS;
  DA_PHASE_BEGIN
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // q's loads (and the kernel's early ones) fly while the row's position,
  // on which the run depends, arrives
  float qr[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * THREADS;
    qr[j] = i < gb * dh ? to_f32(qb[i]) : 0.f;
  }
  const auto early = cache.fetch();
  const Run run = rank_run(n, ranks, rank);
  // this warp's ring: stage s holds the TW positions it takes of a tile
  char* ring = reinterpret_cast<char*>(smem + lay.ring) + warp * nst * stage_bytes;
  const int pw = run.t0 * TILE + warp * TW;   // its first position

  // the first tiles' copies fly while q loads
  for (int s = 0; s < nst - 1; ++s) {
    if (s < run.nt) cache.issue(ring + s * stage_bytes, pw + s * TILE, lane);
    cp_async_commit();
  }
  if (run.nt > 0)
    cache.prepare(smem + lay.ex, early, run.t0 * TILE, (run.t0 + run.nt) * TILE);
  float* qs = smem + lay.qs;
#pragma unroll
  for (int j = 0; j < QPT; ++j)
    if (tid + j * THREADS < gb * dh) qs[tid + j * THREADS] = qr[j];

  const int L = lanes_per_row(dh), PP = 32 / L;
  const int sub = lane & (L - 1), grp = lane / L;
  const int nchunk = dh / 8;
  float* sw = smem + lay.sw + warp * gb * TW;
  float* pb = smem + lay.pb + warp * TW * gb;
  float* al = smem + lay.al + warp * gb;
  float* wm = smem + lay.wm + warp * gb;     // the warp's running max and sum
  float* wl = smem + lay.wl + warp * gb;     // a head
  for (int h = lane; h < gb; h += 32) {
    wm[h] = NEG_INF;
    wl[h] = 0.f;
  }
  float acc[G][DPL];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[h][d] = 0.f;
  const int f_own = lane * DPL;          // this lane's output features
  __syncthreads();                       // q and the kernel's own staging
  DA_PHASE(6)

  for (int it = 0; it < run.nt; ++it) {
    cp_async_wait(nst - 2);
    __syncwarp();                        // the warp's rows landed; stage it - 1 read
    const int p0 = pw + it * TILE;
    if (it + nst - 1 < run.nt)
      cache.issue(ring + ((it + nst - 1) % nst) * stage_bytes, p0 + (nst - 1) * TILE, lane);
    cp_async_commit();
    DA_PHASE(0)
    const char* st = ring + (it % nst) * stage_bytes;
    const int nv = min(TW, n - p0);
    if (nv <= 0) continue;               // the row ends before this warp's slice

    // scores: lane group grp takes positions grp, grp + PP, ... of the
    // slice (NP of them at once), lane sub its chunks c = sub, sub + L, ...
    {
      bool ok[NP];
      float s[NP][G];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        ok[i] = i * PP + grp < nv;
#pragma unroll
        for (int h = 0; h < G; ++h) s[i][h] = 0.f;
      }
      for (int c = sub; c < nchunk; c += L) {
        float k[NP][8];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          if (ok[i]) {
            cache.k8(st, i * PP + grp, p0 + i * PP + grp, c * 8, k[i]);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) k[i][j] = 0.f;
          }
        }
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + h * dh + c * 8);
          const float4 qc = *reinterpret_cast<const float4*>(qs + h * dh + c * 8 + 4);
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            float a = s[i][h];
            a = fmaf(qa.x, k[i][0], a);
            a = fmaf(qa.y, k[i][1], a);
            a = fmaf(qa.z, k[i][2], a);
            a = fmaf(qa.w, k[i][3], a);
            a = fmaf(qc.x, k[i][4], a);
            a = fmaf(qc.y, k[i][5], a);
            a = fmaf(qc.z, k[i][6], a);
            s[i][h] = fmaf(qc.w, k[i][7], a);
          }
        }
      }
      // the group's sums, one tree level for every (position, head) at once
      for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int i = 0; i < NP; ++i) s[i][h] += __shfl_xor_sync(0xffffffffu, s[i][h], o);
      }
      if (sub == 0) {
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int i = 0; i < NP; ++i)
            if (ok[i]) sw[h * TW + i * PP + grp] = s[i][h] * scale;
      }
    }
    __syncwarp();
    DA_PHASE(1)

    // online softmax over the slice: lane (h, t) for TW positions of
    // 32 / TW heads at a time; max and sum over the slice by shuffles
    for (int h0 = 0; h0 < gb; h0 += 32 / TW) {
      const int h = h0 + lane / TW, t = lane % TW;
      const bool on = h < gb, ok = on && t < nv;
      const float sv = ok ? sw[h * TW + t] : NEG_INF;
      const float m_old = on ? wm[h] : NEG_INF;
      float mt = sv;
#pragma unroll
      for (int o = TW / 2; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_old, mt);
      const float p = ok ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = TW / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (on) pb[t * gb + h] = p;
      if (on && t == 0) {
        const float alpha = m_old > NEG_INF / 2 ? expf(m_old - m_new) : 0.f;
        wl[h] = wl[h] * alpha + sum;
        wm[h] = m_new;
        al[h] = alpha;
      }
    }
    __syncwarp();
    DA_PHASE(2)

    // P.V: lane owns features f_own .. f_own + DPL - 1 of every head
    if (f_own < dh) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float a = al[h];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[h][d] *= a;
      }
      for (int t = 0; t < nv; ++t) {
        float v[DPL];
        cache.template vrow<DPL>(st, t, p0 + t, f_own, v);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float p = pb[t * gb + h];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[h][d] = fmaf(p, v[d], acc[h][d]);
        }
      }
    }
    DA_PHASE(3)
  }

  // the warps' partials, merged in warp order into the rank's
  cp_async_wait(0);
  __syncthreads();                       // the rings drained: their space holds the partials
  float* wo = smem + lay.ring;           // (warp, head, dh); the rank's is warp 0's
  wm = smem + lay.wm;                    // every warp's (m, l), (warp, head)
  wl = smem + lay.wl;
  if (f_own < dh) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int d = 0; d < DPL; ++d) wo[(warp * gb + h) * dh + f_own + d] = acc[h][d];
  }
  __syncthreads();
  float* rm = smem + lay.rm;
  float* rl = smem + lay.rl;
  float* wc = smem + lay.al;             // the warps' weights (warp, head)
  if (tid < gb) {
    float m = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, wm[w * gb + tid]);
    float l = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(wm[w * gb + tid] - m);
      wc[w * gb + tid] = c;
      l += wl[w * gb + tid] * c;
    }
    rm[tid] = m;
    rl[tid] = l;
  }
  __syncthreads();
  for (int e = tid * 4; e < gb * dh; e += THREADS * 4) {
    const int h = e / dh;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < NWARPS; ++w) {
      const float c = wc[w * gb + h];
      const float4 x = *reinterpret_cast<const float4*>(wo + (size_t)w * gb * dh + e);
      o.x += x.x * c;
      o.y += x.y * c;
      o.z += x.z * c;
      o.w += x.w * c;
    }
    *reinterpret_cast<float4*>(wo + e) = o;
  }
  DA_PHASE(4)

  // the cluster's combine: each used rank's (m, l) once a head, then the
  // output's 4-feature vectors shared over the ranks, each in rank order
  cluster.sync();
  float* cw = smem + lay.cw;
  float* cl = smem + lay.cl;
  if (tid < gb) {
    // the used ranks' (m, l) RK at a time in flight, the sums in rank order
    float m = NEG_INF;
    for (int r0 = 0; r0 < run.used; r0 += RK) {
      float mr[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j)
        if (r0 + j < run.used) mr[j] = cluster.map_shared_rank(rm, r0 + j)[tid];
#pragma unroll
      for (int j = 0; j < RK; ++j)
        if (r0 + j < run.used) m = fmaxf(m, mr[j]);
    }
    float l = 0.f;
    for (int r0 = 0; r0 < run.used; r0 += RK) {
      float mr[RK], lr[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        if (r0 + j < run.used) {
          mr[j] = cluster.map_shared_rank(rm, r0 + j)[tid];
          lr[j] = cluster.map_shared_rank(rl, r0 + j)[tid];
        }
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        if (r0 + j < run.used) {
          const float c = expf(mr[j] - m);
          cw[(r0 + j) * gb + tid] = c;
          l += lr[j] * c;
        }
      }
    }
    cl[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int e = (rank * THREADS + tid) * 4; e < gb * dh; e += C * THREADS * 4) {
    const int h = e / dh;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < run.used; r0 += RK) {
      float4 x[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j)
        if (r0 + j < run.used)
          x[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(wo, r0 + j) + e);
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        if (r0 + j < run.used) {
          const float c = cw[(r0 + j) * gb + h];
          o.x += x[j].x * c;
          o.y += x[j].y * c;
          o.z += x[j].z * c;
          o.w += x[j].w * c;
        }
      }
    }
    const float den = cl[h];
    store4(ob + e, make_float4(o.x / den, o.y / den, o.z / den, o.w / den));
  }
  DA_PHASE(5)
  cluster.sync();                        // no rank leaves while others read it
  DA_PHASE_END
}

// Launch kernel on grid (x, b, C) in clusters of the C blocks of one
// (row, kv head, head chunk); C up to 16 (above 8 a non-portable size).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                           Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (grid.z > 8) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
