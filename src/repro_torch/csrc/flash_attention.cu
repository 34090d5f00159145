// Blocked causal GQA flash attention (prefill) for Hopper (sm_90a), products
// on the tensor cores: an f32 instance (f32 in and out, at fp32 accuracy)
// and a bf16 one (bf16 in and out, the TPU kernel's bf16 arithmetic; see
// "the bf16 instance" below).  What follows describes the f32 instance.
//
//   q (b, sq, h, dh); k/v (b, sk, hkv, dh) -> out (b, sq, h, dh)
//   query row i sits at position q_offset + i; key j at position j; it
//   attends j when (!causal || j <= q_pos) && (!window || q_pos - j < window).
//   A row with no key to attend outputs 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel), which asserted sq % block_q == 0 and
// sk % block_k == 0 and walked the kv blocks as a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Here a warp owns 16 query rows of one head
// and loops over the kv tiles itself; ragged tails are masked by position.
//
// What bounds it on this card, and what the design does about it: scores
// never touch device memory, so the traffic is q, k, v and out once and the
// kernel is bound by operations (2 * 2 * sq * sk_attended * dh per head).
// fp32 FMAs from shared memory ran at a few TFLOP/s (two shared loads per
// FMA), so both products run on mma.sync.m16n8k8 TF32 with fp32 accuracy:
// each operand splits as x = hi + lo (hi = cvt.rna.tf32(x), lo = tf32(x -
// hi)) and each product is lo*hi + hi*lo + hi*hi, small terms first,
// accumulated in f32 (one TF32 term misses the 2e-5 tolerance; the CPU test
// emulates both).
//
// The block.  What held the earlier design back was not the tensor cores but
// the warps an SM could hold: a block was W heads of one kv group at the same
// 16 rows, W the most of 1, 2, 4 dividing the group, so a group of 1 (MLA,
// whisper) ran one-warp blocks and a group of 2 (Gemma 3) two-warp ones, each
// loading every K/V tile for one or two warps; at DH 256 a block's shared
// memory leaves one block an SM, so one or two warps an SM.  Now a block is
// Wh x Wr warps (kernels/flash_attention.py: flash_plan): Wh heads of one kv
// group (dividing the group) times Wr row tiles of 16, Wh x Wr = 4 (a group
// of 1 runs 1 head x 64 rows, a group of 2 2 heads x 32 rows, a group of 4
// or more 4 heads x 16 rows as before) or 8 where one 4-warp block an SM is
// all the shared memory allows (DH 192 at f32, DH 256 at bf16).  All warps
// of a block share each
// K/V tile of the ring; the block walks the union of its rows' tile ranges,
// and a warp whose rows attend nothing in a tile skips that tile's products
// but still reaches the barriers.  Without a key split each row keeps its
// arithmetic exactly (the same tiles in the same order; a tile it does not
// attend adds nothing), so the output is bit-equal whatever Wh and Wr are.
// Shared memory lets two blocks share an SM wherever dh <= 128.
//
// The key split (S ranks of a thread-block cluster, S <= 8): where the grid
// is under one wave of the SMs and each rank still walks several tiles
// (whisper's cross prefill: 48 rows over 1500 keys, 8 blocks; a short prefill
// chunk over a long prefix), each rank walks a contiguous range of the
// block's key tiles, writes its (m, l, O) to its shared memory, and after one
// cluster barrier every rank merges a share of the block's rows from all
// ranks through distributed shared memory, in rank order (each row's
// weights once, then O four features a read): one launch, deterministic, no
// atomics, no scratch in device memory.  The plan also splits where one
// wave leaves some SMs a block more than others (whisper's encoder, Gemma
// 3's window at f32).
//
// K/V tiles of 32 keys come in through a 3-stage cp.async ring (16-byte
// copies, one barrier per tile; the first copies fly while Q loads); rows
// are padded (K by 8 floats, V by 4) so that the fragment loads hit 32
// distinct banks.  Q's hi/lo fragments stay in registers for the whole key
// loop (dh <= 64; at dh = 128 Q stays f32 and splits at use).  Above 128
// (DH 192: DeepSeek-V3's MLA, dn + dr = 192; DH 256: Gemma 3) the O
// accumulator takes 96 or 128 registers a thread, so Q moves to shared
// memory (each warp its own 16 rows, padded like K, read as float2 and split
// at use) and the ring drops to 2 stages: at DH 256, 2 x 32 x (2 x 256 + 12)
// x 4 B = 134 KB plus 16.9 KB of Q per warp, one block per SM.  DH 192 has
// its own instance (it ran as DH 256 before, a quarter of its products and
// shared memory on zero features).  The online softmax runs in registers:
// each thread holds two rows' (m, l), row maxima come from quad shuffles, l
// is summed across the quad once at the end.  P needs no trip through
// shared memory: the k index of an m16n8k8 step is a free permutation of
// the 8 keys it sums over, so a thread's score pair (keys 2t, 2t + 1) is its
// A fragment as it stands, and V's B fragment reads those keys' rows.  The
// same holds for the dh sum of Q.K, which lets Q and K fragments load as
// float2.  Tiles that the causal or window mask leaves wholly empty for a
// block's rows are never loaded; the heaviest rows' blocks launch first.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 16;                 // query rows per warp (the mma's M)
constexpr int BK = 32;                   // keys per tile
constexpr int STAGES = 3;                // cp.async ring depth (2 above DH 128)
constexpr int MAX_WARPS = 8;             // Wh x Wr
constexpr int MAX_SPLITS = 8;            // cluster ranks (the portable limit)
constexpr float NEG_INF = -1e30f;

// one launch: the problem and the plan
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, sk, h, hkv, dh, causal, window, q_offset;
  float scale;
  int wh, wr, splits;                    // heads, row tiles a block; cluster ranks
};

// a warp's rows and key tiles, and its block's (this rank's) tiles
struct Span {
  int kh, bi;
  int head0, rowb0;                      // the block's first head and row
  int head, row0, nrows;                 // this warp's (nrows <= 0: past sq)
  int qp_lo;                             // the position of row0
  int wt0, wt1;                          // this warp's tiles [wt0, wt1]
  int t0, n;                             // this rank's tiles [t0, t0 + n)
};

// the key tiles [lo, hi] the 16 rows from row0 attend (lo > hi: none)
__device__ __forceinline__ void tile_range(const Params& p, int row0, int& lo, int& hi) {
  lo = 1;
  hi = 0;
  const int nrows = min(ROWS, p.sq - row0);
  if (nrows <= 0) return;
  const int qp_lo = p.q_offset + row0, qp_hi = qp_lo + nrows - 1;
  int k_hi = p.sk - 1;
  if (p.causal) k_hi = min(k_hi, qp_hi);
  int k_lo = 0;
  if (p.window) k_lo = max(0, qp_lo - p.window + 1);
  if (k_hi < k_lo) return;
  lo = k_lo / BK;
  hi = k_hi / BK;
}

// grid (splits * n_hg * n_rb, hkv, b): x = (y * splits + rank), y = the
// block's (row block from the last, head group); warp w: head w % Wh, row
// tile w / Wh of the block
__device__ __forceinline__ Span block_span(const Params& p) {
  Span s;
  const int g = p.h / p.hkv;
  const int n_hg = g / p.wh;
  const int n_rb = ((p.sq + ROWS - 1) / ROWS + p.wr - 1) / p.wr;
  const int rank = (int)blockIdx.x % p.splits;
  const int y = (int)blockIdx.x / p.splits;
  const int hg = y % n_hg;
  const int rb = n_rb - 1 - y / n_hg;     // the heaviest rows first
  const int warp = (int)threadIdx.x >> 5;
  s.kh = blockIdx.y;
  s.bi = blockIdx.z;
  s.head0 = s.kh * g + hg * p.wh;
  s.rowb0 = rb * p.wr * ROWS;
  s.head = s.head0 + warp % p.wh;
  s.row0 = s.rowb0 + (warp / p.wh) * ROWS;
  s.nrows = min(ROWS, p.sq - s.row0);
  s.qp_lo = p.q_offset + s.row0;
  tile_range(p, s.row0, s.wt0, s.wt1);
  int b0 = 1 << 30, b1 = -1;             // the union over the block's row tiles
  for (int r = 0; r < p.wr; ++r) {
    int lo, hi;
    tile_range(p, s.rowb0 + r * ROWS, lo, hi);
    if (lo <= hi) {
      b0 = min(b0, lo);
      b1 = max(b1, hi);
    }
  }
  const int nb = b1 >= b0 ? b1 - b0 + 1 : 0;
  const int a = nb * rank / p.splits, e = nb * (rank + 1) / p.splits;
  s.t0 = (nb ? b0 : 0) + a;              // this rank's contiguous share
  s.n = e - a;
  return s;
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in three TF32 terms, small terms first; b given as two values
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// 16 bytes from src (n = 16) or zeros (n = 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}
__device__ __forceinline__ void store4(uint16_t* p, float4 a) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// a split block's rows: (m, l, -, -, O[DH]) at a 16-byte aligned stride,
// then each of its rows' weights in the merge, (L, a_0 .. a_{S-1})
template <int DH>
__host__ __device__ constexpr int merge_ld() { return DH + 4; }
template <int DH>
constexpr size_t merge_bytes(int warps) {
  return sizeof(float) * (size_t)warps * ROWS * (merge_ld<DH>() + 1 + MAX_SPLITS);
}

// The end of a warp's walk: its rows' output, o / l, written in T; or, with
// a key split, each rank's (m, l, O) into its shared memory (the ring is
// free by then) and, after a cluster barrier, the block's rows merged from
// every rank in rank order, this rank's share of them written.
template <int DH, typename T>
__device__ __forceinline__ void finish(const Params& p, const Span& s, float (&o)[DH / 8][4],
                                       const float (&m)[2], float (&l)[2], float* smem) {
  constexpr int NDN = DH / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  T* out = static_cast<T*>(p.out);
  const size_t q_row = (size_t)p.h * p.dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (p.splits == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(l[r], 1e-30f);
    T* ob = out + ((size_t)s.bi * p.sq + s.row0) * q_row + (size_t)s.head * p.dh;
#pragma unroll
    for (int dn = 0; dn < NDN; ++dn) {
      const int d = dn * 8 + 2 * tig;
      if (d >= p.dh) continue;
      if (gid < s.nrows) store2(ob + gid * q_row + d, o[dn][0] / l[0], o[dn][1] / l[0]);
      if (gid + 8 < s.nrows)
        store2(ob + (gid + 8) * q_row + d, o[dn][2] / l[1], o[dn][3] / l[1]);
    }
    return;
  }
  // row R = 16 warp + i of the block holds (m, l, -, -, O[DH]) at R * LD
  constexpr int LD = merge_ld<DH>();
  __syncthreads();                       // every warp is done with the ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = smem + (size_t)(warp * ROWS + gid + 8 * r) * LD;
    if (tig == 0) {
      row[0] = m[r];
      row[1] = l[r];
    }
#pragma unroll
    for (int dn = 0; dn < NDN; ++dn)
      *reinterpret_cast<float2*>(row + 4 + dn * 8 + 2 * tig) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int rows = (int)(blockDim.x >> 5) * ROWS;
  const int r_lo = rows * rank / p.splits, r_hi = rows * (rank + 1) / p.splits;
  // this rank's rows' weights: the largest m, each rank's exp(m_k - m) and
  // the merged l, once a row
  float* wts = smem + (size_t)rows * LD;
  for (int R = r_lo + tid; R < r_hi; R += blockDim.x) {
    float mx = NEG_INF;
    for (int k = 0; k < p.splits; ++k)
      mx = fmaxf(mx, cluster.map_shared_rank(smem, k)[(size_t)R * LD]);
    float* w = wts + (size_t)(R - r_lo) * (1 + MAX_SPLITS);
    float ls = 0.f;
    for (int k = 0; k < p.splits; ++k) {
      const float* src = cluster.map_shared_rank(smem, k) + (size_t)R * LD;
      const float a = src[0] > NEG_INF / 2 ? expf(src[0] - mx) : 0.f;
      w[1 + k] = a;
      ls += a * src[1];
    }
    w[0] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  // then 4 features at a time: O summed over the ranks in rank order
  for (int e = tid; e < (r_hi - r_lo) * (DH / 4); e += blockDim.x) {
    const int R = r_lo + e / (DH / 4), d = 4 * (e % (DH / 4));
    const int w = R / ROWS;
    const int row = s.rowb0 + (w / p.wh) * ROWS + R % ROWS;
    if (row >= p.sq || d >= p.dh) continue;
    const float* wt = wts + (size_t)(R - r_lo) * (1 + MAX_SPLITS);
    float4 os = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < p.splits; ++k) {
      const float a = wt[1 + k];
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(smem, k) + (size_t)R * LD + 4 + d);
      os.x += a * v.x;
      os.y += a * v.y;
      os.z += a * v.z;
      os.w += a * v.w;
    }
    const float inv = wt[0];
    store4(out + ((size_t)s.bi * p.sq + row) * q_row + (size_t)(s.head0 + w % p.wh) * p.dh + d,
           make_float4(os.x / inv, os.y / inv, os.z / inv, os.w / inv));
  }
  cluster.sync();                        // no rank leaves while another reads it
}

// the ring's depth and whether Q lives in shared memory, by DH
template <int DH>
__host__ __device__ constexpr int stages() { return DH > 128 ? 2 : STAGES; }
template <int DH>
__host__ __device__ constexpr bool q_in_smem() { return DH > 128; }

// shared memory of one block of `warps` warps, in bytes
template <int DH>
constexpr size_t smem_bytes(int warps, int splits) {
  const size_t ring = sizeof(float) * ((size_t)stages<DH>() * BK * (2 * DH + 12) +
                                       (q_in_smem<DH>() ? (size_t)warps * ROWS * (DH + 8) : 0));
  return splits > 1 && merge_bytes<DH>(warps) > ring ? merge_bytes<DH>(warps) : ring;
}

// DH: dh rounded up to 16, 32, 64, 128, 192 or 256 (features past dh read
// as 0); the grid of block_span, blockDim 32 * Wh * Wr.
template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS) flash_attention_kernel(const Params p) {
  constexpr int KS = DH + 8;             // K row stride in shared memory (floats)
  constexpr int VS = DH + 4;             // V row stride
  constexpr int STAGE = BK * (KS + VS);
  constexpr int NKS = DH / 8;            // k-steps of Q.K; n-tiles of P.V
  constexpr int NT = BK / 8;             // n-tiles of Q.K; k-steps of P.V
  constexpr bool PRESPLIT = DH <= 64;    // Q's lo terms kept in registers
  constexpr int NST = stages<DH>();
  constexpr bool QSM = q_in_smem<DH>();  // Q in shared memory, split at use
  constexpr int QS = DH + 8;             // its row stride (as K's)
  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);
  const Span s = block_span(p);
  const int dh = p.dh, sk = p.sk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = s.nrows;

  extern __shared__ __align__(16) float smem[];
  const size_t q_row = (size_t)p.h * dh, kv_row = (size_t)p.hkv * dh;

  const float* kb = k + (size_t)s.bi * sk * kv_row + (size_t)s.kh * dh;
  const float* vb = v + (size_t)s.bi * sk * kv_row + (size_t)s.kh * dh;
  auto load_tile = [&](int t, int st) {
    float* ks_ = smem + st * STAGE;
    float* vs_ = ks_ + BK * KS;
    const int t0 = (s.t0 + t) * BK;
    constexpr int CPR = DH / 4;          // 16-byte pieces per row
    for (int i = tid; i < 2 * BK * CPR; i += blockDim.x) {
      const int tensor = i / (BK * CPR);
      const int rem = i - tensor * BK * CPR;
      const int r = rem / CPR, c = (rem - r * CPR) * 4;
      const bool ok = t0 + r < sk && c < dh;
      const float* src = (tensor ? vb : kb) + (ok ? (size_t)(t0 + r) * kv_row + c : 0);
      cp_async16(tensor ? vs_ + r * VS + c : ks_ + r * KS + c, src, ok ? 16 : 0);
    }
  };

  // the first tiles' copies fly while Q loads
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < s.n) load_tile(st, st);
    cp_async_commit();
  }
  // Q fragments of rows gid and gid + 8, features 8 ks + 2 tig and + 1:
  // a0 (gid, d), a1 (gid + 8, d), a2 (gid, d + 1), a3 (gid + 8, d + 1);
  // rows past nrows (all of them for a warp past sq) read as zeros
  uint32_t qa[QSM ? 1 : NKS][4];         // hi terms (or f32 values at DH = 128)
  uint32_t qb[PRESPLIT ? NKS : 1][4];    // lo terms
  float* qsm = smem + NST * STAGE + warp * ROWS * QS;   // this warp's Q (QSM)
  const float* qp = q + ((size_t)s.bi * p.sq + s.row0) * q_row + (size_t)s.head * dh;
  if constexpr (QSM) {
    // read by this warp only
    for (int i = lane; i < ROWS * (DH / 4); i += 32) {
      const int r = i / (DH / 4), c = (i - r * (DH / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows && c < dh) x = *reinterpret_cast<const float4*>(qp + r * q_row + c);
      *reinterpret_cast<float4*>(qsm + r * QS + c) = x;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const int d = ks * 8 + 2 * tig;
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (d < dh && gid < nrows) x0 = *reinterpret_cast<const float2*>(qp + gid * q_row + d);
      if (d < dh && gid + 8 < nrows)
        x1 = *reinterpret_cast<const float2*>(qp + (gid + 8) * q_row + d);
      const float x[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (PRESPLIT) split(x[j], qa[ks][j], qb[ks][j]);
        else qa[ks][j] = __float_as_uint(x[j]);
      }
    }
  }

  float o[NKS][4];
#pragma unroll
  for (int i = 0; i < NKS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < s.n; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();                     // tile t landed; tile t - 1's buffer free
    if (t + NST - 1 < s.n) load_tile(t + NST - 1, (t + NST - 1) % NST);
    cp_async_commit();
    const int tile = s.t0 + t;
    if (tile < s.wt0 || tile > s.wt1) continue;   // nothing this warp attends
    const float* ks_ = smem + (t % NST) * STAGE;
    const float* vs_ = ks_ + BK * KS;
    const int t0 = tile * BK;

    // S = Q K^T: s[nt] holds (gid, key 8 nt + 2 tig + {0, 1}), (gid + 8, ...)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t ah[4], al[4];
      if constexpr (QSM) {
        const float2 x0 = *reinterpret_cast<const float2*>(qsm + gid * QS + ks * 8 + 2 * tig);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qsm + (gid + 8) * QS + ks * 8 + 2 * tig);
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (PRESPLIT) {
            ah[j] = qa[ks][j];
            al[j] = qb[ks][j];
          } else {
            split(__uint_as_float(qa[ks][j]), ah[j], al[j]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kv =
            *reinterpret_cast<const float2*>(ks_ + (nt * 8 + gid) * KS + ks * 8 + 2 * tig);
        mma3(sc[nt], ah, al, kv.x, kv.y);
      }
    }

    // mask by position, then the online softmax of rows gid and gid + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + nt * 8 + 2 * tig + (j & 1);
        const int qpos = s.qp_lo + gid + 8 * (j >> 1);
        const bool ok =
            kp < sk && (!p.causal || kp <= qpos) && (!p.window || qpos - kp < p.window);
        sc[nt][j] = ok ? sc[nt][j] * p.scale : NEG_INF;
        mx[j >> 1] = fmaxf(mx[j >> 1], sc[nt][j]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m[r] > NEG_INF / 2 ? expf(m[r] - m_new) : 0.f;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = sc[nt][j] > NEG_INF / 2 ? expf(sc[nt][j] - m[j >> 1]) : 0.f;
        sc[nt][j] = pv;
        rs[j >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];   // this thread's share
#pragma unroll
    for (int dn = 0; dn < NKS; ++dn) {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[dn][j] *= alpha[j >> 1];
    }

    // O += P V: k-step kk sums keys 8 kk + 2 tig (A cols tig) and + 1 (cols
    // tig + 4), so the A fragment is sc[kk] reordered
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      split(sc[kk][0], ph[0], pl[0]);
      split(sc[kk][2], ph[1], pl[1]);
      split(sc[kk][1], ph[2], pl[2]);
      split(sc[kk][3], ph[3], pl[3]);
      const float* v0 = vs_ + (kk * 8 + 2 * tig) * VS + gid;
#pragma unroll
      for (int dn = 0; dn < NKS; ++dn) mma3(o[dn], ph, pl, v0[dn * 8], v0[VS + dn * 8]);
    }
  }
  cp_async_wait<0>();
  finish<DH, float>(p, s, o, m, l, smem);
}

// ---- the bf16 instance -------------------------------------------------------
// The TPU kernel's arithmetic at bf16 (src/repro/kernels/flash_attention.py:
// _kernel): Q.K^T on the bf16 inputs with f32 accumulation, the online
// softmax in f32, the unnormalised P rounded to bf16 (p.astype(v.dtype))
// for a bf16 P.V product with f32 accumulation, l summed from the f32 P,
// one division by l at the end and a bf16 output (with a key split, each
// rank's unnormalised P is rounded the same way and the ranks' f32 (m, l,
// O) merge before that one division).  Both products run on
// mma.sync.m16n8k16 bf16 (one product where the f32 instance issues three
// TF32 ones).  Q, K and V stay bf16 in shared memory, half the f32
// instance's bytes a tile, so the ring keeps 4 stages at DH <= 128 (3
// above).  Rows are padded by 8 halves (16 bytes), so the 8 rows an
// ldmatrix reads fall in 8 distinct 16-byte bank groups.  Fragments come
// from ldmatrix: K's B fragments as stored (keys are the B operand's
// columns), V's through ldmatrix.trans (keys are its rows); P's A fragment
// is the score accumulator of two n-tiles, packed to bf16 pairs.  Q goes to
// shared memory (each warp its own 16 rows) and, at DH <= 128, into
// registers for the whole key loop; at DH 192 and 256 the O accumulator
// takes 96 or 128 registers a thread, so Q's fragments are read from shared
// memory at each k-step.  Masking, the tile range, the block layout, the
// key split and the order of the blocks are the f32 instance's.
constexpr int BPAD = 8;                  // row padding in bf16 elements (16 bytes)

template <int DH>
__host__ __device__ constexpr int bf16_stages() { return DH > 128 ? 3 : 4; }

template <int DH>
constexpr size_t bf16_smem_bytes(int warps, int splits) {
  const size_t ring = sizeof(uint16_t) * ((size_t)bf16_stages<DH>() * BK * 2 * (DH + BPAD) +
                                          (size_t)warps * ROWS * (DH + BPAD));
  return splits > 1 && merge_bytes<DH>(warps) > ring ? merge_bytes<DH>(warps) : ring;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives element (lane / 4, 2 (lane % 4) + {0, 1}) of each (with
// trans: elements (2 (lane % 4) + {0, 1}, lane / 4))
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// DH: dh rounded up to 16, 32, 64, 128, 192 or 256 (features past dh read
// as 0); the grid and block of the f32 instance.
template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS) flash_attention_bf16_kernel(const Params p) {
  constexpr int LD = DH + BPAD;          // K, V and Q row stride in shared memory (halves)
  constexpr int STAGE = BK * 2 * LD;     // one K tile and one V tile
  constexpr int NK16 = DH / 16;          // k-steps of Q.K
  constexpr int NDN = DH / 8;            // n-tiles of P.V
  constexpr int NT = BK / 8;             // n-tiles of Q.K
  constexpr int NST = bf16_stages<DH>();
  constexpr bool QREG = DH <= 128;       // Q's fragments in registers
  const uint16_t* __restrict__ q = static_cast<const uint16_t*>(p.q);
  const uint16_t* __restrict__ k = static_cast<const uint16_t*>(p.k);
  const uint16_t* __restrict__ v = static_cast<const uint16_t*>(p.v);
  const Span s = block_span(p);
  const int dh = p.dh, sk = p.sk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = s.nrows;

  extern __shared__ __align__(16) uint16_t smem_h[];
  const size_t q_row = (size_t)p.h * dh, kv_row = (size_t)p.hkv * dh;

  const uint16_t* kb = k + (size_t)s.bi * sk * kv_row + (size_t)s.kh * dh;
  const uint16_t* vb = v + (size_t)s.bi * sk * kv_row + (size_t)s.kh * dh;
  auto load_tile = [&](int t, int st) {
    uint16_t* ks_ = smem_h + st * STAGE;
    uint16_t* vs_ = ks_ + BK * LD;
    const int t0 = (s.t0 + t) * BK;
    constexpr int CPR = DH / 8;          // 16-byte pieces per row
    for (int i = tid; i < 2 * BK * CPR; i += blockDim.x) {
      const int tensor = i / (BK * CPR);
      const int rem = i - tensor * BK * CPR;
      const int r = rem / CPR, c = (rem - r * CPR) * 8;
      const bool ok = t0 + r < sk && c < dh;
      const uint16_t* src = (tensor ? vb : kb) + (ok ? (size_t)(t0 + r) * kv_row + c : 0);
      cp_async16((tensor ? vs_ : ks_) + r * LD + c, src, ok ? 16 : 0);
    }
  };

  // the first tiles' copies fly while Q loads
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < s.n) load_tile(st, st);
    cp_async_commit();
  }
  // this warp's 16 rows of Q into shared memory (rows past nrows and
  // features past dh as zeros; read by this warp only)
  uint16_t* qsm = smem_h + NST * STAGE + warp * ROWS * LD;
  {
    const uint16_t* qp = q + ((size_t)s.bi * p.sq + s.row0) * q_row + (size_t)s.head * dh;
    for (int i = lane; i < ROWS * (DH / 8); i += 32) {
      const int r = i / (DH / 8), c = (i - r * (DH / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && c < dh) x = *reinterpret_cast<const uint4*>(qp + r * q_row + c);
      *reinterpret_cast<uint4*>(qsm + r * LD + c) = x;
    }
    __syncwarp();
  }
  // Q's A fragment of k-step ks: matrices (rows 0-7 | 8-15) x (cols 16 ks |
  // 16 ks + 8); lane i points at row i % 8 + 8 ((i / 8) & 1), column
  // 16 ks + 8 (i / 16)
  const uint16_t* q_lane = qsm + (lane & 7) * LD + ((lane >> 3) & 1) * 8 * LD + (lane >> 4) * 8;
  uint32_t qa[QREG ? NK16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < NK16; ++ks) ldsm_x4(qa[ks], q_lane + ks * 16);
  }
  // K's B fragments of n-tiles (2 j, 2 j + 1) at k-step ks: matrices (keys
  // 16 j + 0-7 | + 8-15) x (cols 16 ks | + 8); lane i points at key
  // 16 j + i % 8 + 8 (i / 16), column 16 ks + 8 ((i / 8) & 1)
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  // V's B fragments of d-tiles (2 j, 2 j + 1) at key step kk (trans):
  // matrices (keys 16 kk + 0-7 | + 8-15) x (cols 16 j | + 8); lane i points
  // at key 16 kk + i % 8 + 8 ((i / 8) & 1), column 16 j + 8 (i / 16)
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  float o[NDN][4];
#pragma unroll
  for (int i = 0; i < NDN; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < s.n; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();                     // tile t landed; tile t - 1's buffer free
    if (t + NST - 1 < s.n) load_tile(t + NST - 1, (t + NST - 1) % NST);
    cp_async_commit();
    const int tile = s.t0 + t;
    if (tile < s.wt0 || tile > s.wt1) continue;   // nothing this warp attends
    const uint16_t* ks_ = smem_h + (t % NST) * STAGE;
    const uint16_t* vs_ = ks_ + BK * LD;
    const int t0 = tile * BK;

    // S = Q K^T: sc[nt] holds (gid, key 8 nt + 2 tig + {0, 1}), (gid + 8, ...)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK16; ++ks) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = qa[ks][j];
      } else {
        ldsm_x4(a, q_lane + ks * 16);
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, ks_ + k_lane + j * 16 * LD + ks * 16);
        mma_bf16(sc[2 * j], a, bk[0], bk[1]);
        mma_bf16(sc[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // mask by position, then the online softmax of rows gid and gid + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + nt * 8 + 2 * tig + (j & 1);
        const int qpos = s.qp_lo + gid + 8 * (j >> 1);
        const bool ok =
            kp < sk && (!p.causal || kp <= qpos) && (!p.window || qpos - kp < p.window);
        sc[nt][j] = ok ? sc[nt][j] * p.scale : NEG_INF;
        mx[j >> 1] = fmaxf(mx[j >> 1], sc[nt][j]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m[r] > NEG_INF / 2 ? expf(m[r] - m_new) : 0.f;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = sc[nt][j] > NEG_INF / 2 ? expf(sc[nt][j] - m[j >> 1]) : 0.f;
        sc[nt][j] = pv;
        rs[j >> 1] += pv;                // l sums the f32 P
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];   // this thread's share
#pragma unroll
    for (int dn = 0; dn < NDN; ++dn) {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[dn][j] *= alpha[j >> 1];
    }

    // O += bf16(P) V: key step kk sums keys 16 kk + 0-15, whose A fragment
    // is the accumulators of n-tiles 2 kk and 2 kk + 1 rounded to bf16
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NDN / 2; ++j) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs_ + v_lane + kk * 16 * LD + j * 16);
        mma_bf16(o[2 * j], pa, bv[0], bv[1]);
        mma_bf16(o[2 * j + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  finish<DH, uint16_t>(p, s, o, m, l, reinterpret_cast<float*>(smem_h));
}

template <int DH, typename T>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const int warps = p.wh * p.wr;
  const size_t smem =
      F32 ? smem_bytes<DH>(warps, p.splits) : bf16_smem_bytes<DH>(warps, p.splits);
  auto kernel = [] {
    if constexpr (F32) return flash_attention_kernel<DH>;
    else return flash_attention_bf16_kernel<DH>;
  }();
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_hg = (p.h / p.hkv) / p.wh;
  const int n_rb = ((p.sq + ROWS - 1) / ROWS + p.wr - 1) / p.wr;
  const dim3 grid(p.splits * n_hg * n_rb, p.hkv, b), block(32 * warps);
  if (p.splits == 1) {
    kernel<<<grid, block, smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int b, cudaStream_t s) {
  const int dh = p.dh;
  return dh <= 16    ? launch<16, T>(p, b, s)
         : dh <= 32  ? launch<32, T>(p, b, s)
         : dh <= 64  ? launch<64, T>(p, b, s)
         : dh <= 128 ? launch<128, T>(p, b, s)
         : dh <= 192 ? launch<192, T>(p, b, s)
                     : launch<256, T>(p, b, s);
}

}  // namespace

extern "C" {

// wh: heads of one kv group a block (dividing h / hkv); wr: row tiles of 16
// a block (wh * wr <= 8 warps); splits: key splits, the ranks of a cluster
// (1 to 8); bf16: 0 for f32 q, k, v and out (dh a multiple of 4), 1 for
// bf16 (raw 16 bits; dh a multiple of 16); dh at most 256; 16-byte aligned
// q, k, v and out.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int b,
                           int sq, int sk, int h, int hkv, int dh, int causal, int window,
                           int q_offset, float scale, int wh, int wr, int splits, int bf16,
                           void* stream) {
  if (dh % (bf16 ? 16 : 4) || dh > 256 || wh < 1 || wr < 1 || wh * wr > MAX_WARPS ||
      (h / hkv) % wh || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const Params p = {q,  k,        v,      out,   sq, sk, h,  hkv, dh,
                    causal, window, q_offset, scale, wh, wr, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_dh<uint16_t>(p, b, s) : launch_dh<float>(p, b, s));
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
