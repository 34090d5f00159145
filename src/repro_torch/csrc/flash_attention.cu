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
// emulates both).  A block is W warps (1, 2 or 4) of W heads of one kv
// group at the same 16 rows, so they share each K/V tile; W is the most
// that divides g (kernels/flash_attention.py: flash_plan): four heads
// sharing a tile beat one-warp blocks (four times the blocks, a block per
// SM at b = 1, sq = 37) at every main-path shape (tools/flash_phases.py).
// K/V tiles of 32 keys come in through a 3-stage cp.async ring (16-byte
// copies, one barrier per tile; the first copies fly while Q loads); rows
// are padded (K by 8 floats, V by 4) so that the fragment loads hit 32
// distinct banks.  Q's hi/lo fragments stay
// in registers for the whole key loop (dh <= 64; at dh = 128 Q stays f32 and
// splits at use).  At dh = 256 (Gemma 3) the O accumulator alone takes 128
// registers a thread, so Q moves to shared memory (each warp its own 16
// rows, padded like K, read as float2 and split at use) and the ring drops
// to 2 stages: 2 x 32 x (2 x 256 + 12) x 4 B = 134 KB plus 16.9 KB of Q per
// warp, one block per SM.  The online softmax runs in registers: each thread holds
// two rows' (m, l), row maxima come from quad shuffles, l is summed across
// the quad once at the end.  P needs no trip through shared memory: the
// k index of an m16n8k8 step is a free permutation of the 8 keys it sums
// over, so a thread's score pair (keys 2t, 2t + 1) is its A fragment as it
// stands, and V's B fragment reads those keys' rows.  The same holds for
// the dh sum of Q.K, which lets Q and K fragments load as float2.  Tiles
// that the causal or window mask leaves wholly empty for the 16 rows are
// never loaded; the heaviest rows' blocks launch first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;                 // query rows per warp (the mma's M)
constexpr int BK = 32;                   // keys per tile
constexpr int STAGES = 3;                // cp.async ring depth (2 at DH = 256)
constexpr int MAX_WARPS = 4;
constexpr float NEG_INF = -1e30f;

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

// the ring's depth and whether Q lives in shared memory, by DH
template <int DH>
__host__ __device__ constexpr int stages() { return DH > 128 ? 2 : STAGES; }
template <int DH>
__host__ __device__ constexpr bool q_in_smem() { return DH > 128; }

// shared memory of one block of `warps` warps, in bytes
template <int DH>
constexpr size_t smem_bytes(int warps) {
  return sizeof(float) * ((size_t)stages<DH>() * BK * (2 * DH + 12) +
                          (q_in_smem<DH>() ? (size_t)warps * ROWS * (DH + 8) : 0));
}

// DH: dh rounded up to 16, 32, 64, 128 or 256 (features past dh read as 0).
// grid (n_groups * ceil(sq / 16), hkv, b), blockDim 32 * W, W * n_groups = g.
template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int sq, int sk,
                       int h, int hkv, int dh, int causal, int window, int q_offset,
                       float scale, int n_groups) {
  constexpr int KS = DH + 8;             // K row stride in shared memory (floats)
  constexpr int VS = DH + 4;             // V row stride
  constexpr int STAGE = BK * (KS + VS);
  constexpr int NKS = DH / 8;            // k-steps of Q.K; n-tiles of P.V
  constexpr int NT = BK / 8;             // n-tiles of Q.K; k-steps of P.V
  constexpr bool PRESPLIT = DH <= 64;    // Q's lo terms kept in registers
  constexpr int NST = stages<DH>();
  constexpr bool QSM = q_in_smem<DH>();  // Q in shared memory, split at use
  constexpr int QS = DH + 8;             // its row stride (as K's)
  const int W = blockDim.x >> 5;
  const int g = h / hkv;
  const int n_qt = (sq + ROWS - 1) / ROWS;
  const int hg = blockIdx.x % n_groups;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_groups;
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int head = kh * g + hg * W + warp;
  const int row0 = qt * ROWS;
  const int nrows = min(ROWS, sq - row0);

  extern __shared__ __align__(16) float smem[];
  const size_t q_row = (size_t)h * dh, kv_row = (size_t)hkv * dh;

  // the keys any of the 16 rows attends; tiles outside are never loaded
  const int qp_lo = q_offset + row0, qp_hi = q_offset + row0 + nrows - 1;
  int k_hi = sk - 1;
  if (causal) k_hi = min(k_hi, qp_hi);
  int k_lo = 0;
  if (window) k_lo = max(0, qp_lo - window + 1);
  const int t_first = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - t_first + 1 : 0;

  const float* kb = k + (size_t)bi * sk * kv_row + (size_t)kh * dh;
  const float* vb = v + (size_t)bi * sk * kv_row + (size_t)kh * dh;
  auto load_tile = [&](int t, int st) {
    float* ks_ = smem + st * STAGE;
    float* vs_ = ks_ + BK * KS;
    const int t0 = (t_first + t) * BK;
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
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  // Q fragments of rows gid and gid + 8, features 8 ks + 2 tig and + 1:
  // a0 (gid, d), a1 (gid + 8, d), a2 (gid, d + 1), a3 (gid + 8, d + 1)
  uint32_t qa[QSM ? 1 : NKS][4];         // hi terms (or f32 values at DH = 128)
  uint32_t qb[PRESPLIT ? NKS : 1][4];    // lo terms
  float* qsm = smem + NST * STAGE + warp * ROWS * QS;   // this warp's Q (QSM)
  if constexpr (QSM) {
    // rows past nrows and features past dh as zeros; read by this warp only
    const float* qp = q + ((size_t)bi * sq + row0) * q_row + (size_t)head * dh;
    for (int i = lane; i < ROWS * (DH / 4); i += 32) {
      const int r = i / (DH / 4), c = (i - r * (DH / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows && c < dh) x = *reinterpret_cast<const float4*>(qp + r * q_row + c);
      *reinterpret_cast<float4*>(qsm + r * QS + c) = x;
    }
    __syncwarp();
  } else {
    const float* qp = q + ((size_t)bi * sq + row0) * q_row + (size_t)head * dh;
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

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();                     // tile t landed; tile t - 1's buffer free
    if (t + NST - 1 < n_tiles) load_tile(t + NST - 1, (t + NST - 1) % NST);
    cp_async_commit();
    const float* ks_ = smem + (t % NST) * STAGE;
    const float* vs_ = ks_ + BK * KS;
    const int t0 = (t_first + t) * BK;

    // S = Q K^T: s[nt] holds (gid, key 8 nt + 2 tig + {0, 1}), (gid + 8, ...)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
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
        mma3(s[nt], ah, al, kv.x, kv.y);
      }
    }

    // mask by position, then the online softmax of rows gid and gid + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + nt * 8 + 2 * tig + (j & 1);
        const int qp = qp_lo + gid + 8 * (j >> 1);
        const bool ok = kp < sk && (!causal || kp <= qp) && (!window || qp - kp < window);
        s[nt][j] = ok ? s[nt][j] * scale : NEG_INF;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
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
        const float p = s[nt][j] > NEG_INF / 2 ? expf(s[nt][j] - m[j >> 1]) : 0.f;
        s[nt][j] = p;
        rs[j >> 1] += p;
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
    // tig + 4), so the A fragment is s[kk] reordered
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);
      split(s[kk][2], ph[1], pl[1]);
      split(s[kk][1], ph[2], pl[2]);
      split(s[kk][3], ph[3], pl[3]);
      const float* v0 = vs_ + (kk * 8 + 2 * tig) * VS + gid;
#pragma unroll
      for (int dn = 0; dn < NKS; ++dn) mma3(o[dn], ph, pl, v0[dn * 8], v0[VS + dn * 8]);
    }
  }
  cp_async_wait<0>();

  float* ob = out + ((size_t)bi * sq + row0) * q_row + (size_t)head * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int dn = 0; dn < NKS; ++dn) {
    const int d = dn * 8 + 2 * tig;
    if (d >= dh) continue;
    if (gid < nrows)
      *reinterpret_cast<float2*>(ob + gid * q_row + d) =
          make_float2(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (gid + 8 < nrows)
      *reinterpret_cast<float2*>(ob + (gid + 8) * q_row + d) =
          make_float2(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

// ---- the bf16 instance -------------------------------------------------------
// The TPU kernel's arithmetic at bf16 (src/repro/kernels/flash_attention.py:
// _kernel): Q.K^T on the bf16 inputs with f32 accumulation, the online
// softmax in f32, the unnormalised P rounded to bf16 (p.astype(v.dtype))
// for a bf16 P.V product with f32 accumulation, l summed from the f32 P,
// one division by l at the end and a bf16 output.  Both products run on
// mma.sync.m16n8k16 bf16 (one product where the f32 instance issues three
// TF32 ones).  Q, K and V stay bf16 in shared memory, half the f32
// instance's bytes a tile, so the ring keeps 4 stages at DH <= 128 (3 at
// 256).  Rows are padded by 8 halves (16 bytes), so the 8 rows an ldmatrix
// reads fall in 8 distinct 16-byte bank groups.  Fragments come from
// ldmatrix: K's B fragments as stored (keys are the B operand's columns), V's
// through ldmatrix.trans (keys are its rows); P's A fragment is the score
// accumulator of two n-tiles, packed to bf16 pairs.  Q goes to shared
// memory (each warp its own 16 rows) and, at DH <= 128, into registers for
// the whole key loop; at DH = 256 the O accumulator takes 128 registers a
// thread, so Q's fragments are read from shared memory at each k-step.
// Masking, the tile range, the block layout and the order of the blocks
// are the f32 instance's.
constexpr int BPAD = 8;                  // row padding in bf16 elements (16 bytes)

template <int DH>
__host__ __device__ constexpr int bf16_stages() { return DH > 128 ? 3 : 4; }

template <int DH>
constexpr size_t bf16_smem_bytes(int warps) {
  return sizeof(uint16_t) * ((size_t)bf16_stages<DH>() * BK * 2 * (DH + BPAD) +
                             (size_t)warps * ROWS * (DH + BPAD));
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

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// DH: dh rounded up to 16, 32, 64, 128 or 256 (features past dh read as 0);
// the grid and block of the f32 instance.
template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_attention_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int sq,
                            int sk, int h, int hkv, int dh, int causal, int window,
                            int q_offset, float scale, int n_groups) {
  constexpr int LD = DH + BPAD;          // K, V and Q row stride in shared memory (halves)
  constexpr int STAGE = BK * 2 * LD;     // one K tile and one V tile
  constexpr int NK16 = DH / 16;          // k-steps of Q.K
  constexpr int NDN = DH / 8;            // n-tiles of P.V
  constexpr int NT = BK / 8;             // n-tiles of Q.K
  constexpr int NST = bf16_stages<DH>();
  constexpr bool QREG = DH <= 128;       // Q's fragments in registers
  const int g = h / hkv;
  const int n_qt = (sq + ROWS - 1) / ROWS;
  const int hg = blockIdx.x % n_groups;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_groups;
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int head = kh * g + hg * (int)(blockDim.x >> 5) + warp;
  const int row0 = qt * ROWS;
  const int nrows = min(ROWS, sq - row0);

  extern __shared__ __align__(16) uint16_t smem_h[];
  const size_t q_row = (size_t)h * dh, kv_row = (size_t)hkv * dh;

  // the keys any of the 16 rows attends; tiles outside are never loaded
  const int qp_lo = q_offset + row0, qp_hi = q_offset + row0 + nrows - 1;
  int k_hi = sk - 1;
  if (causal) k_hi = min(k_hi, qp_hi);
  int k_lo = 0;
  if (window) k_lo = max(0, qp_lo - window + 1);
  const int t_first = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - t_first + 1 : 0;

  const uint16_t* kb = k + (size_t)bi * sk * kv_row + (size_t)kh * dh;
  const uint16_t* vb = v + (size_t)bi * sk * kv_row + (size_t)kh * dh;
  auto load_tile = [&](int t, int st) {
    uint16_t* ks_ = smem_h + st * STAGE;
    uint16_t* vs_ = ks_ + BK * LD;
    const int t0 = (t_first + t) * BK;
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
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  // this warp's 16 rows of Q into shared memory (rows past nrows and
  // features past dh as zeros; read by this warp only)
  uint16_t* qsm = smem_h + NST * STAGE + warp * ROWS * LD;
  {
    const uint16_t* qp = q + ((size_t)bi * sq + row0) * q_row + (size_t)head * dh;
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

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();                     // tile t landed; tile t - 1's buffer free
    if (t + NST - 1 < n_tiles) load_tile(t + NST - 1, (t + NST - 1) % NST);
    cp_async_commit();
    const uint16_t* ks_ = smem_h + (t % NST) * STAGE;
    const uint16_t* vs_ = ks_ + BK * LD;
    const int t0 = (t_first + t) * BK;

    // S = Q K^T: s[nt] holds (gid, key 8 nt + 2 tig + {0, 1}), (gid + 8, ...)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
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
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // mask by position, then the online softmax of rows gid and gid + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + nt * 8 + 2 * tig + (j & 1);
        const int qp = qp_lo + gid + 8 * (j >> 1);
        const bool ok = kp < sk && (!causal || kp <= qp) && (!window || qp - kp < window);
        s[nt][j] = ok ? s[nt][j] * scale : NEG_INF;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
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
        const float p = s[nt][j] > NEG_INF / 2 ? expf(s[nt][j] - m[j >> 1]) : 0.f;
        s[nt][j] = p;
        rs[j >> 1] += p;                 // l sums the f32 P
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
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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

  uint16_t* ob = out + ((size_t)bi * sq + row0) * q_row + (size_t)head * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int dn = 0; dn < NDN; ++dn) {
    const int d = dn * 8 + 2 * tig;
    if (d >= dh) continue;
    if (gid < nrows)
      *reinterpret_cast<uint32_t*>(ob + gid * q_row + d) =
          pack_bf16(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (gid + 8 < nrows)
      *reinterpret_cast<uint32_t*>(ob + (gid + 8) * q_row + d) =
          pack_bf16(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

template <int DH, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int b, int sq, int sk, int h,
                   int hkv, int dh, int causal, int window, int q_offset, float scale,
                   int warps, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t smem = F32 ? smem_bytes<DH>(warps) : bf16_smem_bytes<DH>(warps);
  auto kernel = [] {
    if constexpr (F32) return flash_attention_kernel<DH>;
    else return flash_attention_bf16_kernel<DH>;
  }();
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_groups = (h / hkv) / warps;
  const dim3 grid(n_groups * ((sq + ROWS - 1) / ROWS), hkv, b);
  kernel<<<grid, 32 * warps, smem, stream>>>(q, k, v, out, sq, sk, h, hkv, dh, causal, window,
                                             q_offset, scale, n_groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, int b, int sq,
                      int sk, int h, int hkv, int dh, int causal, int window, int q_offset,
                      float scale, int warps, cudaStream_t s) {
#define FA_LAUNCH(D)                                                                          \
  launch<D, T>(static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), \
               static_cast<T*>(out), b, sq, sk, h, hkv, dh, causal, window, q_offset, scale,  \
               warps, s)
  return dh <= 16    ? FA_LAUNCH(16)
         : dh <= 32  ? FA_LAUNCH(32)
         : dh <= 64  ? FA_LAUNCH(64)
         : dh <= 128 ? FA_LAUNCH(128)
                     : FA_LAUNCH(256);
#undef FA_LAUNCH
}

}  // namespace

extern "C" {

// warps: heads of one kv group per block (1, 2 or 4, dividing h / hkv);
// bf16: 0 for f32 q, k, v and out (dh a multiple of 4), 1 for bf16 (raw 16
// bits; dh a multiple of 16); dh at most 256; 16-byte aligned q, k, v and
// out.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int b,
                           int sq, int sk, int h, int hkv, int dh, int causal, int window,
                           int q_offset, float scale, int warps, int bf16, void* stream) {
  if (dh % (bf16 ? 16 : 4) || dh > 256 || warps < 1 || warps > MAX_WARPS || (h / hkv) % warps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_dh<uint16_t>(q, k, v, out, b, sq, sk, h, hkv, dh, causal, window,
                                          q_offset, scale, warps, s)
                    : launch_dh<float>(q, k, v, out, b, sq, sk, h, hkv, dh, causal, window,
                                       q_offset, scale, warps, s));
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
