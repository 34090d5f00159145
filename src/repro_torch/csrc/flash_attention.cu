// Blocked causal GQA flash attention (prefill) for Hopper (sm_90a), fp32 in
// and out, products on the tensor cores.
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

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int b, int sq,
                   int sk, int h, int hkv, int dh, int causal, int window, int q_offset,
                   float scale, int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(warps);
  auto kernel = flash_attention_kernel<DH>;
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

}  // namespace

extern "C" {

// warps: heads of one kv group per block (1, 2 or 4, dividing h / hkv);
// dh a multiple of 4, at most 256; 16-byte aligned q, k, v and out.
int flash_attention_launch(const float* q, const float* k, const float* v, float* out, int b,
                           int sq, int sk, int h, int hkv, int dh, int causal, int window,
                           int q_offset, float scale, int warps, void* stream) {
  if (dh % 4 || dh > 256 || warps < 1 || warps > MAX_WARPS || (h / hkv) % warps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(D) \
  launch<D>(q, k, v, out, b, sq, sk, h, hkv, dh, causal, window, q_offset, scale, warps, s)
  const cudaError_t e = dh <= 16   ? FA_LAUNCH(16)
                        : dh <= 32 ? FA_LAUNCH(32)
                        : dh <= 64 ? FA_LAUNCH(64)
                        : dh <= 128 ? FA_LAUNCH(128)
                                    : FA_LAUNCH(256);
#undef FA_LAUNCH
  return (int)e;
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
