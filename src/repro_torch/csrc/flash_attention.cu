// Blocked causal GQA flash attention (prefill) for Hopper (sm_90a), fp32.
//
//   q (b, sq, h, dh); k/v (b, sk, hkv, dh) -> out (b, sq, h, dh)
//   query row i sits at position q_offset + i; key j at position j; it
//   attends j when (!causal || j <= q_pos) && (!window || q_pos - j < window).
//   A row with no key to attend outputs 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel), which asserted sq % block_q == 0 and
// sk % block_k == 0 and walked the kv blocks as a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Here one block owns (batch, head, 32 query
// rows) and loops over kv tiles itself; ragged tails are masked.
//
// What bounds it on this card, and what the design does about it: scores
// never touch device memory (they live in shared memory per 32x32 tile), so
// memory traffic is q, k, v and out once per block and the kernel is bound by
// fp32 operations (2 * 2 * sq * sk_attended * dh per head; no tensor cores,
// whose TF32 would cost the 2e-5 tolerance).  kv tiles that the causal or
// window mask leaves entirely empty for the block's rows are skipped, which
// halves the work of a causal prefill.  GQA maps head -> kv head in the
// index arithmetic; K/V are never duplicated.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int BQ = 32;                   // query rows per block
constexpr int BKV = 32;                  // keys per tile (one per lane)
constexpr int MAX_ACC = 32;              // BQ * dh <= THREADS * MAX_ACC (dh <= 128)
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

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int sq, int sk, int h, int hkv, int dh, int causal,
                       int window, int q_offset, float scale) {
  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int kh = hi / (h / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = qt * BQ;
  const int nrows = min(BQ, sq - row0);

  extern __shared__ float smem[];
  float* qs = smem;                      // BQ * dh
  float* ks = qs + BQ * dh;              // BKV * (dh + 1)
  float* vs = ks + BKV * (dh + 1);       // BKV * dh
  float* ss = vs + BKV * dh;             // BQ * BKV scores, then probs
  float* ms = ss + BQ * BKV;             // BQ running max
  float* ls = ms + BQ;                   // BQ running denominator
  float* as = ls + BQ;                   // BQ this tile's rescale

  const size_t q_row = (size_t)h * dh;   // stride between query positions
  const size_t kv_row = (size_t)hkv * dh;
  const float* qb = q + ((size_t)bi * sq + row0) * q_row + (size_t)hi * dh;
  const float* kb = k + (size_t)bi * sk * kv_row + (size_t)kh * dh;
  const float* vb = v + (size_t)bi * sk * kv_row + (size_t)kh * dh;

  for (int i = tid; i < BQ * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    qs[i] = r < nrows ? __ldg(qb + (size_t)r * q_row + d) : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) { ms[i] = NEG_INF; ls[i] = 0.f; }

  float acc[MAX_ACC];
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) acc[r] = 0.f;

  // key range any of this block's rows can attend; tiles outside it are skipped
  const int qp_lo = q_offset + row0, qp_hi = q_offset + row0 + nrows - 1;
  int k_hi = sk - 1;
  if (causal) k_hi = min(k_hi, qp_hi);
  int k_lo = 0;
  if (window) k_lo = max(0, qp_lo - window + 1);
  __syncthreads();

  for (int t0 = (k_lo / BKV) * BKV; t0 <= k_hi; t0 += BKV) {
    for (int i = tid; i < BKV * dh; i += THREADS) {
      const int t = i / dh, d = i - t * dh;
      float kv = 0.f, vv = 0.f;
      if (t0 + t < sk) {
        const size_t off = (size_t)(t0 + t) * kv_row + d;
        kv = __ldg(kb + off);
        vv = __ldg(vb + off);
      }
      ks[t * (dh + 1) + d] = kv;
      vs[t * dh + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BKV; i += THREADS) {
      const int r = i / BKV, c = i - r * BKV;
      const int qp = qp_lo + r, kp = t0 + c;
      const bool ok = r < nrows && kp < sk && (!causal || kp <= qp) &&
                      (!window || qp - kp < window);
      float s = NEG_INF;
      if (ok) {
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(qs[r * dh + d], ks[c * (dh + 1) + d], a);
        s = a * scale;
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += NWARPS) {
      const float s = ss[r * BKV + lane];
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = m_new > NEG_INF / 2 ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ss[r * BKV + lane] = p;
      if (lane == 0) {
        const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < MAX_ACC; ++rr) {
      const int idx = tid + rr * THREADS;
      if (idx < BQ * dh) {
        const int r = idx / dh, d = idx - r * dh;
        float a = acc[rr] * as[r];
        for (int c = 0; c < BKV; ++c) a = fmaf(ss[r * BKV + c], vs[c * dh + d], a);
        acc[rr] = a;
      }
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)bi * sq + row0) * q_row + (size_t)hi * dh;
#pragma unroll
  for (int rr = 0; rr < MAX_ACC; ++rr) {
    const int idx = tid + rr * THREADS;
    if (idx < BQ * dh) {
      const int r = idx / dh, d = idx - r * dh;
      if (r < nrows) ob[(size_t)r * q_row + d] = acc[rr] / fmaxf(ls[r], 1e-30f);
    }
  }
}

}  // namespace

extern "C" {

int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* out, int b, int sq, int sk, int h, int hkv,
                           int dh, int causal, int window, int q_offset,
                           float scale, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * dh + (size_t)BKV * (dh + 1) +
                                       (size_t)BKV * dh + (size_t)BQ * BKV + 3 * (size_t)BQ);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, sq, sk, h, hkv, dh, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
