// One-token GQA decode attention over packed INT4 KV rows, for Hopper
// (sm_90a).
//
//   q (b, h, dh) f32; history K/V as the KV store's packed rows:
//     packed (b, S, F/2) uint8, feature 2i in the low nibble of byte i,
//     scales (b, S, F/group) f32, F = hkv * dh, value = (nibble - 8) * scale
//   pos (b,) int32; optional fresh row k_new/v_new (b, hkv, dh) f32
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
// sizes by latency.  The design is decode_attention.cu's, with the loads
// replaced: one block per (batch row, kv head) serves its g = h/hkv query
// heads from one read of each packed row; rows stream through shared memory
// in tiles of 32 positions only up to pos[r] (rows past it are never read,
// the last tile is masked); each thread loads the packed byte and the scale
// of its element and unpacks the nibble in registers, so packed bytes and
// scales are the only cache traffic and no dequantized cache is ever
// written to memory.  A scale is indexed by the flattened feature
// (feature / group), so a group that spans two heads is read right.  The
// arithmetic after the load is decode_attention.cu's, term for term, so over
// the same history the two kernels give the same result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 32;                 // positions per tile (one per lane)
constexpr int MAX_ACC = 32;              // g * dh <= THREADS * MAX_ACC
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
                             int dh, int group, int has_new, int bf16,
                             float scale) {
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int g = h / hkv;
  const int gd = g * dh;
  const int F2 = hkv * dh / 2, Fg = hkv * dh / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                      // g * dh
  float* ks = qs + gd;                   // TILE * (dh + 1)
  float* vs = ks + TILE * (dh + 1);      // TILE * dh
  float* ps = vs + TILE * dh;            // g * TILE  scores, then probs
  float* ms = ps + g * TILE;             // g  running max
  float* ls = ms + g;                    // g  running denominator
  float* as = ls + g;                    // g  this tile's rescale

  const float* qb = q + ((size_t)bi * h + (size_t)kh * g) * dh;
  for (int i = tid; i < gd; i += THREADS) qs[i] = qb[i];
  for (int i = tid; i < g; i += THREADS) { ms[i] = NEG_INF; ls[i] = 0.f; }

  float acc[MAX_ACC];
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) acc[r] = 0.f;

  // packed history rows 0..n_hist-1, then the fresh row (if any) as the
  // last position of the sequence the tiles walk
  const int p = pos[bi];
  const int n_hist = has_new ? max(0, min(p, S)) : max(0, min(p + 1, S));
  const int n_total = n_hist + (has_new ? 1 : 0);
  const uint8_t* kqb = kq + (size_t)bi * S * F2;
  const uint8_t* vqb = vq + (size_t)bi * S * F2;
  const float* ksb = ksc + (size_t)bi * S * Fg;
  const float* vsb = vsc + (size_t)bi * S * Fg;
  const size_t new_off = ((size_t)bi * hkv + kh) * dh;
  __syncthreads();

  for (int t0 = 0; t0 < n_total; t0 += TILE) {
    const int nt = min(TILE, n_total - t0);
    for (int i = tid; i < TILE * dh; i += THREADS) {
      const int t = i / dh, d = i - t * dh;
      float kv = 0.f, vv = 0.f;
      if (t < nt) {
        const int row = t0 + t;
        if (row < n_hist) {
          const int f = kh * dh + d;               // flattened feature
          const size_t bo = (size_t)row * F2 + (f >> 1);
          const size_t so = (size_t)row * Fg + f / group;
          const int sh = (f & 1) << 2;
          kv = (float)(((__ldg(kqb + bo) >> sh) & 0xF) - 8) * __ldg(ksb + so);
          vv = (float)(((__ldg(vqb + bo) >> sh) & 0xF) - 8) * __ldg(vsb + so);
        } else {
          kv = k_new[new_off + d];
          vv = v_new[new_off + d];
        }
        if (bf16) {
          kv = round_bf16(kv);
          vv = round_bf16(vv);
        }
      }
      ks[t * (dh + 1) + d] = kv;
      vs[t * dh + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < g * TILE; i += THREADS) {
      const int gi = i / TILE, t = i - gi * TILE;
      float s = NEG_INF;
      if (t < nt) {
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(qs[gi * dh + d], ks[t * (dh + 1) + d], a);
        s = a * scale;
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NWARPS) {
      const float s = ps[gi * TILE + lane];
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pr = lane < nt ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(pr);
      ps[gi * TILE + lane] = pr;
      if (lane == 0) {
        const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = m_new;
        as[gi] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_ACC; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < gd) {
        const int gi = idx / dh, d = idx - gi * dh;
        float a = acc[r] * as[gi];
        for (int t = 0; t < nt; ++t) a = fmaf(ps[gi * TILE + t], vs[t * dh + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)bi * h + (size_t)kh * g) * dh;
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < gd) ob[idx] = acc[r] / fmaxf(ls[idx / dh], 1e-30f);
  }
}

}  // namespace

extern "C" {

int decode_attention_int4_launch(const float* q, const uint8_t* kq,
                                 const float* ks, const uint8_t* vq,
                                 const float* vs, const int* pos,
                                 const float* k_new, const float* v_new,
                                 float* out, int b, int S, int h, int hkv,
                                 int dh, int group, int has_new, int bf16,
                                 float scale, void* stream) {
  const int g = h / hkv;
  const size_t smem = sizeof(float) * ((size_t)g * dh + (size_t)TILE * (dh + 1) +
                                       (size_t)TILE * dh + (size_t)g * TILE + 3 * (size_t)g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_int4_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, b);
  decode_attention_int4_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, kq, ks, vq, vs, pos, k_new, v_new, out, S, h, hkv, dh, group, has_new,
      bf16, scale);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
