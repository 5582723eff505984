// Flash-style chunked prefill over the paged KV cache for Hopper (sm_90a),
// plain FP32.
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py::
// paged_prefill_pallas (_prefill_kernel).  The (B, C, H, hd) query chunk is
// regrouped by the wrapper to (B, KV, R = C * G, hd); each row attends the
// K/V resolved through its block table with causality derived in the
// kernel (position p is visible to row r iff p <= qpos[b, r]) and an online
// softmax (NEG_INF lanes exact zeros, m_safe guard, max(l, 1e-30) divide).
// Blocks past qlast[b] = max(qpos[b]) are neither loaded nor computed, as
// the TPU kernel skips its dead chunks.
//
// What bounds it on the H100: the K/V bytes up to qlast and ~R*4 FLOPs per
// K/V element: memory at short contexts, FP32 FMA throughput as R grows.
// Design: R x hd f32 accumulators (64 x 256 at the slice's shapes) do not
// fit one CTA's registers, so the rows are split: one 256-thread CTA per
// (b, kv head, tile of 8 rows); thread d owns output column d of the tile's
// 8 rows, the (bs x hd) K and V tiles of one block at a time sit in shared
// memory (32 KB at bs = 16, hd = 256), warps compute the 8 x bs scores.
// Each CTA re-reads the row's K/V (R / 8 = 8 times per kv head): L2 absorbs
// most of it; tensor cores and a larger row tile are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 8;          // query rows per CTA

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ kpool,
                     const float* __restrict__ vpool,
                     const int* __restrict__ table,
                     const int* __restrict__ qpos,
                     const int* __restrict__ qlast, float* __restrict__ out,
                     int KV, int R, int hd, int bs, int T, float scale,
                     float softcap) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [bs][hd]
  float* Vs = Ks + bs * hd;           // [bs][hd]
  float* qs = Vs + bs * hd;           // [kRT][hd]
  float* ps = qs + kRT * hd;          // [kRT][bs]
  __shared__ int qp[kRT];
  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * kRT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int nr = min(kRT, R - r0);
  const long long row = (long long)KV * hd;
  const long long blk_stride = (long long)bs * row;
  const long long qbase = (((long long)b * KV + h) * R + r0) * hd;

  for (int e = tid; e < kRT * hd; e += kThreads)
    qs[e] = e < nr * hd ? q[qbase + e] : 0.f;
  if (tid < kRT) qp[tid] = tid < nr ? qpos[b * R + r0 + tid] : -1;
  __syncthreads();

  float m[kRT], l[kRT], acc[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) { m[r] = REPRO_NEG_INF; l[r] = 0.f; acc[r] = 0.f; }

  const int last = qlast[b];
  for (int t = 0; t < T && t * bs <= last; ++t) {
    const long long base = (long long)table[b * T + t] * blk_stride + h * hd;
    for (int e = tid; e < bs * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      Ks[e] = kpool[base + j * row + d];
      Vs[e] = vpool[base + j * row + d];
    }
    __syncthreads();
    for (int i = warp; i < kRT * bs; i += nwarps) {
      const int r = i / bs, j = i % bs;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += qs[r * hd + d] * Ks[j * hd + d];
      part = warp_sum(part);
      if (lane == 0) {
        float s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ps[i] = s + ((t * bs + j) <= qp[r] ? 0.f : REPRO_NEG_INF);
      }
    }
    __syncthreads();
    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        float mx = REPRO_NEG_INF;
        for (int j = 0; j < bs; ++j) mx = fmaxf(mx, ps[r * bs + j]);
        const float m_new = fmaxf(m[r], mx);
        const float m_safe = m_new > REPRO_NEG_INF / 2 ? m_new : 0.f;
        const float corr = expf(m[r] - m_safe);
        float sum = 0.f, a = 0.f;
        for (int j = 0; j < bs; ++j) {
          const float s = ps[r * bs + j];
          const float p = s > REPRO_NEG_INF / 2 ? expf(s - m_safe) : 0.f;
          sum += p;
          a += p * Vs[j * hd + tid];
        }
        l[r] = l[r] * corr + sum;
        acc[r] = acc[r] * corr + a;
        m[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (tid < hd) {
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r < nr) out[qbase + (long long)r * hd + tid] = acc[r] / fmaxf(l[r], 1e-30f);
  }
}

}  // namespace

extern "C" int paged_prefill_f32(const float* q, const float* kpool,
                                 const float* vpool, const int* table,
                                 const int* qpos, const int* qlast, float* out,
                                 int B, int KV, int R, int hd, int bs, int T,
                                 float scale, float softcap, void* stream) {
  if (hd > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * bs * hd + kRT * hd + kRT * bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, KV, (R + kRT - 1) / kRT);
  paged_prefill_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, table, qpos, qlast, out, KV, R, hd, bs, T, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}
