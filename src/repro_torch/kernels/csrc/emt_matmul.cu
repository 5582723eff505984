// Technique-A noisy crossbar matmul for Hopper (sm_90a), plain FP32 FFMA.
//
// Replaces the TPU kernel repro/kernels/emt_matmul.py::emt_matmul_pallas:
//   y = x @ (w * (1 + a(k, n) * sigma))
// with the RTN offset a(k, n) hashed from the element's GLOBAL (row, col),
// the runtime step seed and the layer plane, inside the tile: no noise
// tensor ever exists in device memory.
//
// What bounds it on the H100: at decode (M = batch rows) every call streams
// its whole f32 weight once (4.0 GB per gemma3-1b step) against 2*M*K*N
// FLOPs, far below the FP32 ridge, so device-memory bytes bound it; the
// per-element hash (~20 integer ops) is the second cost.  Design: each CTA
// owns a 64-column stripe of the output and walks K in 32-deep tiles; the
// (32 x 64) weight tile is read once from device memory (coalesced along
// whichever weight stride is 1, so the tied unembed reads the embedding
// table's transpose in place), gets its noise factor applied on the way into
// shared memory, and is reused by all BM rows of the CTA (BM = 16 for decode
// batches, 64 for chunk steps, so one CTA row-tile covers a whole chunk step
// and every weight element is hashed once).  Rounding follows the reference:
// factor = fl(1 + fl(a * sigma)), w' = fl(w * factor) (no FMA contraction).
// Not yet done (later work): split-K for the narrow N=256/1024 projections
// (only 4-18 CTAs), TMA/cp.async pipelining, tensor cores.
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

template <int BM>
__global__ void __launch_bounds__(kThreads)
emt_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, const float* __restrict__ sig_ptr,
                  int M, int N, int K, long long sxm, long long sxk,
                  long long swk, long long swn, uint32_t seed, uint32_t plane,
                  repro::NoiseParams np) {
  constexpr int TM = BM / 16;                    // output rows per thread
  __shared__ __align__(16) float xs[kBK][BM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;                       // columns tx*4 .. tx*4+3
  const int ty = tid / 16;                       // rows ty*TM .. ty*TM+TM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const float sig = *sig_ptr;
  const bool n_contig = (swn == 1);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      int kk, nn;
      if (n_contig) { kk = e / kBN; nn = e % kBN; }
      else          { kk = e % kBK; nn = e / kBK; }
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < N) {
        const float wv = w[k * swk + n * swn];
        const float a = repro::state_offset(
            repro::hash_counters(seed, (uint32_t)k, (uint32_t)n, plane), np);
        const float f = __fadd_rn(1.0f, __fmul_rn(a, sig));
        v = __fmul_rn(wv, f);
      }
      ws[kk][nn] = v;
    }
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e % kBK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < K) ? x[m * sxm + k * sxk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(long long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int emt_matmul_f32(const float* x, const float* w, float* y,
                              const float* sig, int M, int N, int K,
                              long long sxm, long long sxk, long long swk,
                              long long swn, unsigned int seed,
                              unsigned int plane, repro::NoiseParams np,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gx = (N + kBN - 1) / kBN;
  if (M <= 16) {
    dim3 grid(gx, (M + 15) / 16);
    emt_matmul_kernel<16><<<grid, kThreads, 0, s>>>(
        x, w, y, sig, M, N, K, sxm, sxk, swk, swn, seed, plane, np);
  } else {
    dim3 grid(gx, (M + 63) / 64);
    emt_matmul_kernel<64><<<grid, kThreads, 0, s>>>(
        x, w, y, sig, M, N, K, sxm, sxk, swk, swn, seed, plane, np);
  }
  return static_cast<int>(cudaGetLastError());
}
