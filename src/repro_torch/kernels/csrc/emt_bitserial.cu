// Technique-C bit-serial noisy crossbar matmul for Hopper (sm_90a), plain
// FP32 FFMA.
//
// Replaces the TPU kernel repro/kernels/emt_bitserial.py::emt_bitserial_pallas:
//   y = sum_{p < bits} 2^p * (sign(xq) * bit_p(|xq|)) @ (w * (1 + a_p * sigma))
// where xq holds integer-valued float DAC levels and a_p(k, n) is the RTN
// offset hashed from the weight element's GLOBAL (row, col), the runtime
// step seed and plane base_plane + p.  The activation bit-planes and the
// noisy weights exist only in shared memory.
//
// What bounds it on the H100: at decode (M = 4 rows) the f32 weights are
// read once (2.48 GB for the 78 MLP projections of a gemma3-1b step) against
// 2*M*K*N*bits FLOPs, so device-memory bytes bound it (0.74 ms); at a chunk
// step (M = 64) FP32 FLOPs do (8.3 ms).  In practice the hash does: every
// weight element is hashed once per plane, ~30 integer operations each.
// Design: each CTA owns a 64-column stripe of BM output rows and a range of
// K: split-K until every SM holds two CTAs, what ~122 registers per thread
// allow (the narrow wd projection, N = 1152, has only 18 stripes; the hash
// chains need resident warps to hide their latency).  A CTA walks its K
// range in 32-deep tiles; the raw weight tile and the raw levels are read
// from device memory once into registers, with each weight element's
// (row, col) hash term.
// Then, for every plane, the tile's noisy weights and the signed plane of
// the levels (0 or +-2^p) go to shared memory and are multiplied into ONE
// f32 accumulator: each product +-2^p * w' is exact, so the result differs
// from the per-plane reference only in summation order.  The split count
// comes from the shared planner (repro_torch/kernels/splitk.py); split-K
// partials are summed in slab order by repro::split_sum (deterministic).
// Rounding of the noise follows the reference: factor = fl(1 + fl(a * sigma)),
// w' = fl(w * factor) (no FMA contraction).
// Not yet done (later work): skipping zero plane entries, tensor cores,
// cp.async/TMA pipelining of the weight tiles.
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kWPer = kBK * kBN / kThreads;      // weight elements per thread

template <int BM>
__global__ void __launch_bounds__(kThreads)
emt_bitserial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, const float* __restrict__ sig_ptr,
                     int M, int N, int K, int k_split, long long sxm,
                     long long sxk, long long swk, long long swn, int bits,
                     uint32_t seed, uint32_t base_plane, repro::NoiseParams np) {
  constexpr int TM = BM / 16;                    // output rows per thread
  constexpr int kXPer = BM * kBK / kThreads;     // levels per thread
  __shared__ __align__(16) float xs[kBK][BM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;                       // columns tx*4 .. tx*4+3
  const int ty = tid / 16;                       // rows ty*TM .. ty*TM+TM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const float sig = *sig_ptr;
  const bool n_contig = (swn == 1);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kBK) {
    float wv[kWPer];
    uint32_t rc[kWPer];
#pragma unroll
    for (int e = 0; e < kWPer; ++e) {
      const int idx = tid + e * kThreads;
      int kk, nn;
      if (n_contig) { kk = idx / kBN; nn = idx % kBN; }
      else          { kk = idx % kBK; nn = idx / kBK; }
      const int k = k0 + kk, n = n0 + nn;
      wv[e] = (k < ke && n < N) ? w[k * swk + n * swn] : 0.f;
      rc[e] = repro::hash_rc((uint32_t)k, (uint32_t)n);
    }
    float xv[kXPer];
#pragma unroll
    for (int e = 0; e < kXPer; ++e) {
      const int idx = tid + e * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int m = m0 + mm, k = k0 + kk;
      xv[e] = (m < M && k < ke) ? x[m * sxm + k * sxk] : 0.f;
    }
    for (int p = 0; p < bits; ++p) {
      const uint32_t pk = repro::hash_pk(seed, base_plane + (uint32_t)p);
      const float scale = (float)(1u << p);      // exact for p < 24
#pragma unroll
      for (int e = 0; e < kWPer; ++e) {
        const int idx = tid + e * kThreads;
        int kk, nn;
        if (n_contig) { kk = idx / kBN; nn = idx % kBN; }
        else          { kk = idx % kBK; nn = idx / kBK; }
        const float a = repro::state_offset(repro::hash_mix(rc[e], pk), np);
        const float f = __fadd_rn(1.0f, __fmul_rn(a, sig));
        ws[kk][nn] = __fmul_rn(wv[e], f);
      }
#pragma unroll
      for (int e = 0; e < kXPer; ++e) {
        const int idx = tid + e * kThreads;
        const int mm = idx / kBK, kk = idx % kBK;
        // bit p of |level|: floor(|x| / 2^p) mod 2 for |x| < 2^32
        const uint32_t bit = (__float2uint_rz(fabsf(xv[e])) >> p) & 1u;
        xs[kk][mm] = bit ? copysignf(scale, xv[e]) : 0.f;
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
  }
  // split z writes its own (M, N) slab of `out`
  float* o = out + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) o[(long long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// `splits` CTAs per output tile along K, each over `k_slab` rows (whole
// 32-deep tiles; planned by repro_torch/kernels/splitk.py); with splits > 1
// their partials go to `part` (splits * M * N floats) and are summed into y
// in slab order (repro::split_sum).
extern "C" int emt_bitserial_f32(const float* x, const float* w, float* y,
                                 float* part, const float* sig, int M, int N,
                                 int K, int splits, int k_slab, long long sxm,
                                 long long sxk, long long swk, long long swn,
                                 int bits, unsigned int seed,
                                 unsigned int base_plane, repro::NoiseParams np,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!repro::split_plan_ok(K, splits, k_slab, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = splits > 1 ? part : y;
  const unsigned gx = (N + kBN - 1) / kBN;
  if (M <= 16) {
    dim3 grid(gx, (M + 15) / 16, splits);
    emt_bitserial_kernel<16><<<grid, kThreads, 0, s>>>(
        x, w, out, sig, M, N, K, k_slab, sxm, sxk, swk, swn, bits, seed,
        base_plane, np);
  } else {
    dim3 grid(gx, (M + 63) / 64, splits);
    emt_bitserial_kernel<64><<<grid, kThreads, 0, s>>>(
        x, w, out, sig, M, N, K, k_slab, sxm, sxk, swk, swn, bits, seed,
        base_plane, np);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)M * N, splits, s));
}
