// Backward of the technique-A noisy crossbar matmul (K3) for Hopper
// (sm_90a), plain FP32.
//
// The TPU reference has no backward kernel: JAX differentiates
// repro/core/noise.py::fluctuate + `@` in XLA, so its VJP of
//   y = x @ (w * f),  f = fl(1 + fl(a(k, n) * sigma))
// reads the materialized noisy weight.  The port's forward kernel
// (emt_matmul.cu) never materializes the noise, so its backward hashes it
// again, from the same (seed, plane, k, n), in two kernels:
//
// * K3-dx: dx (M, K) = g (M, N) @ (w * f)^T.  K3's tiled template
//   (emt_tiled.cuh) over the weight's transpose read in place, the
//   reduction running over N, each element hashed at w's logical (k, n)
//   (passing w^T to the forward kernel would hash (n, k): other noise).
//   What bounds it: 2*M*K*N FP32 FLOPs (at gemma3-1b's training M = 1024
//   far above the bytes), and the hash, once per element per 64-row tile.
//   Split along N by the same planner as the forward (kernels/splitk.py),
//   partials summed in slab order.
// * K3-dw: given gw = x^T g (K, N) (JAX computes it in XLA, outside any
//   Pallas kernel; the port takes torch.matmul), one pass writes
//   dw = fl(gw * f) over gw in place and the partials of
//   dsigma = sum fl(fl(gw * w) * a), the rounding XLA's VJP of
//   w * (1 + a * sigma) gives.  Bytes bound it (read gw and w, write dw).
//   A fixed grid of kDwBlocks CTAs walks 32 x 32 tiles, stages each w tile
//   through shared memory so both layouts read along their unit stride
//   (the tied unembed's weight is the table's transpose), sums its
//   partial in a fixed order, and a second one-CTA kernel adds the
//   partials in index order (in double): two calls give the same bits on
//   any card, since the grid does not depend on the SM count.
// Correct first: neither kernel is tuned (tensor cores, fusing the pass
// into a product epilogue and the dx kernel's hash reuse are later work).
#include <cstdint>

#include "common.cuh"
#include "emt_tiled.cuh"

namespace {

constexpr int kDwTile = 32;
constexpr int kDwBlocks = 1024;
constexpr int kDwThreads = 256;

using repro::Factors;
using repro::kMaxStates;

// The factor and the offset of the RTN state that hash bits `bits` select
// (the state lookup of common.cuh's factor(), returning the offset too).
template <int NS>
__device__ __forceinline__ void factor_offset(uint32_t bits, const Factors& F,
                                              const float (&off)[kMaxStates],
                                              float& f, float& a) {
  if constexpr (NS == 2) {
    const bool hi = bits >= F.t2;
    f = hi ? F.f[1] : F.f[0];
    a = hi ? off[1] : off[0];
  } else {
    const float u = __fmul_rn(__uint2float_rn(bits), 0x1p-32f);
    f = F.f[0];
    a = off[0];
#pragma unroll
    for (int i = 0; i < kMaxStates - 1; ++i)
      if (u >= F.thr[i]) {
        f = F.f[i + 1];
        a = off[i + 1];
      }
  }
}

template <int NS>
__global__ void __launch_bounds__(kDwThreads)
emt_dw_pass(float* __restrict__ gw, const float* __restrict__ w,
            const float* __restrict__ sig_ptr, float* __restrict__ part, int K,
            int N, long long swk, long long swn, int kmaj, uint32_t seed,
            uint32_t plane, repro::NoiseParams np) {
  __shared__ float ws[kDwTile][kDwTile + 1];
  __shared__ float red[kDwThreads / 32];
  Factors F;
  repro::make_factors(np, *sig_ptr, F);
  float off[kMaxStates];
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i) off[i] = np.off[i];
  const uint32_t pk = repro::hash_pk(seed, plane);
  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  const int tn = (N + kDwTile - 1) / kDwTile;
  const int tiles = tn * ((K + kDwTile - 1) / kDwTile);
  float acc = 0.f;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int k0 = (t / tn) * kDwTile, n0 = (t % tn) * kDwTile;
    // stage w's tile, consecutive lanes along w's unit stride
#pragma unroll
    for (int i = 0; i < kDwTile / 8; ++i) {
      const int fast = lane, slow = row + 8 * i;
      const int kk = kmaj ? fast : slow, nn = kmaj ? slow : fast;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = k < K && n < N ? __ldg(w + k * swk + n * swn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kDwTile / 8; ++i) {
      const int kk = row + 8 * i, k = k0 + kk, n = n0 + lane;
      if (k < K && n < N) {
        float* p = gw + (long long)k * N + n;
        const float g = *p;
        float f, a;
        factor_offset<NS>(repro::hash_mix(repro::hash_rc(k, n), pk), F, off,
                          f, a);
        *p = __fmul_rn(g, f);
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g, ws[kk][lane]), a));
      }
    }
    __syncthreads();
  }
  // the CTA's partial: a fixed butterfly in each warp, then warp order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) red[row] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = red[0];
#pragma unroll
    for (int i = 1; i < kDwThreads / 32; ++i) s += red[i];
    part[blockIdx.x] = s;
  }
}

// out[0] = the sum of part[0 .. n), in a fixed order (double).
__global__ void __launch_bounds__(kDwThreads)
partial_sum(const float* __restrict__ part, int n, float* __restrict__ out) {
  __shared__ double s[kDwThreads];
  const int tid = threadIdx.x;
  double v = 0.0;
  for (int i = tid; i < n; i += kDwThreads) v += part[i];
  s[tid] = v;
  __syncthreads();
  for (int o = kDwThreads / 2; o > 0; o >>= 1) {
    if (tid < o) s[tid] += s[tid + o];
    __syncthreads();
  }
  if (tid == 0) out[0] = (float)s[0];
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dx (M, K) = g (M, N) @ noisy(w (K, N))^T; g and w of any strides.
// dims = {M, K, N, splits, n_slab, sgm, sgn, swk, swn}: `splits` CTAs per
// output tile along N, each over `n_slab` columns of g (32-column tiles),
// as planned by repro_torch/kernels/emt_matmul.py::plan_dx; with
// splits > 1 the partials go to `part` (splits * M * K floats) and are
// summed into dx in slab order.
extern "C" int emt_matmul_dx_f32(const float* g, const float* w, float* dx,
                                 float* part, const float* sig,
                                 const long long* dims, unsigned int seed,
                                 unsigned int plane,
                                 const repro::NoiseParams* np, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], K = (int)dims[1], N = (int)dims[2];
  const int splits = (int)dims[3], n_slab = (int)dims[4];
  const long long sgm = dims[5], sgn = dims[6], swk = dims[7], swn = dims[8];
  if (M < 1 || K < 1 || !repro::split_plan_ok(N, splits, n_slab, repro::kTBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // v = w^T (N, K): strides (swn, swk); kc: v is not column-contiguous
  const long long svr = swn, svc = swk;
  const bool kc = svc != 1;
  int vw = 1;
  if (!kc)
    vw = aligned(w, 16) && svr % 4 == 0  ? 4
         : aligned(w, 8) && svr % 2 == 0 ? 2
                                         : 1;
  else if (svr == 1 && svc % 4 == 0 && aligned(w, 16))
    vw = 4;
  const int gvec = sgn == 1 && sgm % 4 == 0 && aligned(g, 16);
  float* out = splits > 1 ? part : dx;
  if (np->n_states == 2)
    repro::launch_tiled<2, true>(g, w, out, sig, M, K, N, n_slab, sgm, sgn,
                                 svr, svc, vw, gvec, seed, plane, *np, kc,
                                 splits, s);
  else
    repro::launch_tiled<0, true>(g, w, out, sig, M, K, N, n_slab, sgm, sgn,
                                 svr, svc, vw, gvec, seed, plane, *np, kc,
                                 splits, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, dx, (long long)M * K, splits, s));
}

// In place over gw (K, N) contiguous (= x^T g): gw <- gw * f(k, n); dsig[0]
// <- sum gw * w * a(k, n) over the elements.  w (K, N) of any strides.
// dims = {K, N, swk, swn}; `part` holds kDwBlocks floats (the CTAs'
// partials).
extern "C" int emt_matmul_dw_f32(float* gw, const float* w, const float* sig,
                                 float* part, float* dsig,
                                 const long long* dims, unsigned int seed,
                                 unsigned int plane,
                                 const repro::NoiseParams* np, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (int)dims[0], N = (int)dims[1];
  const long long swk = dims[2], swn = dims[3];
  if (K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int kmaj = swk == 1 && swn != 1;
  const long long tiles = (long long)((K + kDwTile - 1) / kDwTile) *
                          ((N + kDwTile - 1) / kDwTile);
  const int blocks = (int)(tiles < kDwBlocks ? tiles : kDwBlocks);
  if (np->n_states == 2)
    emt_dw_pass<2><<<blocks, kDwThreads, 0, s>>>(gw, w, sig, part, K, N, swk,
                                                 swn, kmaj, seed, plane, *np);
  else
    emt_dw_pass<0><<<blocks, kDwThreads, 0, s>>>(gw, w, sig, part, K, N, swk,
                                                 swn, kmaj, seed, plane, *np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partial_sum<<<1, kDwThreads, 0, s>>>(part, blocks, dsig);
  return static_cast<int>(cudaGetLastError());
}
