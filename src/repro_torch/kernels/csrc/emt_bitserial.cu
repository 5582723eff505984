// Technique-C bit-serial noisy crossbar matmul for Hopper (sm_90a), plain
// FP32 FFMA.
//
// Replaces the TPU kernel repro/kernels/emt_bitserial.py::emt_bitserial_pallas:
//   y = sum_{p < bits} 2^p * (sign(xq) * bit_p(|xq|)) @ (w * (1 + a_p * sigma))
// where xq holds integer-valued float DAC levels and a_p(k, n) is the RTN
// offset hashed from the weight element's GLOBAL (row, col), the runtime
// step seed and plane base_plane + p.  The activation bit-planes and the
// noisy weights never reach device memory.  The noisy weight is K3's
// (repro::noisy_rc in common.cuh): factor = fl(1 + fl(a * sigma)),
// w' = fl(w * factor), no FMA contraction, as the reference rounds it.
//
// What bounds it on the H100: every weight element is hashed once per
// plane (hash_mix, 18 32-bit integer operations), in the TPU kernel's body
// too.  At a gemma3-1b decode step (78 MLP projections, M = 4, 7 planes)
// that is ~78 G integer operations, 4.7 ms at 64 INT32 lanes per SM x 132
// SMs x 1.98 GHz, against 0.74 ms for the 2.49 GB of f32 weights: the
// integer issue bounds it, not the bytes or the FP32 FMAs.
// Design:
// * M <= 16 (decode): a GEMV-style kernel templated on M (1-4, 8, 16).  A
//   thread loads 16-byte weight vectors along the unit stride (n-major: 4
//   columns of one row, a warp a row; k-major: 4 rows of one column, 8
//   lanes a column), computes each element's (row, col) hash term once,
//   pre-shifted (repro::hash_mix_pre: the hash's first xorshift is then
//   done once per element and once per plane, not per element and plane;
//   6% of the decode step) and, on a two-state corner, both of its noisy
//   values fl(w * f0), fl(w * f1); then, per plane, the rest of the hash
//   and one integer compare select w' in a register, and w' goes straight
//   into M FMAs.  No weight tile in shared memory, no barrier in the K
//   walk.  The grid is split to ~5 CTAs an SM at M <= 4 (PERF.md): the
//   hash chains need resident warps to hide their latency.  The CTA's slab of x is staged once,
//   as its signed planes (+-2^p or 0), so a thread reads a (k, plane)'s M
//   values with one 16-byte load.  The warps' partial sums (n-major) or the
//   8 lanes of a column (k-major) are reduced once, at the end of the slab,
//   in a fixed order.  Skipping the (k, plane) pairs whose plane is zero in
//   all M rows (exact zeros; ~20% of the pairs at M = 4 on 8-bit DAC
//   levels, a warp-uniform branch on the n-major layout) measured slower,
//   by 0.3 ms a gemma3-1b decode step, than computing them (PERF.md).
// * M > 16 (chunk steps): 64-column x BM-row tiles, 32-deep K tiles; for
//   each plane the tile's noisy weights and the plane of x go to shared
//   memory (two barriers per plane).
// * Both accumulate every plane into ONE f32 sum: each product +-2^p * w'
//   is exact, so the result differs from the per-plane reference only in
//   summation order.  K is split into slabs planned in Python
//   (repro_torch/kernels/emt_bitserial.py::plan); the slabs' partials are
//   summed in slab order by repro::split_sum (deterministic).
// Not yet done (later work): tensor cores, the tiled kernel's per-plane
// barriers.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvMaxM = 16;
constexpr int kGemvBN = 128;              // n-major: 32 lanes x 4 columns
constexpr int kGemvBNk = kWarps * 4;      // k-major: 4 columns per warp (32)
constexpr int kGemvBK = 32;               // GEMV slab granularity (rows)
constexpr int kGemvXBytes = 96 * 1024;    // a slab's staged planes, at most
constexpr int kRedBytes = kWarps * 4 * kGemvBN * 4;   // n-major reduction
constexpr int kBN = 64;                   // tiled kernel
constexpr int kBK = 32;
constexpr int kWPer = kBK * kBN / kThreads;      // weight elements per thread

using repro::f4;
using repro::Factors;
using repro::load_k4;
using repro::load_n4;
using repro::make_factors;
using repro::noisy_rc;

// +-2^p if bit p of |v| is set, else 0 (|v| < 2^32; p < 24, so 2^p is an
// exact float).
__device__ __forceinline__ float plane_value(float v, uint32_t a, int p) {
  return (a >> p) & 1u ? copysignf((float)(1u << p), v) : 0.f;
}

// Stage the signed planes of x[0:Mr, kb:kb + rows] (zeros past ke and Mr):
// n-major xp[(kk * bits + p) * M + m], k-major xp[(p * M + m) * rows + kk].
template <int M, bool kmajor>
__device__ __forceinline__ void stage_planes(
    float* xp, const float* __restrict__ x, int Mr, int kb, int ke, int rows,
    long long sxm, long long sxk, int bits) {
  for (int e = threadIdx.x; e < rows * M; e += kThreads) {
    const int m = kmajor ? e / rows : e % M;
    const int kk = kmajor ? e % rows : e / M;
    const float v = m < Mr && kb + kk < ke
                        ? __ldg(x + m * sxm + (kb + kk) * sxk) : 0.f;
    const uint32_t a = __float2uint_rz(fabsf(v));
    for (int p = 0; p < bits; ++p)
      xp[kmajor ? (p * M + m) * rows + kk : (kk * bits + p) * M + m] =
          plane_value(v, a, p);
  }
  __syncthreads();
}

// The M staged plane values of one (k, plane) into registers.
template <int M>
__device__ __forceinline__ void load_planes(const float* xk, float (&xv)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int m = 0; m < M; m += 4) {
      const float4 t = *reinterpret_cast<const float4*>(xk + m);
      xv[m] = t.x; xv[m + 1] = t.y; xv[m + 2] = t.z; xv[m + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) xv[m] = xk[m];
  }
}

// w' of an element on one plane, from the pre-shifted hash terms
// (repro::pre) of its (row, col) and of the plane: on a two-state corner
// (NS = 2) a select between its two precomputed noisy values, else the
// generic lookup.
template <int NS>
__device__ __forceinline__ float plane_weight(float w, float w0, float w1,
                                              uint32_t rcs, uint32_t pks,
                                              const Factors& F) {
  const uint32_t h = repro::hash_mix_pre(rcs, pks);
  if constexpr (NS == 2)
    return h >= F.t2 ? w1 : w0;
  else
    return __fmul_rn(w, repro::factor<NS>(h, F));
}

// ---------------------------------------------------------------------------
// GEMV, n-major weight (swn == 1).  CTA: 128 columns (lane owns 4) x one K
// slab; warp v takes rows v, v + 8, v + 16, ... of the slab.
template <int M, int NS>
__global__ void __launch_bounds__(kThreads, 2)
bitserial_gemv_n(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, const float* __restrict__ sig_ptr,
                 int Mr, int N, int K, int k_slab, long long sxm,
                 long long sxk, long long swk, int vw, int bits,
                 uint32_t seed, uint32_t base_plane, repro::NoiseParams np) {
  extern __shared__ __align__(16) float smem[];
  float* xp = smem;                                  // [k_slab][bits][M]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGemvBN;
  const int n = n0 + 4 * lane;
  const int kb = blockIdx.y * k_slab;
  const int ke = min(K, kb + k_slab);
  Factors F;
  make_factors(np, *sig_ptr, F);

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  float4 wn = kb + warp < ke ? load_n4(w, (kb + warp) * swk, n, N, vw)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  stage_planes<M, false>(xp, x, Mr, kb, ke, k_slab, sxm, sxk, bits);

  for (int k = kb + warp; k < ke; k += kWarps) {
    const float4 wc = wn;                          // the next row in flight
    if (k + kWarps < ke) wn = load_n4(w, (k + kWarps) * swk, n, N, vw);
    const int kk = k - kb;
    uint32_t rc[4];
    float w0[4], w1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rc[j] = repro::pre(repro::hash_rc((uint32_t)k, (uint32_t)(n + j)));
      w0[j] = __fmul_rn(f4(wc, j), F.f[0]);
      w1[j] = __fmul_rn(f4(wc, j), F.f[1]);
    }
    const float* xk = xp + kk * bits * M;
    for (int p = 0; p < bits; ++p) {
      const uint32_t pk =
          repro::pre(repro::hash_pk(seed, base_plane + (uint32_t)p));
      float xv[M];
      load_planes<M>(xk + p * M, xv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wp = plane_weight<NS>(f4(wc, j), w0[j], w1[j], rc[j], pk,
                                          F);
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m][j] = fmaf(xv[m], wp, acc[m][j]);
      }
    }
  }

  // the 8 warps' partials of each column, summed in warp order (the
  // reduction buffer reuses the staged planes' memory)
  float* red = smem;                                 // [kWarps][4][kGemvBN]
  float* o = out + (long long)blockIdx.y * Mr * N;
#pragma unroll
  for (int mg = 0; mg < M; mg += 4) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (mg + i < M)
        *reinterpret_cast<float4*>(&red[(warp * 4 + i) * kGemvBN + 4 * lane]) =
            make_float4(acc[mg + i][0], acc[mg + i][1], acc[mg + i][2],
                        acc[mg + i][3]);
    __syncthreads();
    for (int e = tid; e < 4 * kGemvBN; e += kThreads) {
      const int i = e / kGemvBN, col = e % kGemvBN, m = mg + i;
      if (m >= M || m >= Mr || n0 + col >= N) continue;
      float s = red[i * kGemvBN + col];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) s += red[(v * 4 + i) * kGemvBN + col];
      o[(long long)m * N + n0 + col] = s;
    }
  }
}

// GEMV, k-major or any-stride weight (swn != 1).  CTA: 32 columns (4 per
// warp, 8 lanes each) x one K slab; a step of a lane is 4 consecutive rows
// of its column in a 32-row band.
template <int M, int NS>
__global__ void __launch_bounds__(kThreads, 2)
bitserial_gemv_k(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, const float* __restrict__ sig_ptr,
                 int Mr, int N, int K, int k_slab, long long sxm,
                 long long sxk, long long swk, long long swn, int vw,
                 int bits, uint32_t seed, uint32_t base_plane,
                 repro::NoiseParams np) {
  extern __shared__ __align__(16) float xp[];        // [bits][M][k_slab]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & 7;                            // row group
  const int n = blockIdx.x * kGemvBNk + warp * 4 + (lane >> 3);
  const int kb = blockIdx.y * k_slab;
  const int ke = min(K, kb + k_slab);
  Factors F;
  make_factors(np, *sig_ptr, F);

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  float4 wn = load_k4(w, kb + 4 * g, ke, n, N, swk, swn, vw);
  stage_planes<M, true>(xp, x, Mr, kb, ke, k_slab, sxm, sxk, bits);

  for (int k0 = kb; k0 < ke; k0 += 32) {
    const float4 wc = wn;
    if (k0 + 32 < ke) wn = load_k4(w, k0 + 32 + 4 * g, ke, n, N, swk, swn, vw);
    const int kk = k0 - kb + 4 * g;                // < k_slab: whole bands
    uint32_t rc[4];
    float w0[4], w1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rc[j] = repro::pre(repro::hash_rc((uint32_t)(k0 + 4 * g + j),
                                        (uint32_t)n));
      w0[j] = __fmul_rn(f4(wc, j), F.f[0]);
      w1[j] = __fmul_rn(f4(wc, j), F.f[1]);
    }
    for (int p = 0; p < bits; ++p) {
      const uint32_t pk =
          repro::pre(repro::hash_pk(seed, base_plane + (uint32_t)p));
      float wp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wp[j] = plane_weight<NS>(f4(wc, j), w0[j], w1[j], rc[j], pk, F);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 t = *reinterpret_cast<const float4*>(
            &xp[(p * M + m) * k_slab + kk]);
        acc[m] = fmaf(t.x, wp[0], acc[m]);
        acc[m] = fmaf(t.y, wp[1], acc[m]);
        acc[m] = fmaf(t.z, wp[2], acc[m]);
        acc[m] = fmaf(t.w, wp[3], acc[m]);
      }
    }
  }

  // the 8 lanes of a column, one fixed butterfly
  float* o = out + (long long)blockIdx.y * Mr * N;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float v = acc[m];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if (g == 0 && n < N && m < Mr) o[(long long)m * N + n] = v;
  }
}

// ---------------------------------------------------------------------------
// Tiled, M > 16: a 64-column stripe of BM output rows and a K slab per CTA,
// 32-deep K tiles.  The raw weight tile and the raw levels are read once
// into registers with each weight element's (row, col) hash term; then, for
// every plane, the tile's noisy weights and the signed plane of the levels
// go to shared memory and are multiplied into the accumulators.
template <int BM, int NS>
__global__ void __launch_bounds__(kThreads)
bitserial_tiled(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, const float* __restrict__ sig_ptr,
                int M, int N, int K, int k_slab, long long sxm, long long sxk,
                long long swk, long long swn, int bits, uint32_t seed,
                uint32_t base_plane, repro::NoiseParams np) {
  constexpr int TM = BM / 16;                    // output rows per thread
  constexpr int kXPer = BM * kBK / kThreads;     // levels per thread
  __shared__ __align__(16) float xs[kBK][BM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;                       // columns tx*4 .. tx*4+3
  const int ty = tid / 16;                       // rows ty*TM .. ty*TM+TM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_slab;
  const int ke = min(K, kb + k_slab);
  const bool n_contig = (swn == 1);
  Factors F;
  make_factors(np, *sig_ptr, F);

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
    uint32_t xa[kXPer];
#pragma unroll
    for (int e = 0; e < kXPer; ++e) {
      const int idx = tid + e * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int m = m0 + mm, k = k0 + kk;
      xv[e] = (m < M && k < ke) ? x[m * sxm + k * sxk] : 0.f;
      xa[e] = __float2uint_rz(fabsf(xv[e]));
    }
    for (int p = 0; p < bits; ++p) {
      const uint32_t pk = repro::hash_pk(seed, base_plane + (uint32_t)p);
#pragma unroll
      for (int e = 0; e < kWPer; ++e) {
        const int idx = tid + e * kThreads;
        int kk, nn;
        if (n_contig) { kk = idx / kBN; nn = idx % kBN; }
        else          { kk = idx % kBK; nn = idx / kBK; }
        ws[kk][nn] = noisy_rc<NS>(wv[e], rc[e], pk, F);
      }
#pragma unroll
      for (int e = 0; e < kXPer; ++e) {
        const int idx = tid + e * kThreads;
        xs[idx % kBK][idx / kBK] = plane_value(xv[e], xa[e], p);
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

struct Args {
  const float* x;
  const float* w;
  float* out;
  const float* sig;
  int M, N, K, k_slab;
  long long sxm, sxk, swk, swn;
  int vw, bits;
  uint32_t seed, base_plane;
  repro::NoiseParams np;
};

// Allow `kern` the GEMV's largest dynamic shared memory, once per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGemvXBytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int MT, int NS>
cudaError_t launch_gemv(const Args& a, bool kc, int splits, cudaStream_t s) {
  const size_t planes = sizeof(float) * MT * a.bits * a.k_slab;
  if (kc) {
    static bool done[64] = {};
    cudaError_t e = allow_smem(bitserial_gemv_k<MT, NS>, done);
    if (e != cudaSuccess) return e;
    dim3 grid((a.N + kGemvBNk - 1) / kGemvBNk, splits);
    bitserial_gemv_k<MT, NS><<<grid, kThreads, planes, s>>>(
        a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
        a.swn, a.vw, a.bits, a.seed, a.base_plane, a.np);
  } else {
    static bool done[64] = {};
    cudaError_t e = allow_smem(bitserial_gemv_n<MT, NS>, done);
    if (e != cudaSuccess) return e;
    const size_t smem = planes;
    dim3 grid((a.N + kGemvBN - 1) / kGemvBN, splits);
    bitserial_gemv_n<MT, NS><<<grid, kThreads, smem > kRedBytes ? smem
                                                                : kRedBytes,
                               s>>>(
        a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
        a.vw, a.bits, a.seed, a.base_plane, a.np);
  }
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch(const Args& a, bool kc, int splits, cudaStream_t s) {
  if (a.M > kGemvMaxM) {
    const unsigned gx = (a.N + kBN - 1) / kBN;
    dim3 grid(gx, (a.M + 63) / 64, splits);
    bitserial_tiled<64, NS><<<grid, kThreads, 0, s>>>(
        a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
        a.swn, a.bits, a.seed, a.base_plane, a.np);
    return cudaGetLastError();
  }
  switch (a.M) {
    case 1: return launch_gemv<1, NS>(a, kc, splits, s);
    case 2: return launch_gemv<2, NS>(a, kc, splits, s);
    case 3: return launch_gemv<3, NS>(a, kc, splits, s);
    case 4: return launch_gemv<4, NS>(a, kc, splits, s);
    default:
      return a.M <= 8 ? launch_gemv<8, NS>(a, kc, splits, s)
                      : launch_gemv<16, NS>(a, kc, splits, s);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// y (M, N) = sum over the planes of x's levels (M, K) @ noisy(w (K, N));
// any strides.  dims = {M, N, K, splits, k_slab, sxm, sxk, swk, swn, bits}
// (one host array, so a ctypes call converts 10 arguments, not 19).
// `splits` CTAs per output tile along K, each over `k_slab` rows: for
// M <= 16 multiples of 32 rows with the slab's planes within 96 KB
// (4 * mt * bits * k_slab bytes, mt the row template),
// for M > 16 whole 32-row tiles, as planned by
// repro_torch/kernels/emt_bitserial.py::plan.  With splits > 1 the partials
// go to `part` (splits * M * N floats) and are summed into y in slab order.
extern "C" int emt_bitserial_f32(const float* x, const float* w, float* y,
                                 float* part, const float* sig,
                                 const long long* dims, unsigned int seed,
                                 unsigned int base_plane,
                                 const repro::NoiseParams* np, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], N = (int)dims[1], K = (int)dims[2];
  const int splits = (int)dims[3], k_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], swk = dims[7], swn = dims[8];
  const int bits = (int)dims[9];
  const bool kc = swn != 1;
  const bool gemv = M <= kGemvMaxM;
  const int mt = M <= 4 ? M : M <= 8 ? 8 : 16;     // the GEMV row template
  if (M < 1 || N < 1 || bits < 1 || bits > 24 ||
      !repro::split_plan_ok(K, splits, k_slab, gemv ? kGemvBK : kBK) ||
      (gemv && 4LL * mt * bits * k_slab > kGemvXBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  int vw = 1;
  if (!kc)
    vw = aligned(w, 16) && swk % 4 == 0  ? 4
         : aligned(w, 8) && swk % 2 == 0 ? 2
                                         : 1;
  else if (swk == 1 && swn % 4 == 0 && aligned(w, 16))
    vw = 4;
  Args a{x, w, splits > 1 ? part : y, sig, M, N, K, k_slab, sxm, sxk, swk,
         swn, vw, bits, seed, base_plane, *np};
  cudaError_t err = np->n_states == 2 ? launch<2>(a, kc, splits, s)
                                      : launch<0>(a, kc, splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)M * N, splits, s));
}
