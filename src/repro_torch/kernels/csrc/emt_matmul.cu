// Technique-A noisy crossbar matmul for Hopper (sm_90a), plain FP32 FFMA.
//
// Replaces the TPU kernel repro/kernels/emt_matmul.py::emt_matmul_pallas:
//   y = x @ (w * (1 + a(k, n) * sigma))
// with the RTN offset a(k, n) hashed from the element's GLOBAL (row, col),
// the runtime step seed and the layer plane, inside the kernel: no noise
// tensor ever exists in device memory.  Rounding follows the reference:
// factor = fl(1 + fl(a * sigma)), w' = fl(w * factor) (no FMA contraction);
// the factor of each RTN state is computed once per thread.
//
// What bounds it on the H100: every call streams its whole f32 weight once
// (4.0 GB per gemma3-1b decode step, 1.2 ms at the H100 SXM's published
// 3.35 TB/s) against 2*M*K*N FLOPs; at decode (M = 4) that is far below the
// FP32 ridge, so bytes bound it, and the per-element hash (~25 integer
// operations) is the second cost.  At a chunk step (M = 64) the FP32 FLOPs
// (1.9 ms a step at the published 67 TFLOP/s) are within 1.6x of the
// bytes, so tensor cores would buy less than that; they are not used:
// 3xTF32 would not return w' exactly, and x = I must give fluctuate(w) bit
// for bit.
//
// Design:
// * M <= 16 (decode): a GEMV-style kernel templated on M (1-4, 8, 16) with
//   no shared-memory weight tile.  Each thread loads 16-byte vectors along
//   whichever weight stride is 1 (n-major: 4 columns of one row; the tied
//   unembed's transposed table, k-major: 4 rows of one column, read in
//   place), hashes them in registers and FMAs them into M accumulators per
//   column.  The x rows of the CTA's K slab are staged in shared memory
//   once (a broadcast), so the K walk has no barrier, and each thread
//   keeps the next step's vectors (4 at M <= 8) in flight while it hashes
//   and FMAs this step's.  Threads that share columns reduce once, at the
//   end of the slab (shared memory in warp order for n-major, a shuffle
//   butterfly for k-major).
// * M > 16 (chunk and prefill steps): a 64 x 64 tiled kernel, 32-deep K
//   tiles, float4 loads in both layouts.  The raw weight and x tiles of the
//   next K tile are loaded into registers while this tile's FMAs run, then
//   hashed into the other of two shared-memory buffers (one barrier a
//   tile); every weight element is hashed once per 64-row tile.
// * Split-K for both, planned in Python from the SM count
//   (repro_torch/kernels/splitk.py): slabs of whole chunks/tiles write
//   partials to a workspace, and repro::split_sum adds them in slab order
//   (deterministic, no atomics).
// Not yet done (later work): at decode the host's two launches and the
// output allocation, not the device, set the time of a call (PERF.md); a
// split sum inside a thread-block cluster, as the chunked prefill merges
// its splits, would save the second launch and the workspace.  TMA
// pipelining; the eager weight fake-quantization around the call.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvMaxM = 16;
constexpr int kGemvBN = 128;              // n-major: 32 lanes x 4 columns
constexpr int kGemvBNk = kWarps * 4;      // k-major: 4 columns per warp (32)
constexpr int kGemvBK = 32;               // n-major slab granularity (rows)
constexpr int kGemvBKk = 128;             // k-major slab granularity (rows)
constexpr int kGemvXBytes = 24 * 1024;    // x rows of one slab, at most
constexpr int kBM = 64, kBN = 64, kBK = 32;   // tiled kernel

// The noisy weight and the weight loads are shared with the bit-serial
// kernel (common.cuh).
using repro::f4;
using repro::Factors;
using repro::load_k4;
using repro::load_n4;
using repro::make_factors;
using repro::noisy;

// ---------------------------------------------------------------------------
// GEMV (M <= 16).  The CTA's x rows for its whole K slab are staged once in
// shared memory (the planner keeps k_slab * M * 4 bytes <= kGemvXBytes), so
// the K walk has no barrier: each thread keeps gemv_u<M>() 16-byte weight
// vectors of the next step in flight while it hashes and FMAs this step's.

template <int M>
__host__ __device__ constexpr int gemv_u() {
  return M <= 8 ? 4 : 2;
}

// Stage x[0:Mr, kb:kb + rows] into xs ([row][m], or [m][row] for kmajor),
// zeros past ke.
template <int M, bool kmajor>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x,
                                        int Mr, int kb, int ke, int rows,
                                        long long sxm, long long sxk) {
  for (int e = threadIdx.x; e < rows * M; e += kThreads) {
    const int m = kmajor ? e / rows : e % M;
    const int kk = kmajor ? e % rows : e / M;
    xs[e] = m < Mr && kb + kk < ke ? __ldg(x + m * sxm + (kb + kk) * sxk)
                                   : 0.f;
  }
  __syncthreads();
}

// n-major weight (swn == 1).  CTA: 128 columns (lane owns 4) x one K slab;
// warp w takes rows w, w + 8, w + 16, ... of the slab.
template <int M, int NS>
__global__ void __launch_bounds__(kThreads, 2)
emt_matmul_gemv_n(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, const float* __restrict__ sig_ptr,
                  int Mr, int N, int K, int k_slab, long long sxm,
                  long long sxk, long long swk, int vw, uint32_t seed,
                  uint32_t plane, repro::NoiseParams np) {
  constexpr int U = gemv_u<M>();
  constexpr int STEP = kWarps * U;                 // slab rows per step
  extern __shared__ __align__(16) float xs[];       // [k_slab][M]
  __shared__ __align__(16) float red[kWarps][4][kGemvBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGemvBN;
  const int n = n0 + 4 * lane;
  const int kb = blockIdx.y * k_slab;
  const int ke = min(K, kb + k_slab);
  const uint32_t pk = repro::hash_pk(seed, plane);
  Factors F;
  make_factors(np, *sig_ptr, F);

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  float4 wc[U], wn[U];
  auto load_w = [&](int k0, float4 (&v)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + warp + kWarps * u;
      v[u] = k < ke ? load_n4(w, k * swk, n, N, vw)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_w(kb, wc);                                  // in flight while x stages
  stage_x<M, false>(xs, x, Mr, kb, ke, ke - kb, sxm, sxk);

  for (int k0 = kb; k0 < ke; k0 += STEP) {
    if (k0 + STEP < ke) load_w(k0 + STEP, wn);     // next step in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 - kb + warp + kWarps * u;
      if (kk >= ke - kb) break;                    // (uniform in the warp)
      float wp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wp[j] = noisy<NS>(f4(wc[u], j), (uint32_t)(kb + kk),
                          (uint32_t)(n + j), pk, F);
      float xv[M];
      if constexpr (M % 4 == 0) {
#pragma unroll
        for (int m = 0; m < M; m += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&xs[kk * M + m]);
          xv[m] = t.x; xv[m + 1] = t.y; xv[m + 2] = t.z; xv[m + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < M; ++m) xv[m] = xs[kk * M + m];
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], wp[j], acc[m][j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) wc[u] = wn[u];
  }

  // the 8 warps' partials of each column, summed in warp order
  float* o = out + (long long)blockIdx.y * Mr * N;
#pragma unroll
  for (int mg = 0; mg < M; mg += 4) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (mg + i < M)
        *reinterpret_cast<float4*>(&red[warp][i][4 * lane]) = make_float4(
            acc[mg + i][0], acc[mg + i][1], acc[mg + i][2], acc[mg + i][3]);
    __syncthreads();
    for (int e = tid; e < 4 * kGemvBN; e += kThreads) {
      const int i = e / kGemvBN, col = e % kGemvBN, m = mg + i;
      if (m >= M || m >= Mr || n0 + col >= N) continue;
      float s = red[0][i][col];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) s += red[v][i][col];
      o[(long long)m * N + n0 + col] = s;
    }
  }
}

// k-major or any-stride weight (swn != 1; the tied unembed reads the
// table's transpose in place).  CTA: 32 columns (4 per warp, 8 lanes each)
// x one K slab; a step of a lane is 4 consecutive rows of its column in
// each of U 32-row bands.
template <int M, int NS>
__global__ void __launch_bounds__(kThreads, 2)
emt_matmul_gemv_k(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, const float* __restrict__ sig_ptr,
                  int Mr, int N, int K, int k_slab, long long sxm,
                  long long sxk, long long swk, long long swn, int vw,
                  uint32_t seed, uint32_t plane, repro::NoiseParams np) {
  constexpr int U = gemv_u<M>();
  constexpr int STEP = 32 * U;
  extern __shared__ __align__(16) float xs[];       // [M][k_slab]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & 7;                           // row group
  const int n = blockIdx.x * kGemvBNk + warp * 4 + (lane >> 3);
  const int kb = blockIdx.y * k_slab;
  const int ke = min(K, kb + k_slab);
  const uint32_t pk = repro::hash_pk(seed, plane);
  Factors F;
  make_factors(np, *sig_ptr, F);

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  float4 wc[U], wn[U];
  auto load_w = [&](int k0, float4 (&v)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = load_k4(w, k0 + 32 * u + 4 * g, ke, n, N, swk, swn, vw);
  };
  load_w(kb, wc);
  stage_x<M, true>(xs, x, Mr, kb, ke, k_slab, sxm, sxk);   // 0 past ke

  for (int k0 = kb; k0 < ke; k0 += STEP) {
    if (k0 + STEP < ke) load_w(k0 + STEP, wn);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 - kb + 32 * u + 4 * g;
      if (kk >= k_slab) continue;                  // past the staged slab
      float wp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wp[j] = noisy<NS>(f4(wc[u], j), (uint32_t)(kb + kk + j), (uint32_t)n,
                          pk, F);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 t =
            *reinterpret_cast<const float4*>(&xs[m * k_slab + kk]);
        acc[m] = fmaf(t.x, wp[0], acc[m]);
        acc[m] = fmaf(t.y, wp[1], acc[m]);
        acc[m] = fmaf(t.z, wp[2], acc[m]);
        acc[m] = fmaf(t.w, wp[3], acc[m]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) wc[u] = wn[u];
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
// Tiled, M > 16: 64 x 64 output tile per CTA, 32-deep K tiles, register
// prefetch of the next tile + two shared-memory buffers.  KC: the weight
// is not n-major (the tied unembed).
template <bool KC, int NS>
__global__ void __launch_bounds__(kThreads, 2)
emt_matmul_tiled(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, const float* __restrict__ sig_ptr,
                 int M, int N, int K, int k_slab, long long sxm, long long sxk,
                 long long swk, long long swn, int vw, int xvec,
                 uint32_t seed, uint32_t plane, repro::NoiseParams np) {
  __shared__ __align__(16) float ws[2][kBK][kBN];
  __shared__ __align__(16) float xs[2][kBK][kBM + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;                  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;                  // rows ty*4 .. ty*4+3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_slab;
  const int ke = min(K, kb + k_slab);
  const uint32_t pk = repro::hash_pk(seed, plane);
  Factors F;
  make_factors(np, *sig_ptr, F);
  // loader coordinates: n-major weights by (row, 4-column group); k-major
  // weights and x by (column or row, 8-deep K run)
  const int ln = tid & 63, lq = tid >> 6;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 wr[2], xr[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (KC) {
        wr[r] = load_k4(w, k0 + 8 * lq + 4 * r, ke, n0 + ln, N, swk, swn, vw);
      } else {
        const int e = tid + kThreads * r, k = k0 + (e >> 4);
        wr[r] = k < ke ? load_n4(w, k * swk, n0 + 4 * (e & 15), N, vw)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const int m = m0 + ln, k = k0 + 8 * lq + 4 * r;
      if (m >= M) {
        xr[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (xvec && k + 3 < ke) {
        xr[r] = __ldg(reinterpret_cast<const float4*>(x + m * sxm + k));
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = k + j < ke ? __ldg(x + m * sxm + (k + j) * sxk) : 0.f;
        xr[r] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_tile = [&](int buf, int k0) {               // the hash
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (KC) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = 8 * lq + 4 * r + j;
          ws[buf][kk][ln] = noisy<NS>(f4(wr[r], j), (uint32_t)(k0 + kk),
                                      (uint32_t)(n0 + ln), pk, F);
        }
      } else {
        const int e = tid + kThreads * r, kk = e >> 4, c = 4 * (e & 15);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = noisy<NS>(f4(wr[r], j), (uint32_t)(k0 + kk),
                           (uint32_t)(n0 + c + j), pk, F);
        *reinterpret_cast<float4*>(&ws[buf][kk][c]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[buf][8 * lq + 4 * r + j][ln] = f4(xr[r], j);
    }
  };

  const int nt = (ke - kb + kBK - 1) / kBK;
  load_tile(kb);
  store_tile(0, kb);
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) load_tile(kb + (t + 1) * kBK);     // in flight
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = f4(a, i);
        acc[i][0] = fmaf(ai, b.x, acc[i][0]);
        acc[i][1] = fmaf(ai, b.y, acc[i][1]);
        acc[i][2] = fmaf(ai, b.z, acc[i][2]);
        acc[i][3] = fmaf(ai, b.w, acc[i][3]);
      }
    }
    if (t + 1 < nt) store_tile(buf ^ 1, kb + (t + 1) * kBK);
    __syncthreads();
  }

  float* o = out + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
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
  int vw;
  uint32_t seed, plane;
  repro::NoiseParams np;
};

template <int MT, int NS>
void launch_gemv(const Args& a, bool kc, int splits, cudaStream_t s) {
  const size_t smem = sizeof(float) * MT * a.k_slab;
  if (kc) {
    dim3 grid((a.N + kGemvBNk - 1) / kGemvBNk, splits);
    emt_matmul_gemv_k<MT, NS><<<grid, kThreads, smem, s>>>(
        a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
        a.swn, a.vw, a.seed, a.plane, a.np);
  } else {
    dim3 grid((a.N + kGemvBN - 1) / kGemvBN, splits);
    emt_matmul_gemv_n<MT, NS><<<grid, kThreads, smem, s>>>(
        a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
        a.vw, a.seed, a.plane, a.np);
  }
}

template <int NS>
void launch(const Args& a, bool kc, int splits, int xvec, cudaStream_t s) {
  if (a.M > kGemvMaxM) {
    dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, splits);
    if (kc)
      emt_matmul_tiled<true, NS><<<grid, kThreads, 0, s>>>(
          a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk,
          a.swk, a.swn, a.vw, xvec, a.seed, a.plane, a.np);
    else
      emt_matmul_tiled<false, NS><<<grid, kThreads, 0, s>>>(
          a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk,
          a.swk, a.swn, a.vw, xvec, a.seed, a.plane, a.np);
    return;
  }
  switch (a.M) {
    case 1: launch_gemv<1, NS>(a, kc, splits, s); break;
    case 2: launch_gemv<2, NS>(a, kc, splits, s); break;
    case 3: launch_gemv<3, NS>(a, kc, splits, s); break;
    case 4: launch_gemv<4, NS>(a, kc, splits, s); break;
    default:
      if (a.M <= 8) launch_gemv<8, NS>(a, kc, splits, s);
      else launch_gemv<16, NS>(a, kc, splits, s);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// y (M, N) = x (M, K) @ noisy(w (K, N)); any strides.
// dims = {M, N, K, splits, k_slab, sxm, sxk, swk, swn} (one host array, so
// a ctypes call converts 10 arguments, not 18).  `splits` CTAs per output
// tile along K, each over `k_slab` rows: multiples of 32 rows (GEMV,
// M <= 16, n-major weight; x rows of a slab <= 24 KB), of 128 rows (GEMV,
// other weights) or 32-row tiles (M > 16), as planned by
// repro_torch/kernels/emt_matmul.py::plan.
// With splits > 1 the partials go to `part` (splits * M * N floats) and are
// summed into y in slab order.
extern "C" int emt_matmul_f32(const float* x, const float* w, float* y,
                              float* part, const float* sig,
                              const long long* dims, unsigned int seed,
                              unsigned int plane,
                              const repro::NoiseParams* np, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], N = (int)dims[1], K = (int)dims[2];
  const int splits = (int)dims[3], k_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], swk = dims[7], swn = dims[8];
  const bool kc = swn != 1;
  const bool gemv = M <= kGemvMaxM;
  const int bk = !gemv ? kBK : kc ? kGemvBKk : kGemvBK;
  const int mt = M <= 4 ? M : M <= 8 ? 8 : 16;     // the GEMV row template
  if (M < 1 || N < 1 || !repro::split_plan_ok(K, splits, k_slab, bk) ||
      (gemv && (long long)sizeof(float) * mt * k_slab > kGemvXBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  int vw = 1;
  if (!kc)
    vw = aligned(w, 16) && swk % 4 == 0  ? 4
         : aligned(w, 8) && swk % 2 == 0 ? 2
                                         : 1;
  else if (swk == 1 && swn % 4 == 0 && aligned(w, 16))
    vw = 4;
  const int xvec = sxk == 1 && sxm % 4 == 0 && aligned(x, 16);
  Args a{x, w, splits > 1 ? part : y, sig, M, N, K, k_slab, sxm, sxk, swk,
         swn, vw, seed, plane, *np};
  if (np->n_states == 2)
    launch<2>(a, kc, splits, xvec, s);
  else
    launch<0>(a, kc, splits, xvec, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)M * N, splits, s));
}
