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
// * M > 16 (chunk and prefill steps): a 64 x 64 tiled kernel
//   (emt_tiled.cuh), 32-deep K tiles,
//   float4 loads in both layouts.  The raw weight and x tiles of the
//   next K tile are loaded into registers while this tile's FMAs run, then
//   hashed into the other of two shared-memory buffers (one barrier a
//   tile); every weight element is hashed once per 64-row tile.
// * Split-K for both, planned in Python from the SM count
//   (repro_torch/kernels/splitk.py): slabs of whole chunks/tiles write
//   partials to a workspace, and repro::split_sum adds them in slab order
//   (deterministic, no atomics).
// * int8 weights (store_int8 serving, emt_matmul_i8): the weight loader is
//   a template parameter (I8) of all three kernels.  The int8 loader reads
//   16 levels in one 16-byte load, dequantizes them in registers as
//   fl(float(q) * scale[n]) (one rounding, the reference's
//   w_int8.astype(f32) * w_scale), noises them with the same rounding and
//   stages the float32 noisy weight in shared memory, so the FMA loops
//   are the float path's.  The weight's bytes fall 4x; the hash's work
//   per element does not (at a gemma3-1b decode step the ALU pipe, not the
//   bytes, then bounds the step: PERF.md).
// Not yet done (later work): at decode the host's two launches and the
// output allocation, not the device, set the time of a call (PERF.md); a
// split sum inside a thread-block cluster, as the chunked prefill merges
// its splits, would save the second launch and the workspace.  TMA
// pipelining; the eager weight fake-quantization around the call.
#include <cstdint>

#include "common.cuh"
#include "emt_tiled.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvMaxM = 16;
constexpr int kGemvBN = 128;              // n-major: 32 lanes x 4 columns
constexpr int kGemvBNk = kWarps * 4;      // k-major: 4 columns per warp (32)
constexpr int kGemvBK = 32;               // n-major slab granularity (rows)
constexpr int kGemvBKk = 128;             // k-major slab granularity (rows)
constexpr int kGemvXBytes = 24 * 1024;    // x rows of one slab, at most
constexpr int kI8Step = 32;               // n-major int8 GEMV: rows a step

// The noisy weight and the weight loads are shared with the bit-serial
// kernel (common.cuh).
using repro::dequant;
using repro::f4;
using repro::Factors;
using repro::load_k4;
using repro::load_n4;
using repro::load_q16;
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

// The M staged x values of slab row kk ([row][m] layout).
template <int M>
__device__ __forceinline__ void gemv_x_row(const float* xs, int kk,
                                           float (&xv)[M]) {
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
}

// n-major weight (swn == 1).  CTA: 128 columns (lane owns 4) x one K slab;
// warp w takes rows w, w + 8, w + 16, ... of the slab.
//
// I8 (int8 levels `wv`, per-column `scale`): a step is 32 rows; thread t
// loads 16 levels of row t / 8 from column 16 * (t % 8) in one 16-byte
// load (the next step's in flight), dequantizes and noises them into a
// shared 32 x 128 float tile (aliasing `red`), and after a barrier the
// warps run the float path's FMA loop on the tile's rows.
template <int M, int NS, bool I8>
__global__ void __launch_bounds__(kThreads, 2)
emt_matmul_gemv_n(const float* __restrict__ x, const void* __restrict__ wv,
                  const float* __restrict__ scale, float* __restrict__ out,
                  const float* __restrict__ sig_ptr, int Mr, int N, int K,
                  int k_slab, long long sxm, long long sxk, long long swk,
                  int vw, uint32_t seed, uint32_t plane,
                  repro::NoiseParams np) {
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

  if constexpr (I8) {
    const int8_t* __restrict__ w = static_cast<const int8_t*>(wv);
    float* wsm = &red[0][0][0];                    // [kI8Step][kGemvBN]
    const int lr = tid >> 3, lc = 16 * (tid & 7), ln = n0 + lc;
    float sc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = ln + j < N ? __ldg(scale + ln + j) : 0.f;
    auto load_q = [&](int k0) {
      const int k = k0 + lr;
      return load_q16(w + k * swk + ln, 1, k < ke ? min(16, N - ln) : 0,
                      vw == 16);
    };
    uint4 qc = load_q(kb), qn = qc;
    stage_x<M, false>(xs, x, Mr, kb, ke, ke - kb, sxm, sxk);
    for (int k0 = kb; k0 < ke; k0 += kI8Step) {
      if (k0 + kI8Step < ke) qn = load_q(k0 + kI8Step);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t word = jj == 0 ? qc.x : jj == 1 ? qc.y
                            : jj == 2 ? qc.z : qc.w;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = noisy<NS>(dequant(word, j, sc[4 * jj + j]),
                           (uint32_t)(k0 + lr), (uint32_t)(ln + 4 * jj + j),
                           pk, F);
        *reinterpret_cast<float4*>(&wsm[lr * kGemvBN + lc + 4 * jj]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kI8Step / kWarps; ++u) {
        const int kk = warp + kWarps * u;
        if (k0 + kk >= ke) break;                  // (uniform in the warp)
        const float4 t = *reinterpret_cast<const float4*>(
            &wsm[kk * kGemvBN + 4 * lane]);
        float xv[M];
        gemv_x_row<M>(xs, k0 - kb + kk, xv);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[m][0] = fmaf(xv[m], t.x, acc[m][0]);
          acc[m][1] = fmaf(xv[m], t.y, acc[m][1]);
          acc[m][2] = fmaf(xv[m], t.z, acc[m][2]);
          acc[m][3] = fmaf(xv[m], t.w, acc[m][3]);
        }
      }
      __syncthreads();
      qc = qn;
    }
  } else {
  const float* __restrict__ w = static_cast<const float*>(wv);
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
      gemv_x_row<M>(xs, kk, xv);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], wp[j], acc[m][j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) wc[u] = wn[u];
  }
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
//
// I8: a step is 128 rows; thread t loads 16 levels of column t / 8 from
// row 16 * (t % 8) (one 16-byte load when swk == 1), dequantizes and
// noises them into a shared 32-column x 128-row float tile, and the lanes
// read their 4-row runs of it in the float path's FMA loop.
template <int M, int NS, bool I8>
__global__ void __launch_bounds__(kThreads, 2)
emt_matmul_gemv_k(const float* __restrict__ x, const void* __restrict__ wv,
                  const float* __restrict__ scale, float* __restrict__ out,
                  const float* __restrict__ sig_ptr, int Mr, int N, int K,
                  int k_slab, long long sxm, long long sxk, long long swk,
                  long long swn, int vw, uint32_t seed, uint32_t plane,
                  repro::NoiseParams np) {
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

  if constexpr (I8) {
    const int8_t* __restrict__ w = static_cast<const int8_t*>(wv);
    __shared__ __align__(16) float wsm[kGemvBNk][kGemvBKk + 4];
    const int lc = tid >> 3, lr = 16 * (tid & 7);
    const int ln = blockIdx.x * kGemvBNk + lc;
    const float sc = ln < N ? __ldg(scale + ln) : 0.f;
    auto load_q = [&](int k0) {
      const int k = k0 + lr;
      return load_q16(w + ln * swn + k * swk, swk,
                      ln < N ? min(16, ke - k) : 0, vw == 16);
    };
    uint4 qc = load_q(kb), qn = qc;
    stage_x<M, true>(xs, x, Mr, kb, ke, k_slab, sxm, sxk);  // 0 past ke
    const int cl = warp * 4 + (lane >> 3);        // this lane's tile column
    for (int k0 = kb; k0 < ke; k0 += kGemvBKk) {
      if (k0 + kGemvBKk < ke) qn = load_q(k0 + kGemvBKk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t word = jj == 0 ? qc.x : jj == 1 ? qc.y
                            : jj == 2 ? qc.z : qc.w;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = noisy<NS>(dequant(word, j, sc),
                           (uint32_t)(k0 + lr + 4 * jj + j), (uint32_t)ln,
                           pk, F);
        *reinterpret_cast<float4*>(&wsm[lc][lr + 4 * jj]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kGemvBKk / 32; ++u) {
        const int kk = k0 - kb + 32 * u + 4 * g;
        if (kk >= k_slab) continue;                // past the staged slab
        const float4 wp = *reinterpret_cast<const float4*>(
            &wsm[cl][32 * u + 4 * g]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 t =
              *reinterpret_cast<const float4*>(&xs[m * k_slab + kk]);
          acc[m] = fmaf(t.x, wp.x, acc[m]);
          acc[m] = fmaf(t.y, wp.y, acc[m]);
          acc[m] = fmaf(t.z, wp.z, acc[m]);
          acc[m] = fmaf(t.w, wp.w, acc[m]);
        }
      }
      __syncthreads();
      qc = qn;
    }
  } else {
  const float* __restrict__ w = static_cast<const float*>(wv);
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

struct Args {
  const float* x;
  const void* w;            // float32, or int8 levels (I8)
  const float* scale;       // I8: the per-column scale (N floats)
  float* out;
  const float* sig;
  int M, N, K, k_slab;
  long long sxm, sxk, swk, swn;
  int vw;
  uint32_t seed, plane;
  repro::NoiseParams np;
};

template <int MT, int NS, bool I8>
void launch_gemv(const Args& a, bool kc, int splits, cudaStream_t s) {
  const size_t smem = sizeof(float) * MT * a.k_slab;
  if (kc) {
    dim3 grid((a.N + kGemvBNk - 1) / kGemvBNk, splits);
    emt_matmul_gemv_k<MT, NS, I8><<<grid, kThreads, smem, s>>>(
        a.x, a.w, a.scale, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm,
        a.sxk, a.swk, a.swn, a.vw, a.seed, a.plane, a.np);
  } else {
    dim3 grid((a.N + kGemvBN - 1) / kGemvBN, splits);
    emt_matmul_gemv_n<MT, NS, I8><<<grid, kThreads, smem, s>>>(
        a.x, a.w, a.scale, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm,
        a.sxk, a.swk, a.vw, a.seed, a.plane, a.np);
  }
}

template <int NS, bool I8>
void launch(const Args& a, bool kc, int splits, int xvec, cudaStream_t s) {
  if (a.M > kGemvMaxM) {
    repro::launch_tiled<NS, I8>(a.x, a.w, a.scale, a.out, a.sig, a.M, a.N,
                                a.K, a.k_slab, a.sxm, a.sxk, a.swk, a.swn,
                                a.vw, xvec, a.seed, a.plane, a.np, kc, splits,
                                s);
    return;
  }
  switch (a.M) {
    case 1: launch_gemv<1, NS, I8>(a, kc, splits, s); break;
    case 2: launch_gemv<2, NS, I8>(a, kc, splits, s); break;
    case 3: launch_gemv<3, NS, I8>(a, kc, splits, s); break;
    case 4: launch_gemv<4, NS, I8>(a, kc, splits, s); break;
    default:
      if (a.M <= 8) launch_gemv<8, NS, I8>(a, kc, splits, s);
      else launch_gemv<16, NS, I8>(a, kc, splits, s);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}


// The shared body of both C entries: check the plan, pick the weight
// loads' width, launch, and sum the slabs.
template <bool I8>
int run(const float* x, const void* w, const float* scale, float* y,
        float* part, const float* sig, const long long* dims,
        unsigned int seed, unsigned int plane, const repro::NoiseParams* np,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], N = (int)dims[1], K = (int)dims[2];
  const int splits = (int)dims[3], k_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], swk = dims[7], swn = dims[8];
  const bool kc = swn != 1;
  const bool gemv = M <= kGemvMaxM;
  const int bk = !gemv ? repro::kTBK : kc ? kGemvBKk : kGemvBK;
  const int mt = M <= 4 ? M : M <= 8 ? 8 : 16;     // the GEMV row template
  if (M < 1 || N < 1 || !repro::split_plan_ok(K, splits, k_slab, bk) ||
      (gemv && (long long)sizeof(float) * mt * k_slab > kGemvXBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  int vw = 1;
  if (I8) {
    // 16 levels a load: along n (n-major) or k (swk == 1)
    if (!kc ? swk % 16 == 0 : swk == 1 && swn % 16 == 0)
      vw = aligned(w, 16) ? 16 : 1;
  } else if (!kc) {
    vw = aligned(w, 16) && swk % 4 == 0  ? 4
         : aligned(w, 8) && swk % 2 == 0 ? 2
                                         : 1;
  } else if (swk == 1 && swn % 4 == 0 && aligned(w, 16)) {
    vw = 4;
  }
  const int xvec = sxk == 1 && sxm % 4 == 0 && aligned(x, 16);
  Args a{x, w, scale, splits > 1 ? part : y, sig, M, N, K, k_slab, sxm, sxk,
         swk, swn, vw, seed, plane, *np};
  if (np->n_states == 2)
    launch<2, I8>(a, kc, splits, xvec, s);
  else
    launch<0, I8>(a, kc, splits, xvec, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)M * N, splits, s));
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
  return run<false>(x, w, nullptr, y, part, sig, dims, seed, plane, np,
                    stream);
}

// The same with w stored as int8 conductance levels (K, N), any strides,
// and `scale` (N contiguous floats) their per-column scale: the kernels
// read the levels (16 a load where the strides allow) and dequantize them
// in registers, w = fl(float(q) * scale[n]), before the noise.  The plan
// is the float weight's (same slabs).
extern "C" int emt_matmul_i8(const float* x, const int8_t* w,
                             const float* scale, float* y, float* part,
                             const float* sig, const long long* dims,
                             unsigned int seed, unsigned int plane,
                             const repro::NoiseParams* np, void* stream) {
  return run<true>(x, w, scale, y, part, sig, dims, seed, plane, np, stream);
}
