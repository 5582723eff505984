// Technique-A noisy crossbar matmul for Hopper (sm_90a) at M <= 16, plain
// FP32 FFMA (M > 16: emt_matmul_fwd.cu, on the tensor cores).
//
// Replaces the TPU kernel repro/kernels/emt_matmul.py::emt_matmul_pallas:
//   y = x @ (w * (1 + a(k, n) * sigma))
// with the RTN offset a(k, n) hashed from the element's GLOBAL (row, col),
// the runtime step seed and the layer plane, inside the kernel: no noise
// tensor ever exists in device memory.  Rounding follows the reference:
// factor = fl(1 + fl(a * sigma)), w' = fl(w * factor) (no FMA contraction);
// the factor of each RTN state is computed once per thread.
//
// What bounds it on the H100: every call streams its whole weight once
// (float32: 4.0 GB per gemma3-1b decode step, 1.2 ms at the H100 SXM's
// published 3.35 TB/s) against 2*M*K*N FLOPs; at decode (M = 4) that is
// far below the FP32 ridge, so bytes bound it, and the per-element hash
// (~17 integer ALU operations in the float32 GEMV, 10 for the hash and the
// state select in the ring GEMV) is the second cost, the first for int8
// levels (a quarter of the bytes).
//
// Design:
// * M <= 16 (decode): GEMV-style kernels templated on M (1-4, 8, 16), every
//   output column's sum in one order whatever the loader: slabs in slab
//   order, in each the 8 warps in warp order, warp w over slab rows w,
//   w + 8, ...  The x rows of the CTA's K slab are staged in shared memory
//   once (a broadcast), so the K walk has no block barrier.
//   - float32 weights (emt_matmul_gemv_n, n-major; emt_matmul_gemv_k, the
//     tied unembed's transposed table read in place): no shared-memory
//     weight tile; each thread loads 16-byte vectors along the weight's
//     unit stride, keeps the next step's (4 at M <= 8) in flight in
//     registers while it hashes and FMAs this step's.  Threads that share
//     columns reduce once, at the end of the slab (shared memory in warp
//     order for n-major, a shuffle butterfly for k-major).
//   - int8 levels (store_int8 serving, emt_matmul_i8) and expert stacks
//     (emt_matmul_experts_f32), n-major: emt_matmul_gemv_ring.  The weight
//     streams through a ring of shared-memory stages filled by cp.async,
//     each warp copying only the rows it consumes (Ring: int8, 4 rows of
//     128 levels a stage, a lane's 16-byte copy read by 4 lanes after one
//     __syncwarp; float32, 2 rows, a lane copying and reading its own
//     float4s), 16 KB a CTA in flight ahead of the warp: no block barrier
//     in the K walk, and the stream goes on while the warp hashes.  Each
//     lane reads its 4 columns (one word of 4 levels, or one float4),
//     dequantizes int8 as fl(float(q) * scale[n]) (one rounding, the
//     reference's w_int8.astype(f32) * w_scale), noises with the float
//     path's rounding and FMAs, all in registers.  The hash's column terms
//     are computed once per thread and its row term once per row
//     (hash_mix_pre's split), and hash_mix_folded drops the xorshift pair
//     that cancels between its rounds.  So int8 products equal the
//     float32 GEMV's on the dequantized weight bit for bit, and a stack of
//     one expert equals K3.  (The int8 k-major GEMV, gemv_k<I8>, serves no
//     path: the int8 tree keeps the unembed float32.)
// * Split-K, planned in Python from the SM count
//   (repro_torch/kernels/splitk.py): slabs of whole chunks write
//   partials to a workspace, and repro::split_sum adds them in slab order
//   (deterministic, no atomics).  Summing them in the grid instead (the
//   last CTA of each output tile, on a ticket) measured slower in device
//   time (PERF.md).
// * A stack of E experts (the MoE layer's three projections, JAX's
//   moe._emt_stacked + einsum) at M <= 16: the ring GEMV with an expert
//   grid axis (template EX, z = e); above 16 rows the tensor-core kernel
//   of emt_experts_tc.cu.  Expert e reads x + e * sxe and w + e * swe and
//   hashes its element (k, n) at row e * K + k: the folded (E * K, N) draw
//   of the reference, the TPU kernel's row base k0_base.  One launch
//   covers a projection of every expert, and the planner counts all the
//   experts' CTAs before it splits K.  Each CTA also sums |w'| (a float
//   partial a row, folded into float64) and takes its max over the weight
//   elements it hashed (disjoint regions: each CTA its own slab of 128
//   columns), and a one-CTA pass (common.cuh stats_finish) adds the
//   per-CTA partials in a fixed order: the noisy stack's statistics, which
//   the layer's accounting reads, without a noisy stack in memory.
// Not yet done (later work): at decode the host's two launches and the
// output allocation, not the device, set the time of a float32 call
// (PERF.md); a split sum inside a thread-block cluster, as the chunked
// prefill merges its splits, would save the second launch and the
// workspace.  The float32 GEMV keeps its register double buffer; the
// eager weight fake-quantization around the call.
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

// The noisy weight and the weight loads are shared with the bit-serial
// kernel (common.cuh).
using repro::dequant;
using repro::f4;
using repro::factor;
using repro::Factors;
using repro::hash_mix_folded;
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

// The end of an n-major slab: the 8 warps' partials of each column
// (acc, this thread's 4 columns) summed in warp order through `red` into
// o (Mr, N), columns n0 .. n0 + 127.  Every thread calls it.
template <int M>
__device__ __forceinline__ void gemv_n_store(const float (&acc)[M][4],
                                             float (*red)[4][kGemvBN],
                                             float* __restrict__ o, int Mr,
                                             int N, int n0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

// n-major float32 weight (swn == 1).  CTA: 128 columns (lane owns 4) x
// one K slab; warp w takes rows w, w + 8, w + 16, ... of the slab.
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
      gemv_x_row<M>(xs, kk, xv);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], wp[j], acc[m][j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) wc[u] = wn[u];
  }

  // slab blockIdx.y
  gemv_n_store<M>(acc, red, out + (long long)blockIdx.y * Mr * N, Mr, N, n0);
}

// ---------------------------------------------------------------------------
// The int8 and experts GEMVs (M <= 16, n-major): the weight streams through
// a ring of shared-memory stages, each warp copying (cp.async) only the
// rows it consumes, kStages - 1 stages ahead, so the K walk has no block
// barrier and the copies stay in flight while the warp hashes and FMAs.

// Copy the first `bytes` (0..CP) bytes at src into CP bytes at shared dst
// and zero the rest, asynchronously (src and dst CP-aligned; CP = 4, 8 or
// 16).  src is not read when bytes is 0.
template <int CP>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CP == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(CP), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring: kStages stages, each a warp's kRows rows of the CTA's 128
// columns for each of the 8 warps (warp w's rows of stage s are slab rows
// kSlabRows * s + w + 8 i, i < kRows: the rows it consumes, in the order
// it consumes them).  int8: a lane copies 16 columns of one of the 4 rows
// (one 16-byte copy) and reads its 4 columns of each row as one word;
// float32: a lane copies and reads its own 4 columns (one float4) of each
// of 2 rows.  Either way (kStages - 1) stages, 16 KB, are in flight per
// CTA, 32 KB per SM at two CTAs.
template <bool I8>
struct Ring {
  static constexpr int kRows = I8 ? 4 : 2;
  static constexpr int kStages = I8 ? 5 : 3;
  static constexpr int kRowBytes = kGemvBN * (I8 ? 1 : 4);
  static constexpr int kWarpBytes = kRows * kRowBytes;
  static constexpr int kStageBytes = kWarps * kWarpBytes;
  static constexpr int kBytes = kStages * kStageBytes;
  static constexpr int kSlabRows = kWarps * kRows;
  // the end-of-slab reduction's [warp][4][column] floats reuse the ring
  static_assert(kBytes >= kWarps * 4 * kGemvBN * 4, "red fits the ring");
  static_assert(kGemvBK % kSlabRows == 0, "slabs of whole stages");
};

__device__ __forceinline__ uint32_t ring_word(const unsigned char* st, int i,
                                              int lane) {
  return *reinterpret_cast<const uint32_t*>(st + i * kGemvBN + 4 * lane);
}

__device__ __forceinline__ float4 ring_f4(const unsigned char* st, int i,
                                          int lane) {
  return *reinterpret_cast<const float4*>(st + i * 4 * kGemvBN + 16 * lane);
}

// The experts' statistics of one row's 4 noisy weights: their |w'| summed
// in float (a tree), the partial folded into the float64 sum (one add a
// row, not a serial float64 chain of 4); the max exact.
__device__ __forceinline__ void take_stats(const float (&wp)[4], double& ssum,
                                           float& smax) {
  const float a0 = fabsf(wp[0]), a1 = fabsf(wp[1]), a2 = fabsf(wp[2]),
              a3 = fabsf(wp[3]);
  ssum += (double)((a0 + a1) + (a2 + a3));
  smax = fmaxf(smax, fmaxf(fmaxf(a0, a1), fmaxf(a2, a3)));
}

// CTA: 128 columns (lane owns 4) x one K slab, as emt_matmul_gemv_n, and
// the same order of every column's sum: warp w takes slab rows w, w + 8,
// ... in order, the 8 warps are summed in warp order.  The noise hash is
// split as common.cuh's hash_mix_pre allows: the column terms once per
// thread, the row term (with the seed and plane) once per row, one XOR an
// element, and hash_mix_folded drops the xorshift pair that cancels.
// I8: levels `wv` (int8) dequantized in registers, fl(float(q) *
// scale[n]); EX: expert blockIdx.z of a stack, its |w'| sum and max
// reduced per CTA.
template <int M, int NS, bool I8, bool EX>
__global__ void __launch_bounds__(kThreads, 2)
emt_matmul_gemv_ring(const float* __restrict__ x,
                     const void* __restrict__ wv,
                     const float* __restrict__ scale, float* __restrict__ out,
                     const float* __restrict__ sig_ptr, int Mr, int N, int K,
                     int k_slab, long long sxm, long long sxk, long long swk,
                     int vw, uint32_t seed, uint32_t plane,
                     repro::NoiseParams np, repro::Experts ex) {
  static_assert(!(EX && I8), "experts: float32 weights");
  using R = Ring<I8>;
  constexpr int S = R::kStages;
  constexpr int E8 = I8 ? 1 : 4;                   // bytes an element
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                      // [stage][warp][row][col]
  float* xs = reinterpret_cast<float*>(smem + R::kBytes);   // [k_slab][M]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kGemvBN;
  const int n = n0 + 4 * lane;
  const int kb = blockIdx.y * k_slab;
  const int rows = min(K, kb + k_slab) - kb;       // the slab's rows
  const int nst = (rows + R::kSlabRows - 1) / R::kSlabRows;
  const int ei = EX ? blockIdx.z : 0;              // the expert
  if constexpr (EX) x += ei * ex.sxe;
  const uint32_t row0 = EX ? (uint32_t)ei * (uint32_t)K : 0u;

  // This lane's copies: I8, 16 columns (bytes cc ..) of row ci of each of
  // the warp's stages; float32, its own 4 columns of each row.  cb: their
  // bytes before column N; src: the next stage's source (issue() takes the
  // stages in order).
  const int ci = I8 ? lane >> 3 : 0;
  const int cc = I8 ? 16 * (lane & 7) : 16 * lane;
  const int cb = max(0, min(16, (N - n0) * E8 - cc));
  const char* src = static_cast<const char*>(wv) +
                    (EX ? ei * ex.swe * 4 : 0) +
                    ((kb + warp + kWarps * ci) * swk + n0) * E8 + cc;
  const long long stage_step = R::kSlabRows * swk * E8;
  const long long row_step = kWarps * swk * E8;    // float32: row i to i + 1
  unsigned char* const dst0 =
      ring + warp * R::kWarpBytes + ci * R::kRowBytes + cc;
  // the warp's stage t into ring slot `slot`; rows past the slab and
  // columns past N are zeros
  auto issue = [&](int t, int slot) {
    unsigned char* dst = dst0 + slot * R::kStageBytes;
    const int kk = R::kSlabRows * t + warp + kWarps * ci;
    if constexpr (I8) {
      const int b = kk < rows ? cb : 0;
      if (vw == 16)
        copy_async<16>(dst, src, b);
      else                                         // rows not 16-B aligned
        *reinterpret_cast<uint4*>(dst) =
            load_q16(reinterpret_cast<const int8_t*>(src), 1, b, false);
    } else {
#pragma unroll
      for (int i = 0; i < R::kRows; ++i) {
        const int b = kk + kWarps * i < rows ? cb : 0;
        const char* p = src + i * row_step;
        unsigned char* d = dst + i * R::kRowBytes;
        if (vw == 4) {
          copy_async<16>(d, p, b);
        } else if (vw == 2) {
          copy_async<8>(d, p, min(b, 8));
          copy_async<8>(d + 8, p + 8, max(b - 8, 0));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            copy_async<4>(d + 4 * j, p + 4 * j, b > 4 * j ? 4 : 0);
        }
      }
    }
    src += stage_step;
  };

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {                // in flight while x stages
    if (t < nst) issue(t, t);
    copy_commit();
  }

  const uint32_t pks = repro::pre(repro::hash_pk(seed, plane));
  uint32_t cs[4];                                  // the column terms
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cs[j] = repro::pre(repro::hash_rc(0u, (uint32_t)(n + j)));
  float sc[4];                                     // I8: the column scales
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sc[j] = I8 && n + j < N ? __ldg(scale + n + j) : 0.f;
  Factors F;
  make_factors(np, *sig_ptr, F);
  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  double ssum = 0.0;                               // EX: sum, max of |w'|
  float smax = 0.f;
  stage_x<M, false>(xs, x, Mr, kb, kb + rows, rows, sxm, sxk);

  // one row of the warp's stage (slab row kk, row i of stage st): hash,
  // noise and FMA its 4 columns
  auto row = [&](const unsigned char* st, int i, int kk) {
    float wt[4];
    if constexpr (I8) {
      uint32_t word;
      word = ring_word(st, i, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) wt[j] = dequant(word, j, sc[j]);
    } else {
      float4 v;
      v = ring_f4(st, i, lane);
      wt[0] = v.x; wt[1] = v.y; wt[2] = v.z; wt[3] = v.w;
    }
    const uint32_t rt = repro::hash_rc(row0 + (uint32_t)(kb + kk), 0u);
    const uint32_t rp = rt ^ (rt >> 16) ^ pks;     // pre(row) ^ pre(pk)
    float wp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wp[j] = __fmul_rn(wt[j], factor<NS>(hash_mix_folded(cs[j], rp), F));
    if constexpr (EX) take_stats(wp, ssum, smax);
    float xr[M];
    gemv_x_row<M>(xs, kk, xr);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xr[m], wp[j], acc[m][j]);
  };

  int rd = 0, wr = S - 1;                          // ring slots
  for (int s = 0; s < nst; ++s) {
    copy_wait<S - 2>();                            // stage s has landed
    if constexpr (I8) __syncwarp();                // (lanes read others' copies)
    if (s + S - 1 < nst) issue(s + S - 1, wr);     // into the slot read last
    copy_commit();
    wr = wr + 1 == S ? 0 : wr + 1;
    const unsigned char* st = ring + rd * R::kStageBytes + warp * R::kWarpBytes;
    rd = rd + 1 == S ? 0 : rd + 1;
    const int kk = R::kSlabRows * s + warp;        // the warp's first row
    if (kk + kWarps * (R::kRows - 1) < rows) {     // (uniform) every row
#pragma unroll
      for (int i = 0; i < R::kRows; ++i) row(st, i, kk + kWarps * i);
    } else {                                       // the slab's last stage
#pragma unroll
      for (int i = 0; i < R::kRows; ++i)
        if (kk + kWarps * i < rows) row(st, i, kk + kWarps * i);
    }
  }
  copy_wait<0>();                                  // (empty groups only)

  // slab blockIdx.y of expert ei
  gemv_n_store<M>(acc, reinterpret_cast<float (*)[4][kGemvBN]>(ring),
                  out + ((long long)blockIdx.y * gridDim.z + ei) * Mr * N,
                  Mr, N, n0);
  if constexpr (EX) repro::cta_stats<kThreads>(ssum, smax, ex.stats);
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
  int E;                    // experts (EX; else 1)
  repro::Experts ex;
};

template <int MT, int NS, bool I8, bool EX>
void launch_gemv(const Args& a, bool kc, int splits, cudaStream_t s) {
  const size_t smem = sizeof(float) * MT * a.k_slab;
  if constexpr (!EX) {
    if (kc) {
      dim3 grid((a.N + kGemvBNk - 1) / kGemvBNk, splits);
      emt_matmul_gemv_k<MT, NS, I8><<<grid, kThreads, smem, s>>>(
          a.x, a.w, a.scale, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm,
          a.sxk, a.swk, a.swn, a.vw, a.seed, a.plane, a.np);
      return;
    }
  }
  dim3 grid((a.N + kGemvBN - 1) / kGemvBN, splits, a.E);
  if constexpr (!I8 && !EX) {
    emt_matmul_gemv_n<MT, NS><<<grid, kThreads, smem, s>>>(
        a.x, static_cast<const float*>(a.w), a.out, a.sig, a.M, a.N, a.K,
        a.k_slab, a.sxm, a.sxk, a.swk, a.vw, a.seed, a.plane, a.np);
  } else {
    // the ring, then the x rows (above 48 KB with the largest slab)
    const auto kernel = emt_matmul_gemv_ring<MT, NS, I8, EX>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<I8>::kBytes + kGemvXBytes);
    (void)attr;                        // (a refusal fails the launch below)
    kernel<<<grid, kThreads, Ring<I8>::kBytes + smem, s>>>(
        a.x, a.w, a.scale, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm,
        a.sxk, a.swk, a.vw, a.seed, a.plane, a.np, a.ex);
  }
}

template <int NS, bool I8, bool EX>
void launch(const Args& a, bool kc, int splits, cudaStream_t s) {
  switch (a.M) {
    case 1: launch_gemv<1, NS, I8, EX>(a, kc, splits, s); break;
    case 2: launch_gemv<2, NS, I8, EX>(a, kc, splits, s); break;
    case 3: launch_gemv<3, NS, I8, EX>(a, kc, splits, s); break;
    case 4: launch_gemv<4, NS, I8, EX>(a, kc, splits, s); break;
    default:
      if (a.M <= 8) launch_gemv<8, NS, I8, EX>(a, kc, splits, s);
      else launch_gemv<16, NS, I8, EX>(a, kc, splits, s);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}


// The shared body of the C entries: check the plan, pick the weight
// loads' width, launch, and sum the slabs.  M <= 16; EX: a stack of E
// experts at the strides of `ex` (n-major weights only).
template <bool I8, bool EX>
int run(const float* x, const void* w, const float* scale, float* y,
        float* part, const float* sig, const long long* dims,
        unsigned int seed, unsigned int plane, const repro::NoiseParams* np,
        void* stream, int E = 1, repro::Experts ex = {0, 0, nullptr}) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], N = (int)dims[1], K = (int)dims[2];
  const int splits = (int)dims[3], k_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], swk = dims[7], swn = dims[8];
  const bool kc = swn != 1;
  const int bk = kc ? kGemvBKk : kGemvBK;
  const int mt = M <= 4 ? M : M <= 8 ? 8 : 16;     // the GEMV row template
  if (M < 1 || N < 1 || M > kGemvMaxM ||
      !repro::split_plan_ok(K, splits, k_slab, bk) ||
      (long long)sizeof(float) * mt * k_slab > kGemvXBytes ||
      (EX && (kc || E < 1 || (long long)splits * E > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  int vw = 1;
  if (I8) {
    // 16 levels a load: along n (n-major) or k (swk == 1)
    if (!kc ? swk % 16 == 0 : swk == 1 && swn % 16 == 0)
      vw = aligned(w, 16) ? 16 : 1;
  } else if (!kc) {
    // (every expert's rows at the alignment of the first's)
    const long long swe = ex.swe;
    vw = aligned(w, 16) && swk % 4 == 0 && swe % 4 == 0  ? 4
         : aligned(w, 8) && swk % 2 == 0 && swe % 2 == 0 ? 2
                                                         : 1;
  } else if (swk == 1 && swn % 4 == 0 && aligned(w, 16)) {
    vw = 4;
  }
  Args a{x, w, scale, splits > 1 ? part : y, sig, M, N, K, k_slab, sxm, sxk,
         swk, swn, vw, seed, plane, *np, E, ex};
  if (np->n_states == 2)
    launch<2, I8, EX>(a, kc, splits, s);
  else
    launch<0, I8, EX>(a, kc, splits, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)E * M * N, splits, s));
}

}  // namespace

// y (M, N) = x (M, K) @ noisy(w (K, N)) at M <= 16 (M > 16:
// emt_matmul_fwd.cu's emt_matmul_tc_f32); any strides.
// dims = {M, N, K, splits, k_slab, sxm, sxk, swk, swn} (one host array, so
// a ctypes call converts 10 arguments, not 18).  `splits` CTAs per output
// tile along K, each over `k_slab` rows: multiples of 32 rows (n-major
// weight; x rows of a slab <= 24 KB) or of 128 rows (other weights), as
// planned by repro_torch/kernels/emt_matmul.py::plan.
// With splits > 1 the partials go to `part` (splits * M * N floats) and are
// summed into y in slab order.
extern "C" int emt_matmul_f32(const float* x, const float* w, float* y,
                              float* part, const float* sig,
                              const long long* dims, unsigned int seed,
                              unsigned int plane,
                              const repro::NoiseParams* np, void* stream) {
  return run<false, false>(x, w, nullptr, y, part, sig, dims, seed, plane,
                           np, stream);
}

// The same with w stored as int8 conductance levels (K, N), any strides,
// and `scale` (N contiguous floats) their per-column scale: the kernels
// read the levels (16 a copy where the strides allow) and dequantize them
// in registers, w = fl(float(q) * scale[n]), before the noise.  The plan
// is the float weight's (same slabs); M <= 16 (M > 16:
// emt_matmul_tc_i8).
extern "C" int emt_matmul_i8(const float* x, const int8_t* w,
                             const float* scale, float* y, float* part,
                             const float* sig, const long long* dims,
                             unsigned int seed, unsigned int plane,
                             const repro::NoiseParams* np, void* stream) {
  return run<true, false>(x, w, scale, y, part, sig, dims, seed, plane, np,
                          stream);
}

// A stack of E experts at M <= 16: y (E, M, N) = x (E, M, K) @
// noisy(w (E, K, N)) per expert, expert e's element (k, n) hashed at row
// e * K + k; w n-major (swn == 1).  dims = {M, N, K, splits, k_slab, sxm,
// sxk, swk, swn, E, sxe, swe, slots}: the plan is emt_matmul.py::plan's
// for the experts entry, its tiles counted; `part` holds splits * E * M *
// N floats, `parts` 2 * slots float64 values, slots being the grid's CTAs
// (checked), and `stats` receives {sum |w'|, max |w'|} of the noisy
// stack.  (M > 16: emt_experts_tc.cu's emt_matmul_experts_tc_f32.)
extern "C" int emt_matmul_experts_f32(const float* x, const float* w,
                                      float* y, float* part, double* parts,
                                      float* stats, const float* sig,
                                      const long long* dims,
                                      unsigned int seed, unsigned int plane,
                                      const repro::NoiseParams* np,
                                      void* stream) {
  const int M = (int)dims[0], N = (int)dims[1];
  const long long splits = dims[3], E = dims[9], slots = dims[12];
  const long long ctas =
      (long long)((N + kGemvBN - 1) / kGemvBN) * splits * E;
  if (M > kGemvMaxM || dims[8] != 1 || E < 1 || E > 65535 || slots != ctas)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = run<false, true>(x, w, nullptr, y, part, sig, dims, seed,
                                   plane, np, stream, (int)E,
                                   repro::Experts{dims[10], dims[11], parts});
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::stats_finish<kThreads><<<1, kThreads, 0, s>>>(parts, slots, stats);
  return static_cast<int>(cudaGetLastError());
}
