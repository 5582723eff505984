// Technique-C bit-serial noisy crossbar matmul for Hopper (sm_90a): a
// GEMV on the FP32 pipe at M <= 16, the tensor cores above.
//
// Replaces the TPU kernel repro/kernels/emt_bitserial.py::emt_bitserial_pallas:
//   y = sum_{p < bits} 2^p * (sign(xq) * bit_p(|xq|)) @ (w * (1 + a_p * sigma))
// where xq holds integer-valued float DAC levels and a_p(k, n) is the RTN
// offset hashed from the weight element's GLOBAL (row, col), the runtime
// step seed and plane base_plane + p.  The activation bit-planes and the
// noisy weights never reach device memory.  The noisy weight is K3's
// (common.cuh): factor = fl(1 + fl(a * sigma)), w' = fl(w * factor), no
// FMA contraction, as the reference rounds it.
//
// What bounds it on the H100: every weight element is hashed once per
// plane (hash_mix, 18 32-bit integer operations; the tensor-core body
// issues ~21 instructions an element-plane in all), in the TPU kernel's
// body too.  At a gemma3-1b decode step (78 MLP projections, M = 4, 7
// planes) that is ~78 G integer operations, 4.7 ms at 64 INT32 lanes per
// SM x 132 SMs x 1.98 GHz, against 0.74 ms for the 2.49 GB of f32
// weights: the integer issue bounds it, not the bytes or the FP32 FMAs.
// At a chunk step (M = 64) the products are 16x more, 556 GFLOP: 8.3 ms on
// the FP32 pipe, 1.7 ms as three BF16 products on the tensor cores, beside
// 2.6 ms of the hash and its select on the ALU pipe (4.35 G element-planes
// at 10 operations each; the tensor-core body's plane loop issues 13.4).
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
// * M > 16 (chunk steps, the CNN's training; bitserial_tc): the transposed
//   product on the tensor cores, the per-plane noisy weight built in
//   registers as wgmma's A operand (the TPU kernel's own idea: the weight
//   tile loaded once, re-read with fresh noise on each plane), never
//   stored; B the signed plane of x from a ring of shared-memory tiles
//   that a producer warpgroup fills, handed over by mbarriers; no block
//   barrier in the K walk.  Three BF16 products a plane (w' in three
//   truncated pieces of 8 significant bits, the plane exact in one), so
//   2^p x I still returns 2^p x w' bit for bit.  On a two-state table the
//   pieces of both states are split once a k-tile and a plane selects
//   them by the hash with one logic operation a piece.  A CTA covers 128
//   weight columns by 64 x rows at M <= 64 and by 128 above (two 64-row
//   tiles of products on the same A fragments), so every weight element
//   is hashed once per plane and call at M <= 64 and once per 128 rows
//   above.  256 rows would hold 256 accumulators a thread (the products'
//   and their promoted sums), past the 216 registers a consumer has.
//   Each k-tile's products accumulate on the tensor cores and are
//   promoted into an FP32 sum rounded to nearest.
// * The slabs of K are planned in Python
//   (repro_torch/kernels/emt_bitserial.py::plan); their partials are
//   summed in slab order by repro::split_sum (deterministic).
// Not yet done (later work): hash_mix_folded in the GEMV.
#include <cstdint>

#include "common.cuh"
#include "emt_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGemvMaxM = 16;
constexpr int kGemvBN = 128;              // n-major: 32 lanes x 4 columns
constexpr int kGemvBNk = kWarps * 4;      // k-major: 4 columns per warp (32)
constexpr int kGemvBK = 32;               // GEMV slab granularity (rows)
constexpr int kGemvXBytes = 96 * 1024;    // a slab's staged planes, at most
constexpr int kRedBytes = kWarps * 4 * kGemvBN * 4;   // n-major reduction

using repro::f4;
using repro::Factors;
using repro::load_k4;
using repro::load_n4;
using repro::make_factors;

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
// Tensor cores, M > 16: the transposed product
//   out^T (weight columns x x rows) = sum_p W~_p^T . P_p^T
// one CTA a tile of kCols weight columns by R x kRows x rows (R = 1 up to
// 64 rows, 2 above) over one K slab.
// The per-plane noisy weight W~_p is wgmma's A operand from registers:
// each consumer thread copies its A-fragment elements of a k-tile once,
// hashes them on every plane and takes w~ in three BF16 pieces of 8
// significant bits each, by truncation (hi + mid + lo == w~ exactly, each
// partial sum exact), so no noisy weight is stored anywhere.  B is the
// signed plane P_p of x (+-2^p or 0, exact in BF16), written once per
// (k-tile, plane) by the producer warpgroup into a ring of swizzled
// shared-memory tiles handed over by mbarriers.  BF16 and not TF32: three
// pieces either way, and a k16 BF16 product does twice a k8 TF32 one's
// work in the same time.  A from shared memory (the pieces stored each
// plane, as the 3xTF32 template stores its operands) measured slower
// (PERF.md).
namespace tcb {
constexpr int kRows = 64;                  // x rows a row tile: the
                                           // products' N
constexpr int kConsumerWGs = 2;            // consumer warpgroups, 64 columns
                                           // each
constexpr int kCols = 64 * kConsumerWGs;   // weight columns a CTA
constexpr int kBK = 32;                    // k-tile (two k16 steps)
constexpr int kStages = 8;                 // plane tiles in the ring
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMaxRowTiles = 2;            // R, the row tiles a CTA
// one row tile of a plane: 64 rows of 32 BF16 (64 bytes), 4 KB; a ring
// stage holds the CTA's R of them, row after row
constexpr int kTileBytes = kRows * kBK * 2;
constexpr int kEl = 16;                    // weight elements a consumer
                                           // thread holds of a k-tile
// levels a producer holds of a k-tile, per row tile
constexpr int kXEl = kRows * kBK / kProducers;
// the consumers' weight elements of the next k-tile, each thread's own
// slots (two buffers of kEl floats a thread, float2 (pair, thread))
constexpr int kWRingBytes = 2 * kEl * kConsumers * 4;
// the ring, the weights' slots, and 1 KB to align the tiles to the
// swizzle pattern
template <int R>
constexpr int kSmemBytes = kStages * R * kTileBytes + kWRingBytes + 1024;
// the dynamic shared memory and the static mbarriers within the 227 KB a
// CTA may have
static_assert(kSmemBytes<kMaxRowTiles> + 2 * kStages * 8 <= 227 * 1024,
              "shared memory");
// 65,536 registers over the threads at entry (168 each of 384): the
// producers give theirs up to the consumers, which hold 64 R accumulators
// (each row tile's products and their promoted sum), the k-tile's pieces
// in both states (48) and the A fragments of two k16 steps (2 x 12).  At
// R = 2 a producer holds 32 levels across its plane loop and spills 160
// bytes; 88 producer registers (the consumers 208) moved a 68-byte spill
// into the consumers, at the same time (PERF.md).
constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs =
    ((kConsumerWGs + 1) * kEntryRegs - kProducerRegs) / kConsumerWGs / 8 * 8;

static_assert(kProducerRegs + kConsumerWGs * kConsumerRegs <=
                  (kConsumerWGs + 1) * kEntryRegs,
              "setmaxnreg moves registers, it does not add any");

// A fragments of one k16 step: piece (hi, mid, lo), register (wgmma's
// m64k16 BF16 A layout: registers 0-3 hold rows g, g + 8, g, g + 8 of the
// thread's warp's 16 rows at columns 2 t and 2 t + 1, 2 t + 8 and 2 t + 9,
// the lower column in the low half)
using Frag = uint32_t[3][4];

// d (m64 x n64, FP32) += A (registers) . B (shared memory, K-major, 64-byte
// swizzle), one k16 step of BF16 operands; d = A . B when !accumulate.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The shared-memory matrix descriptor of a K-major tile with the 64-byte
// swizzle: 8-row groups 512 bytes apart (SBO), the leading offset unused
// by this layout (1), start address >> 4.
__device__ __forceinline__ uint64_t desc64(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// The byte offset of 16-byte chunk c (BF16 columns 8 c .. 8 c + 7) of row
// r in a plane tile: rows of 64 bytes, chunk c stored at c ^ ((r >> 1) & 3)
// (the 64-byte swizzle: address bits 4-5 XOR bits 7-8).
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// a and b truncated to BF16 (their top 8 significant bits: conversion
// toward zero), as one pair, a in the low half.
__device__ __forceinline__ uint32_t bf16x2_rz(float a, float b) {
  uint32_t d;
  asm("cvt.rz.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
  return d;
}

// The FP32 values of a BF16 pair's low and high halves.
__device__ __forceinline__ float low_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float high_f(uint32_t p) {
  return __uint_as_float(p & 0xFFFF0000u);
}

// An 8-byte asynchronous copy to shared memory, `bytes` (0, 4 or 8) of it
// read from src and the rest zero-filled.
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   repro::tc::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Keep the compiler from moving reads or writes of d across the
// asynchronous products' issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep a fragment's registers unchanged up to this point: wgmma reads its
// A registers asynchronously, until the wait that completes it.
__device__ __forceinline__ void keep(Frag& a) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[c][j]));
}
}  // namespace tcb

// Consumers (warpgroups 0-1, 64 weight columns each): per k-tile, each
// thread's 16 weight elements (rows k0 + 16 s + 2 t + i + 8 h, s, i, h < 2,
// of columns na and na + 1: the A rows g and g + 8 of its warp map to two
// adjacent columns, so an n-major weight copies as float2), copied by
// cp.async into the thread's own shared-memory slots a k-tile ahead (no
// barrier: each thread reads back only what it copied), with the
// pre-shifted hash terms of their 8 rows and 2 columns (the pre-shift
// distributes over XOR, so an element's term is one 3-input XOR away).
// On a two-state table each register's three pieces are split once a
// k-tile in both states (fl(w * f0), fl(w * f1)); per plane and k16 step
// hash_mix_folded and one compare a row give a mask that picks each half
// of each piece (one 3-input logic operation); any other table computes
// fl(w * factor) and splits it per plane.  Then three wgmma (lo, mid, hi)
// on each of the plane's R row tiles.  The fragments of the two k16 steps
// alternate, so one is built while the other's products run.  Each
// k-tile's sum over
// all its planes starts from zero and is added into an FP32 running sum
// rounded to nearest (the tensor cores' accumulation loses low bits).
// Producer (warpgroup 2): the k-tile of x's levels in registers (each
// level's integer magnitude with its sign in bit 31; at R = 1 loaded a
// k-tile ahead, at R = 2 when its k-tile starts, 8 ring stages ahead of
// the consumers), then per plane its +-2^p or 0 in BF16 into the ring
// stage, K-major with the 64-byte swizzle.
template <int NS, int R>
__global__ void __launch_bounds__(tcb::kThreads, 1)
bitserial_tc(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ out, const float* __restrict__ sig_ptr,
             int M, int N, int K, int k_slab, long long sxm, long long sxk,
             long long swk, long long swn, int bits, uint32_t seed,
             uint32_t base_plane, repro::NoiseParams np) {
  using namespace tcb;
  using repro::tc::bar_arrive;
  using repro::tc::bar_wait;
  extern __shared__ unsigned char smem_dyn[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const uint32_t pad =
      (1024 - (repro::tc::smem_u32(smem_dyn) & 1023)) & 1023;
  unsigned char* base = smem_dyn + pad;
  const int tid = threadIdx.x;
  constexpr int kPlaneBytes = R * kTileBytes;
  constexpr int kLevels = R * kXEl;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * R * kRows;
  const int kb = blockIdx.z * k_slab, ke = min(K, kb + k_slab);
  const int nt = (ke - kb + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      repro::tc::bar_init(&full[s], kProducers);
      repro::tc::bar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int pr = pt >> 2, cg = pt & 3;   // rows pr + 32 i, columns 8 cg..
    const bool xvec = sxk == 1 && sxm % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
    // x[m0 + pr + 32 i, k0 + 8 cg + j] (0 past M or the slab)
    auto load_x = [&](int k0, float (&v)[kLevels]) {
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) {
        const int m = m0 + pr + 32 * i, k = k0 + 8 * cg;
        const float* p = x + m * sxm + k * sxk;
        if (m < M && xvec && k + 7 < ke) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(p));
          const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
          v[8 * i] = a.x; v[8 * i + 1] = a.y; v[8 * i + 2] = a.z;
          v[8 * i + 3] = a.w; v[8 * i + 4] = b.x; v[8 * i + 5] = b.y;
          v[8 * i + 6] = b.z; v[8 * i + 7] = b.w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[8 * i + j] = m < M && k + j < ke ? __ldg(p + j * sxk) : 0.f;
        }
      }
    };
    float xn[kLevels];
    if (R == 1 && nt > 0) load_x(kb, xn);
    int q = 0;
    for (int t = 0; t < nt; ++t) {
      if (R > 1) load_x(kb + t * kBK, xn);
      uint32_t u[kLevels];
#pragma unroll
      for (int e = 0; e < kLevels; ++e)
        u[e] = __float2uint_rz(fabsf(xn[e])) |
               (__float_as_uint(xn[e]) & 0x80000000u);
      if (R == 1 && t + 1 < nt) load_x(kb + (t + 1) * kBK, xn);
      for (int p = 0; p < bits; ++p, ++q) {
        const int s = q % kStages;
        // +-2^p as BF16 (sign, then the exponent 127 + p)
        const uint32_t e2p = (uint32_t)(127 + p) << 7;
        bar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
        unsigned char* st = base + s * kPlaneBytes;
#pragma unroll
        for (int i = 0; i < 2 * R; ++i) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a = u[8 * i + 2 * j], b = u[8 * i + 2 * j + 1];
            const uint32_t lo = (a >> p) & 1u ? (a >> 16 & 0x8000u) | e2p : 0u;
            const uint32_t hi = (b >> p) & 1u ? (b >> 16 & 0x8000u) | e2p : 0u;
            v[j] = lo | hi << 16;
          }
          *reinterpret_cast<uint4*>(st + chunk_at(pr + 32 * i, cg)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
        // the generic-proxy stores, made visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int na = n0 + 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * g;
  const bool wvec = swn == 1 && swk % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 8 == 0;
  Factors F;
  make_factors(np, *sig_ptr, F);
  float* wring = reinterpret_cast<float*>(base + kStages * kPlaneBytes);
  // row r = 4 s + 2 h + i of the k-tile at k0 is k0 + 16 s + 8 h + 2 t4 + i
  auto row = [&](int k0, int r) {
    return k0 + 16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * t4 + (r & 1);
  };
  // pair r: w[row r, na and na + 1] (0 past N or the slab) into the
  // thread's slot of buffer `buf`
  auto copy_w = [&](int k0, int buf) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = row(k0, r);
      const float* p = w + k * swk + na * swn;
      float* dst = wring + 2 * ((buf * 8 + r) * kConsumers + tid);
      const bool k_ok = k < ke;
      if (wvec) {
        const int bytes = !k_ok ? 0 : na + 1 < N ? 8 : na < N ? 4 : 0;
        cp_async8(dst, bytes ? p : w, bytes);
      } else {
        const bool ok0 = k_ok && na < N, ok1 = k_ok && na + 1 < N;
        repro::tc::cp_async4(dst, ok0 ? p : w, ok0 ? 4 : 0);
        repro::tc::cp_async4(dst + 1, ok1 ? p + swn : w, ok1 ? 4 : 0);
      }
    }
    repro::tc::cp_async_commit();
  };
  // the row (k) and column (n) hash terms, pre-shifted: element (k, n)'s
  // is prk ^ pcn
  const uint32_t pcn[2] = {repro::pre((uint32_t)na * 0x85EBCA6Bu),
                           repro::pre((uint32_t)(na + 1) * 0x85EBCA6Bu)};
  const uint32_t sbase = repro::tc::smem_u32(base);
  float acc[R][32], d[R][32];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[r][i] = d[r][i] = 0.f;
  Frag a0 = {}, a1 = {};
  float wr[kEl];              // the k-tile's raw weight elements (2 r + c)
  uint32_t prk[8];            // their 8 rows' pre-shifted hash terms
  uint32_t pks = 0;
  if (nt > 0) copy_w(kb, 0);
  // the pieces of two rows' values v0, v1 as BF16 pairs: hi, then mid of
  // what hi leaves, then lo, the rest (exact in BF16)
  auto split = [&](float v0, float v1, uint32_t (&pc)[3]) {
    pc[0] = bf16x2_rz(v0, v1);
    const float r0 = __fsub_rn(v0, low_f(pc[0]));
    const float r1 = __fsub_rn(v1, high_f(pc[0]));
    pc[1] = bf16x2_rz(r0, r1);
    pc[2] = bf16x2_rz(__fsub_rn(r0, low_f(pc[1])),
                      __fsub_rn(r1, high_f(pc[1])));
  };
  // a two-state table: each register's pieces in state 0 (s0) and their
  // XOR with state 1's (s1x), split once a k-tile; a plane then selects
  // each half of each piece by its element's hash with one 3-input
  // logic operation (s0 ^ (s1x & mask))
  uint32_t s0[2][4][3], s1x[2][4][3];
  auto prepare = [&]() {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * s + 2 * (j >> 1), c = j & 1;
        const float w0 = wr[2 * r + c], w1 = wr[2 * r + 2 + c];
        uint32_t p1[3];
        split(__fmul_rn(w0, F.f[0]), __fmul_rn(w1, F.f[0]), s0[s][j]);
        split(__fmul_rn(w0, F.f[1]), __fmul_rn(w1, F.f[1]), p1);
#pragma unroll
        for (int k = 0; k < 3; ++k) s1x[s][j][k] = s0[s][j][k] ^ p1[k];
      }
  };
  // k16 step s's fragments of the current plane (pks): register j holds
  // column c = j & 1 at rows 4 s + 2 (j >> 1) and the next
  auto build = [&](Frag& a, int s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * s + 2 * (j >> 1), c = j & 1;
      const uint32_t h0 = repro::hash_mix_folded(prk[r] ^ pcn[c], pks);
      const uint32_t h1 = repro::hash_mix_folded(prk[r + 1] ^ pcn[c], pks);
      if constexpr (NS == 2) {
        const uint32_t m = (h0 >= F.t2 ? 0x0000FFFFu : 0u) |
                           (h1 >= F.t2 ? 0xFFFF0000u : 0u);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          a[k][j] = s0[s][j][k] ^ (s1x[s][j][k] & m);
      } else {
        uint32_t pc[3];
        split(__fmul_rn(wr[2 * r + c], repro::factor<NS>(h0, F)),
              __fmul_rn(wr[2 * r + 2 + c], repro::factor<NS>(h1, F)), pc);
#pragma unroll
        for (int k = 0; k < 3; ++k) a[k][j] = pc[k];
      }
    }
  };
  // step s's products on the plane's row tiles, the first of which has
  // the descriptor d0, one commit group (k16 step s starts 32 bytes along
  // the 64-byte rows: 2 in the descriptor's address field; row tile r
  // kTileBytes further on)
  auto issue = [&](Frag& a, int s, uint64_t d0, bool fresh) {
    repro::tc::wgmma_fence();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint64_t db = d0 + r * (kTileBytes >> 4) + 2 * s;
      wgmma_rs(d[r], a[2], db, !fresh);
      wgmma_rs(d[r], a[1], db, 1);
      wgmma_rs(d[r], a[0], db, 1);
    }
    repro::tc::wgmma_commit();
  };
  int q = 0;
  for (int t = 0; t < nt; ++t) {
    const int k0 = kb + t * kBK;
    repro::tc::cp_async_wait<0>();   // this thread's copies of tile t
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(
          wring + 2 * (((t & 1) * 8 + r) * kConsumers + tid));
      wr[2 * r] = v.x;
      wr[2 * r + 1] = v.y;
      prk[r] = repro::pre((uint32_t)row(k0, r) * 0x9E3779B9u);
    }
    if (t + 1 < nt) copy_w(k0 + kBK, (t + 1) & 1);
    if constexpr (NS == 2) prepare();
    for (int p = 0; p < bits; ++p, ++q) {
      const int s = q % kStages;
      const uint64_t d0 = desc64(sbase + s * kPlaneBytes);
      pks = repro::pre(repro::hash_pk(seed, base_plane + (uint32_t)p));
      build(a0, 0);
      bar_wait(&full[s], (q / kStages) & 1);
      issue(a0, 0, d0, p == 0);
      repro::tc::wgmma_wait<1>();     // the previous plane's second step
      keep(a1);
      if (p > 0) bar_arrive(&empty[(q - 1) % kStages]);
      build(a1, 1);
      issue(a1, 1, d0, false);
      repro::tc::wgmma_wait<1>();     // this plane's first step
      keep(a0);
    }
    repro::tc::wgmma_wait<0>();
    keep(a1);
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(d[r]);
    bar_arrive(&empty[(q - 1) % kStages]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = __fadd_rn(acc[r][i], d[r][i]);
  }
  // d[r]'s element i: weight column na + ((i >> 1) & 1), x row
  // 64 r + 8 (i >> 2) + 2 t4 + (i & 1); split z writes its own (M, N) slab
  float* o = out + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int m = m0 + kRows * r + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int n = na + ((i >> 1) & 1);
      if (m < M && n < N) o[(long long)m * N + n] = acc[r][i];
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

// bitserial_tc over (N / 128) x (M / 64 R) output tiles and `splits`
// slabs, its shared memory opted in once per device (0-63).
template <int NS, int R>
cudaError_t launch_tc(const Args& a, int splits, cudaStream_t s) {
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1)) {
    e = cudaFuncSetAttribute(bitserial_tc<NS, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tcb::kSmemBytes<R>);
    if (e != cudaSuccess) return e;
    opted |= 1ull << dev;
  }
  dim3 grid((a.N + tcb::kCols - 1) / tcb::kCols,
            (a.M + R * tcb::kRows - 1) / (R * tcb::kRows), splits);
  bitserial_tc<NS, R><<<grid, tcb::kThreads, tcb::kSmemBytes<R>, s>>>(
      a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
      a.swn, a.bits, a.seed, a.base_plane, a.np);
  return cudaGetLastError();
}

// rows: the tensor-core CTA's x rows, as planned (64 or 128)
template <int NS>
cudaError_t launch(const Args& a, bool kc, int splits, int rows,
                   cudaStream_t s) {
  if (a.M > kGemvMaxM)
    return rows > tcb::kRows ? launch_tc<NS, 2>(a, splits, s)
                             : launch_tc<NS, 1>(a, splits, s);
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
// any strides.  dims = {M, N, K, splits, k_slab, sxm, sxk, swk, swn, bits,
// rows} (one host array, so a ctypes call converts 10 arguments, not 20;
// rows: the tensor-core CTA's x rows above 16, 64 or 128, unread below).
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
  const int bits = (int)dims[9], rows = (int)dims[10];
  const bool kc = swn != 1;
  const bool gemv = M <= kGemvMaxM;
  const int mt = M <= 4 ? M : M <= 8 ? 8 : 16;     // the GEMV row template
  if (M < 1 || N < 1 || bits < 1 || bits > 24 ||
      !repro::split_plan_ok(K, splits, k_slab, gemv ? kGemvBK : tcb::kBK) ||
      (gemv && 4LL * mt * bits * k_slab > kGemvXBytes) ||
      (!gemv && rows != tcb::kRows && rows != 2 * tcb::kRows))
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
  cudaError_t err = np->n_states == 2 ? launch<2>(a, kc, splits, rows, s)
                                      : launch<0>(a, kc, splits, rows, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)M * N, splits, s));
}
