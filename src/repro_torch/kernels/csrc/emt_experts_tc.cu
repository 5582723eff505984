// K3's experts entry above 16 rows for Hopper (sm_90a), on the tensor
// cores: a stack of E experts' noisy products in one launch.
//
// Replaces the TPU kernel repro/kernels/emt_matmul.py::emt_matmul_pallas
// with its row base k0_base, as JAX's MoE layer draws the folded (E * K,
// N) stack (repro/models/moe.py _emt_stacked), where a stack has more
// than 16 rows an expert (the GEMV of emt_matmul.cu keeps M <= 16):
//   y[e] = x[e] @ (w[e] * f),  f = fl(1 + fl(a(e * K + k, n) * sigma)),
// the RTN offset hashed at expert e's element (k, n) as row e * K + k of
// the folded stack, with the step seed and the layer plane (no noise
// tensor in device memory; no FMA contraction in 1 + a * sigma or w * f),
// and the noisy stack's statistics sum |w~| and max |w~| from per-CTA
// partials over disjoint weight regions, reduced in a fixed order
// (common.cuh cta_stats' order, then stats_finish).
//
// What bounds it on the H100: the weight's bytes.  A MoE layer of
// jamba-v0.1-52b at a 128-token admission (E = 16, M = 20, K x N = 4,096 x
// 14,336 and back) streams 11.3 GB of float32 experts, 3.4 ms at 3.35
// TB/s, against 113 GFLOP of products (0.9 ms as four TF32 products on
// the tensor cores) and ~2.9 ms of the hash's integer ALU issue, which
// overlaps the stream.  So the design streams the weight at the memory's
// rate, hashes each element once a call, and pays for no rows that are
// not there.
//
// Design: the transposed product y[e]^T (N x M) = W~[e]^T (N x K) .
// x[e]^T (K x M) on wgmma, as K5's bitserial_tc (emt_bitserial.cu) does.
// * The weight streams through a ring of shared-memory stages (a k-tile
//   of 32 rows by the CTA's columns each) that one producer thread fills
//   with the tensor memory accelerator, 32 x 32 boxes in its 128-byte
//   swizzle, handed over by full and empty mbarriers; where the stack's
//   strides allow no tensor map, two producer warps copy it by cp.async.
//   (Each consumer copying its own pairs by cp.async, one warp's 512-byte
//   bulk copy a row, and two warps' 16-byte cp.async all streamed more
//   slowly: PERF.md.)
// * The noisy weight is wgmma's A operand, built in registers and never
//   stored: each consumer thread (64 weight columns a warpgroup, wgmma's 64
//   rows) reads its A-fragment elements of a k-tile from the stage into
//   registers and releases the stage, then hashes them (hash_mix_folded on
//   the pre-shifted row and column terms), forms w~ and splits it by
//   truncation into three TF32 pieces (hi, mid, lo: 11, 11 and 2
//   significant bits, disjoint, of w~'s sign), a k8 step at a time, the
//   steps' fragments in two alternating register sets, so one step is
//   built while the other's products run.
// * x's rows are wgmma's N, rounded up to a multiple of 8 (24 at M = 20):
//   two producer warps copy each k-tile of x by cp.async several k-tiles
//   ahead, split it into TF32 hi = rna(x) and lo = rna(x - hi) and store
//   both, K-major with the 128-byte swizzle, into a ring of shared-memory
//   stages handed over by full and empty mbarriers.
// * Four products a k8 step, x_lo.hi + x_hi.lo + x_hi.mid + x_hi.hi (K3's
//   forward, emt_matmul_fwd.cu, with the operands' roles swapped): on a
//   row of I every partial sum is exact, so the product is fluctuate(w)
//   bit for bit; elsewhere it is at least as accurate as 3xTF32.  Each
//   pair of k-tiles' products starts from zero and is added into an FP32
//   running sum rounded to nearest (the tensor cores' accumulation loses
//   low bits), as emt_tc.cuh does.
// * A CTA covers all of an expert's rows up to 64 (one row tile of NT =
//   24, 32, 48 or 64 rows), two 64-row tiles on the same A fragments up to
//   128, and later 128-row tiles of the grid above (which hash again); so
//   every weight element is hashed once a call wherever M <= 128.  Its
//   columns: 256 (four consumer warpgroups) up to 32 rows, where the
//   registers allow them (the issue of the hash sets the pace, and twice
//   the warps hide its latency better), 128 (two) above.
// * Grid: column tiles x row tiles x (experts x K slabs), z = e * splits +
//   slab as the host plans it (repro_torch/kernels/emt_matmul.py plan,
//   splitk.plan_waves: one CTA an SM); expert e reads its x rows and
//   weight at the Experts strides and writes its slab's (M, N) partial at
//   out + (slab * E + e) * M * N; repro::split_sum adds the slabs in slab
//   order.
// * Statistics: the CTAs of row tile 0 (each weight element is hashed
//   there once) sum |w~| (a float partial a k-tile, folded into float64)
//   and take its max over the elements each thread builds.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "emt_tc.cuh"

namespace {

using repro::Factors;
using repro::make_factors;

constexpr int kGemvMaxM = 16;    // above: this kernel (emt_matmul.cu below)
constexpr int kRowTile = 64;     // x rows a row tile, at most
constexpr int kMaxRowTiles = 2;  // R, the row tiles a CTA
constexpr int kBK = 32;          // k-tile (four k8 steps)
constexpr int kProducers = 128;  // warps 0-1 the weight, 2-3 x
constexpr int kWThreads = 64;
constexpr int kXThreads = kProducers - kWThreads;
// a weight stage: the k-tile's 32 rows of the CTA's columns as 32 x 32
// boxes (4 KB each, 128-byte rows) in the tensor memory accelerator's
// 128-byte swizzle: 16-byte chunk j of row r at chunk j ^ (r % 8)
constexpr int kWBox = 32;        // columns (and rows) a box

// The CTA of R row tiles of NT rows: its consumer warpgroups (64 weight
// columns each; four where one tile of at most 32 rows leaves them the
// registers, else two), its ring stages of x (whose raw copies land
// kXS - 2 k-tiles ahead) and of the weight, as many as the shared memory
// holds, and the registers setmaxnreg gives each role out of the 65,536
// spread over the threads at entry: a consumer holds R row tiles'
// products and promoted sums (R NT), two k8 steps' fragments (24), the
// k-tile's raw weight (16) and its rows' hash terms (8).
template <int R, int NT>
struct Geo {
  static constexpr int kCW = R == 1 && NT <= 32 ? 4 : 2;
  static constexpr int kCols = 64 * kCW;
  static constexpr int kConsumers = 128 * kCW;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kWStageBytes = kBK * kCols * 4;
  // one TF32 piece (hi or lo) of an x stage: R row tiles of NT rows of
  // 32 values (128 bytes); a stage holds hi, then lo
  static constexpr int kPieceBytes = R * NT * kBK * 4;
  static constexpr int kStageBytes = 2 * kPieceBytes;
  static constexpr int kXS = R == 2 ? 3 : NT <= 32 ? 8 : NT <= 48 ? 6 : 5;
  static constexpr int kWS = kCW == 4 ? 5 : R == 1 ? 8 : 6;
  // the x ring, the weight ring, and 1 KB to align the stages to the
  // swizzle pattern
  static constexpr int kSmemBytes =
      kXS * kStageBytes + kWS * kWStageBytes + 1024;
  static constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = kCW == 4 ? 56 : 64;
  static constexpr int kConsumerRegs =
      ((kCW + 1) * kEntryRegs - kProducerRegs) / kCW / 8 * 8;
  // the dynamic shared memory, the static mbarriers and the statistics'
  // slots within the 227 KB a CTA may have
  static_assert(kSmemBytes + 2 * (kXS + kWS) * 8 + kConsumers / 32 * 12 <=
                    227 * 1024,
                "shared memory");
  static_assert(kProducerRegs + kCW * kConsumerRegs <=
                    (kCW + 1) * kEntryRegs,
                "setmaxnreg moves registers, it does not add any");
};

// A fragments of one k8 step: piece (hi, mid, lo), register (wgmma's
// m64k8 TF32 A layout: registers 0-3 hold rows g, g + 8, g, g + 8 of the
// thread's warp's 16 rows at columns t, t, t + 4, t + 4)
using Frag = uint32_t[3][4];

// d (m64 x nNT, FP32) += A (registers) . B (shared memory, K-major,
// 128-byte swizzle), one k8 step of TF32 operands; d = A . B when
// !accumulate.  One overload a row count NT (d holds NT / 2 values).
__device__ __forceinline__ void wgmma_rs(float (&d)[12],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
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

// Keep the compiler from moving reads or writes of d across the
// asynchronous products' issue and wait.
template <int ND>
__device__ __forceinline__ void fence_acc(float (&d)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep a fragment's registers unchanged up to this point: wgmma reads its
// A registers asynchronously, until the wait that completes it.
__device__ __forceinline__ void keep(Frag& a) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[c][j]));
}

// The calling thread's arrival on b once its cp.async copies so far have
// completed (counted among b's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   repro::tc::smem_u32(b))
               : "memory");
}

// The calling thread's arrival on b, expecting `bytes` more bytes of
// asynchronous copies to complete in this phase.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          repro::tc::smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// The box of `map` at (c0, c1, c2) (innermost first) into dst by the
// tensor memory accelerator, completing its bytes on b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          repro::tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(repro::tc::smem_u32(b))
      : "memory");
}

// The float offset of weight element (row r, column c) of a k-tile in
// its stage (the boxes' swizzled layout).
__host__ __device__ constexpr int w_at(int r, int c) {
  return (c / kWBox) * (kWBox * kBK) + r * kWBox +
         ((((c % kWBox) / 4) ^ (r % 8)) << 2) + c % 4;
}

// The CTA's (sum, max) of |w~| over the consumers' shares, in a fixed
// order (a butterfly over the lanes, then the warps in order), at the
// CTA's slot (its linear index in the grid): common.cuh cta_stats over
// the kConsumersT consumer threads alone (the producers have left).
template <int kConsumersT>
__device__ __forceinline__ void consumer_stats(double s, float m,
                                               double* stats) {
  __shared__ double wsum[kConsumersT / 32];
  __shared__ float wmax[kConsumersT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    wsum[warp] = s;
    wmax[warp] = m;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumersT) : "memory");
  if (threadIdx.x == 0) {
    double t = wsum[0];
    float u = wmax[0];
    for (int v = 1; v < kConsumersT / 32; ++v) {
      t += wsum[v];
      u = fmaxf(u, wmax[v]);
    }
    const long long n = (long long)gridDim.x * gridDim.y * gridDim.z;
    const long long slot =
        blockIdx.x + (long long)gridDim.x * (blockIdx.y +
                                             (long long)gridDim.y * blockIdx.z);
    stats[slot] = t;
    stats[n + slot] = (double)u;
  }
}

// One CTA: Geo<R, NT>::kCols weight columns of expert e by R row tiles of
// NT x rows (NT a multiple of 8; NT = 64 where R = 2) over one K slab.
// Weight loader (producer warp 0): each k-tile's boxes by the tensor
// memory accelerator (the tensor map `wmap` of the (E, K, N) stack; zeros
// past K or N), where the stack's strides allow a tensor map (`tma`); else
// warps 0-1 copy it element by element with cp.async into the same
// layout.  "full" completes on the bytes (or the 64 threads' copies),
// "empty" when the consumers have read the stage.
// x producers (warps 2-3): each thread copies its 16-byte groups of x's
// R x NT rows of a k-tile by cp.async into their places in the hi piece
// of the k-tile's x stage, kXS - 2 k-tiles ahead, reads them back (its
// own copies: no barrier), splits them into TF32 hi and lo and stores
// both, K-major with the 128-byte swizzle (element (r, c) at float
// r * 32 + ((c / 4) ^ (r % 8)) * 4 + c % 4).
// Consumers (warpgroups 0 to kCW - 1): per k-tile, each thread's 16
// weight elements (rows k0 + 8 s + 4 h + t, s < 4, h < 2, of columns na
// and na + 1: the A rows g and g + 8 of its warp map to two adjacent
// columns) read from the weight stage into registers and the stage
// released; then per k8 step the step's 4 elements hashed and split and
// four wgmma on each of the R row tiles, the fragments of consecutive
// steps alternating between two register sets (one built while the
// other's products run).
template <int NS, int R, int NT>
__global__ void __launch_bounds__(Geo<R, NT>::kThreads, 1)
emt_experts_tc(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, const float* __restrict__ sig_ptr,
               int M, int N, int K, int k_slab, long long sxm, long long sxk,
               long long swk, uint32_t seed, uint32_t plane,
               repro::NoiseParams np, repro::Experts ex, int tma,
               const __grid_constant__ CUtensorMap wmap) {
  using repro::tc::bar_arrive;
  using repro::tc::bar_wait;
  using G = Geo<R, NT>;
  static_assert(NT % 8 == 0 && NT <= kRowTile && (R == 1 || NT == kRowTile),
                "row tiles");
  constexpr int kXS = G::kXS, kWS = G::kWS, kCols = G::kCols;
  constexpr int kConsumers = G::kConsumers;
  constexpr int kXAhead = kXS - 2;                 // x copies in flight
  constexpr int ND = NT / 2;                       // d's values a thread
  constexpr int kPieceFloats = G::kPieceBytes / 4;
  constexpr int kWStageFloats = G::kWStageBytes / 4;
  constexpr int kGroups = R * NT * (kBK / 4);      // float4 groups of x
  constexpr int kPG = (kGroups + kXThreads - 1) / kXThreads;
  extern __shared__ unsigned char smem_dyn[];
  __shared__ uint64_t x_full[kXS], x_empty[kXS], w_full[kWS], w_empty[kWS];
  const uint32_t pad =
      (1024 - (repro::tc::smem_u32(smem_dyn) & 1023)) & 1023;
  unsigned char* base = smem_dyn + pad;
  float* wbase = reinterpret_cast<float*>(base + kXS * G::kStageBytes);
  const int tid = threadIdx.x;
  const int splits = (K + k_slab - 1) / k_slab;
  const int ei = blockIdx.z / splits, zs = blockIdx.z % splits;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * R * kRowTile;
  const int kb = zs * k_slab, ke = min(K, kb + k_slab);
  const int nt = (ke - kb + kBK - 1) / kBK;
  x += ei * ex.sxe;
  w += ei * ex.swe;
  if (tid == 0) {
    for (int s = 0; s < kXS; ++s) {
      repro::tc::bar_init(&x_full[s], kXThreads);
      repro::tc::bar_init(&x_empty[s], kConsumers);
    }
    for (int s = 0; s < kWS; ++s) {
      repro::tc::bar_init(&w_full[s], tma ? 1 : kWThreads);
      repro::tc::bar_init(&w_empty[s], kConsumers);
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        G::kProducerRegs));
    const int pt = tid - kConsumers;
    if (pt < kWThreads) {                          // the weight loader(s)
      if (tma && pt == 0) {
        for (int t = 0; t < nt; ++t) {
          const int s = t % kWS;
          bar_wait(&w_empty[s], ((t / kWS) & 1) ^ 1);
          bar_arrive_tx(&w_full[s], G::kWStageBytes);
#pragma unroll
          for (int q = 0; q < kCols / kWBox; ++q)
            tma_load(wbase + s * kWStageFloats + q * kWBox * kBK, &wmap,
                     n0 + q * kWBox, kb + t * kBK, ei, &w_full[s]);
        }
      } else if (!tma) {
        for (int t = 0; t < nt; ++t) {
          const int s = t % kWS, k0 = kb + t * kBK;
          bar_wait(&w_empty[s], ((t / kWS) & 1) ^ 1);
          float* st = wbase + s * kWStageFloats;
          // element e: row e / kCols, column e % kCols (none past N or
          // the slab: the consumers mask them)
          for (int e = pt; e < kBK * kCols; e += kWThreads) {
            const int r = e / kCols, c = e % kCols;
            if (k0 + r < ke && n0 + c < N)
              repro::tc::cp_async4(st + w_at(r, c),
                                   w + (k0 + r) * swk + n0 + c, 4);
          }
          cp_async_arrive(&w_full[s]);
        }
      }
      return;
    }
    const int xt = pt - kWThreads;
    const bool xvec = sxk == 1 && sxm % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
    // group i: stage row r = (xt + 64 i) / 8 (x row m0 + 64 (r / NT) +
    // r % NT), columns 4 cg .. 4 cg + 3, cg = (xt + 64 i) % 8, at float
    // r * 32 + ((cg ^ (r % 8)) * 4) of a piece
    auto at = [&](int i, int& r, int& cg) {
      const int e = xt + kXThreads * i;
      r = e >> 3;
      cg = e & 7;
      return r * kBK + ((cg ^ (r & 7)) << 2);
    };
    // the raw groups of k-tile t (zeros past M or the slab) into the hi
    // piece of its stage, once the consumers have released it; one
    // commit group a k-tile (empty past the slab)
    auto copy_x = [&](int t) {
      if (t < nt) {
        const int s = t % kXS, k0 = kb + t * kBK;
        bar_wait(&x_empty[s], ((t / kXS) & 1) ^ 1);
        float* hi = reinterpret_cast<float*>(base + s * G::kStageBytes);
#pragma unroll
        for (int i = 0; i < kPG; ++i) {
          int r, cg;
          float* dst = hi + at(i, r, cg);
          if (xt + kXThreads * i >= kGroups) continue;
          const int m = m0 + kRowTile * (r / NT) + r % NT, k = k0 + 4 * cg;
          const float* p = x + m * sxm + k * sxk;
          if (m < M && xvec && k + 3 < ke) {
            repro::tc::cp_async16(dst, p, 16);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = m < M && k + j < ke;
              repro::tc::cp_async4(dst + j, ok ? p + j * sxk : x, ok ? 4 : 0);
            }
          }
        }
      }
      repro::tc::cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < kXAhead; ++t) copy_x(t);
    for (int t = 0; t < nt; ++t) {
      copy_x(t + kXAhead);
      repro::tc::cp_async_wait<kXAhead>();     // this thread's k-tile t
      const int s = t % kXS;
      float* hi = reinterpret_cast<float*>(base + s * G::kStageBytes);
#pragma unroll
      for (int i = 0; i < kPG; ++i) {
        int r, cg;
        const int off = at(i, r, cg);
        if (xt + kXThreads * i >= kGroups) continue;
        const float4 v = *reinterpret_cast<const float4*>(hi + off);
        float h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = repro::f4(v, j);
          h[j] = repro::tc::tf32_rna(a);
          l[j] = repro::tc::tf32_rna(__fsub_rn(a, h[j]));
        }
        *reinterpret_cast<float4*>(hi + off) =
            make_float4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<float4*>(hi + kPieceFloats + off) =
            make_float4(l[0], l[1], l[2], l[3]);
      }
      // the generic-proxy stores, made visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(&x_full[s]);
    }
    repro::tc::cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      G::kConsumerRegs));
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int nl = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * g;
  const int na = n0 + nl;
  Factors F;
  make_factors(np, *sig_ptr, F);
  const uint32_t row0 = (uint32_t)ei * (uint32_t)K;
  // the row (k) and column (n) hash terms, pre-shifted: element (k, n)'s
  // is prk ^ pcn
  const uint32_t pcn[2] = {repro::pre((uint32_t)na * 0x85EBCA6Bu),
                           repro::pre((uint32_t)(na + 1) * 0x85EBCA6Bu)};
  const uint32_t pks = repro::pre(repro::hash_pk(seed, plane));
  const bool ok0 = na < N, ok1 = na + 1 < N;
  const bool cols_full = n0 + kCols <= N;
  // the stage offsets of the thread's pairs: read u (0, 1) of k8 step s
  // is row 8 s + lrow[u], lrow[u] = t4 + 4 ((t4 >> 1) ^ u), so that the
  // four rows a warp reads at once fall on both halves of the swizzled
  // 128-byte rows (two wavefronts); its h is (t4 >> 1) ^ u
  int woff[2], lrow[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    lrow[u] = t4 + 4 * ((t4 >> 1) ^ u);
    woff[u] = w_at(lrow[u], nl);
  }
  const bool swap = (t4 >> 1) != 0;
  const bool stats = blockIdx.y == 0;
  double ssum = 0.0;
  float smax = 0.f;
  const uint32_t sbase = repro::tc::smem_u32(base);
  float acc[R][ND], d[R][ND];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = d[r][i] = 0.f;
  Frag a0 = {}, a1 = {};
  float wr[16];               // the k-tile's raw weight elements (2 r + c)
  uint32_t prk[8];            // their 8 rows' pre-shifted hash terms
  // k8 step s's fragments: register j holds column c = j & 1 at row
  // r = 2 s + (j >> 1); w~ = fl(w * f) in three truncated TF32 pieces
  // (hi + mid + lo == w~, each partial sum exact); and the |w~|
  // statistics (the k-tile's float partial `tsum`, folded into float64
  // once a k-tile)
  float tsum = 0.f;
  auto build = [&](Frag& a, int s) {
    float av[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 2 * s + (j >> 1), c = j & 1;
      const uint32_t h = repro::hash_mix_folded(prk[r] ^ pcn[c], pks);
      const float v = __fmul_rn(wr[2 * r + c], repro::factor<NS>(h, F));
      av[j] = fabsf(v);
      const float hi = repro::tc::tf32_trunc(v);
      const float rest = __fsub_rn(v, hi);
      const float mid = repro::tc::tf32_trunc(rest);
      a[0][j] = __float_as_uint(hi);
      a[1][j] = __float_as_uint(mid);
      a[2][j] = __float_as_uint(__fsub_rn(rest, mid));
    }
    if (stats) {
      tsum += (av[0] + av[1]) + (av[2] + av[3]);
      smax = fmaxf(smax, fmaxf(fmaxf(av[0], av[1]), fmaxf(av[2], av[3])));
    }
  };
  // step s's four products on each row tile of the x stage whose hi piece
  // starts at `hi` (k8 step s starts 32 bytes along the 128-byte rows; row
  // tile r NT rows further on; lo one piece further), one commit group;
  // d = the products when `fresh`, else d + them
  auto issue = [&](Frag& a, int s, uint32_t hi, bool fresh) {
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(d[r]);
    repro::tc::wgmma_fence();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t bh = hi + r * NT * kBK * 4 + 32 * s;
      const uint64_t dh = repro::tc::desc(bh);
      const uint64_t dl = repro::tc::desc(bh + G::kPieceBytes);
      wgmma_rs(d[r], a[0], dl, !fresh);    // x_lo . hi
      wgmma_rs(d[r], a[2], dh, 1);         // x_hi . lo
      wgmma_rs(d[r], a[1], dh, 1);         // x_hi . mid
      wgmma_rs(d[r], a[0], dh, 1);         // x_hi . hi
    }
    repro::tc::wgmma_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(d[r]);
  };
  // the completed products of a pair of k-tiles (or of the slab's last
  // one), added into the running sums with an FP32 add rounded to nearest
  auto promote = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) fence_acc(d[r]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] = __fadd_rn(acc[r][i], d[r][i]);
  };
  // an even k-tile waits for the pair before it and promotes it before its
  // first step's issue; an odd one waits for k-tile t - 1 after its first
  // step's issue; every later step waits for the step before it
  for (int t = 0; t < nt; ++t) {
    const int k0 = kb + t * kBK, xs = t % kXS, ws = t % kWS;
    const bool even = (t & 1) == 0;
    bar_wait(&w_full[ws], (t / kWS) & 1);
    const float* st = wbase + ws * kWStageFloats;
    // past the slab or N (the stage holds stale or other rows there): 0
    const bool edge = k0 + kBK > ke || !cols_full;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float2 v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        v[u] = *reinterpret_cast<const float2*>(st + woff[u] + 8 * s * kWBox);
      if (edge) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool k_ok = k0 + 8 * s + lrow[u] < ke;
          v[u] = make_float2(k_ok && ok0 ? v[u].x : 0.f,
                             k_ok && ok1 ? v[u].y : 0.f);
        }
      }
      // rows r = 2 s + h: h = 0 is read u = t4 >> 1
      const float2 v0 = swap ? v[1] : v[0], v1 = swap ? v[0] : v[1];
      wr[4 * s] = v0.x;
      wr[4 * s + 1] = v0.y;
      wr[4 * s + 2] = v1.x;
      wr[4 * s + 3] = v1.y;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        prk[2 * s + h] = repro::pre(
            (row0 + (uint32_t)(k0 + 8 * s + 4 * h + t4)) * 0x9E3779B9u);
    }
    bar_arrive(&w_empty[ws]);
    const uint32_t hi = sbase + xs * G::kStageBytes;
    build(a0, 0);
    if (even && t > 0) {
      repro::tc::wgmma_wait<0>();     // the pair before
      keep(a1);
      promote();
      bar_arrive(&x_empty[(t - 1) % kXS]);
    }
    bar_wait(&x_full[xs], (t / kXS) & 1);
    issue(a0, 0, hi, even);
    if (!even) {
      repro::tc::wgmma_wait<1>();     // k-tile t - 1
      keep(a1);
      bar_arrive(&x_empty[(t - 1) % kXS]);
    }
    build(a1, 1);
    issue(a1, 1, hi, false);
    repro::tc::wgmma_wait<1>();       // step 0
    keep(a0);
    build(a0, 2);
    issue(a0, 2, hi, false);
    repro::tc::wgmma_wait<1>();       // step 1
    keep(a1);
    build(a1, 3);
    issue(a1, 3, hi, false);
    repro::tc::wgmma_wait<1>();       // step 2
    keep(a0);
    if (stats) {
      ssum += (double)tsum;
      tsum = 0.f;
    }
  }
  if (nt > 0) {                       // the last pair
    repro::tc::wgmma_wait<0>();
    keep(a1);
    promote();
  }
  // acc[r]'s element i: weight column na + ((i >> 1) & 1), x row
  // m0 + 64 r + 8 (i >> 2) + 2 t4 + (i & 1); slab zs of expert ei
  const int n_ex = gridDim.z / splits;
  float* o = out + ((long long)zs * n_ex + ei) * M * N;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int m = m0 + kRowTile * r + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int n = na + ((i >> 1) & 1);
      if (m < M && n < N) o[(long long)m * N + n] = acc[r][i];
    }
  consumer_stats<kConsumers>(ssum, smax, ex.stats);
}

struct Args {
  const float* x;
  const float* w;
  float* out;
  const float* sig;
  int M, N, K, k_slab;
  long long sxm, sxk, swk;
  uint32_t seed, plane;
  repro::NoiseParams np;
  int E;
  repro::Experts ex;
  int tma;                  // the weight by the tensor map `wmap`
  CUtensorMap wmap;
};

// The CTA's row tiles (R) and rows a tile (NT) at M rows: one tile of M
// rounded up to 24, 32, 48 or 64 up to 64 rows, two of 64 above; and its
// weight columns (256 up to 32 rows, else 128: Geo's kCols).
__host__ __device__ constexpr int row_tiles(int M) {
  return M <= kRowTile ? 1 : kMaxRowTiles;
}
__host__ __device__ constexpr int tile_rows(int M) {
  return M <= 24 ? 24 : M <= 32 ? 32 : M <= 48 ? 48 : kRowTile;
}
constexpr int cta_cols(int M) { return M <= 32 ? 256 : 128; }
static_assert(cta_cols(24) == Geo<1, 24>::kCols &&
                  cta_cols(32) == Geo<1, 32>::kCols &&
                  cta_cols(48) == Geo<1, 48>::kCols &&
                  cta_cols(64) == Geo<1, 64>::kCols &&
                  cta_cols(65) == Geo<2, 64>::kCols,
              "the CTA's columns");

// emt_experts_tc<NS, R, NT> over (N / kCols) x (M / 64 R) x (E x splits),
// its shared memory opted in once per device (0-63).
template <int NS, int R, int NT>
cudaError_t launch_tc(const Args& a, int splits, cudaStream_t s) {
  static unsigned long long opted = 0;
  const auto kernel = emt_experts_tc<NS, R, NT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geo<R, NT>::kSmemBytes);
    if (e != cudaSuccess) return e;
    opted |= 1ull << dev;
  }
  constexpr int kCols = Geo<R, NT>::kCols;
  dim3 grid((a.N + kCols - 1) / kCols,
            (a.M + R * kRowTile - 1) / (R * kRowTile), splits * a.E);
  kernel<<<grid, Geo<R, NT>::kThreads, Geo<R, NT>::kSmemBytes, s>>>(
      a.x, a.w, a.out, a.sig, a.M, a.N, a.K, a.k_slab, a.sxm, a.sxk, a.swk,
      a.seed, a.plane, a.np, a.ex, a.tma, a.wmap);
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch(const Args& a, int splits, cudaStream_t s) {
  if (row_tiles(a.M) > 1) return launch_tc<NS, 2, kRowTile>(a, splits, s);
  switch (tile_rows(a.M)) {
    case 24: return launch_tc<NS, 1, 24>(a, splits, s);
    case 32: return launch_tc<NS, 1, 32>(a, splits, s);
    case 48: return launch_tc<NS, 1, 48>(a, splits, s);
    default: return launch_tc<NS, 1, kRowTile>(a, splits, s);
  }
}

// cuTensorMapEncodeTiled, from the driver (no link to it), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of the (E, K, N) weight stack w (n-major, rows swk and
// experts swe floats apart), 32 x 32 boxes in the 128-byte swizzle, zeros
// past its edges; false where the strides or the alignment allow none
// (rows or experts not 16-byte multiples apart, w not 16-byte aligned).
bool weight_map(CUtensorMap* map, const float* w, int E, int K, int N,
                long long swk, long long swe) {
  const EncodeTiled encode = encode_tiled();
  const long long sk = 4 * swk, se = E > 1 ? 4 * swe : 4 * swk * K;
  if (!encode || reinterpret_cast<uintptr_t>(w) % 16 != 0 || sk % 16 != 0 ||
      se % 16 != 0 || swk < N || (E > 1 && swe < swk * K))
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)sk, (cuuint64_t)se};
  const cuuint32_t box[3] = {kWBox, kBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// A stack of E experts above 16 rows: y (E, M, N) = x (E, M, K) @
// noisy(w (E, K, N)) per expert, expert e's element (k, n) hashed at row
// e * K + k; x of any strides, w n-major (swn == 1).  dims = {M, N, K,
// splits, k_slab, sxm, sxk, swk, swn, E, sxe, swe, slots}, as
// emt_matmul.cu's emt_matmul_experts_f32 takes them (M <= 16 there): the
// plan is emt_matmul.py::plan's for the experts entry (256 weight
// columns a CTA up to 32 rows, 128 above; x rows in tiles of 64 or 128, K
// in whole 32-row k-tiles); `part` holds splits * E * M * N floats,
// `parts` 2 * slots float64 values, slots being the grid's CTAs
// (checked), and `stats` receives {sum |w~|, max |w~|} of the noisy stack.
extern "C" int emt_matmul_experts_tc_f32(const float* x, const float* w,
                                         float* y, float* part,
                                         double* parts, float* stats,
                                         const float* sig,
                                         const long long* dims,
                                         unsigned int seed,
                                         unsigned int plane,
                                         const repro::NoiseParams* np,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], N = (int)dims[1], K = (int)dims[2];
  const int splits = (int)dims[3], k_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], swk = dims[7], swn = dims[8];
  const long long E = dims[9], slots = dims[12];
  const int R = row_tiles(M);
  const int cols = cta_cols(M);
  const long long ctas = (long long)((N + cols - 1) / cols) *
                         ((M + R * kRowTile - 1) / (R * kRowTile)) * splits *
                         E;
  if (M <= kGemvMaxM || N < 1 || swn != 1 || E < 1 ||
      (long long)splits * E > 65535 || slots != ctas ||
      !repro::split_plan_ok(K, splits, k_slab, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, splits > 1 ? part : y, sig, M, N, K, k_slab, sxm, sxk, swk,
         seed, plane, *np, (int)E, repro::Experts{dims[10], dims[11], parts},
         0, CUtensorMap{}};
  a.tma = weight_map(&a.wmap, w, (int)E, K, N, swk, dims[11]);
  cudaError_t err = np->n_states == 2 ? launch<2>(a, splits, s)
                                      : launch<0>(a, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    err = repro::split_sum(part, y, E * M * N, splits, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kFinish = 256;
  repro::stats_finish<kFinish><<<1, kFinish, 0, s>>>(parts, slots, stats);
  return static_cast<int>(cudaGetLastError());
}
