// A 3xTF32 GEMM template for Hopper's tensor cores (sm_90a) whose operand
// and epilogue stages take the noise; K3's backward kernels
// (emt_matmul_bwd.cu) and K3's forward at M > 16 (emt_matmul_fwd.cu) are
// its users.
//
// out tile (128 x 128) = A (rows x R) . B (cols x R)^T, both operands
// reduced along their second index c, each read with any strides
// (Operand), B also as int8 levels dequantized by a per-row scale.  A CTA
// computes one output tile over one slab of the reduction (the host's
// plan, repro_torch/kernels/splitk.py plan_waves; slab z of a split
// writes its own partial tile); gemm_3xtf32_experts runs a stack of such
// products, one an expert along the grid's y.  Warp-specialized, four
// warpgroups:
//
// * Producers (warpgroups 2-3, 256 threads): each thread owns four 4-wide
//   reduction groups of A and four of B in every 32-deep k-tile.  It copies
//   their raw FP32 values by cp.async into its own slots of a ring of raw
//   stages (16-byte copies along whichever stride is 1, else 4-byte
//   copies coalesced along the rows; zeros past the tensor or the slab),
//   a tile or two ahead, and reads back only what it copied, so the ring
//   needs no barrier (int8 levels of B are loaded into registers a tile
//   ahead instead, 4 a load).  The transform applies the stage's operand
//   function (the noisy weight w * f at w's logical (k, n), from a per-row
//   word the stage hands it a tile ahead), splits each value into TF32
//   pieces and stores them K-major in the 128-byte swizzled layout wgmma
//   reads (the only layout `.tf32` allows: its transpose flags exist for
//   16-bit types only), so operands lying MN-major in memory (the n-major
//   projections' w and the tied unembed's table.T in the forward, both
//   operands of dw = x^T g) are transposed on the way in.  A splits into
//   hi = rna(x) and lo = rna(x - hi); B the same (kBPieces 2) or, where the
//   stage asks for 3 pieces, by truncation into hi (the top 11 significant
//   bits), mid (the next 11) and lo (the last 2): disjoint bits of one
//   sign, so every partial sum of them is exact in FP32 and no larger than
//   the value.  Two such split stages (64 KB each with 2 pieces of B, 80
//   KB with 3), handed over by mbarriers: "full" when the 256 producers
//   have stored a stage, "empty" when the 256 consumers' products that
//   read it have completed.
// * Consumers (warpgroups 0-1, 64 output rows each): per 8-deep k-step
//   three wgmma.m64n128k8.f32.tf32 (lo.hi, hi.lo, hi.hi), or with B in
//   three pieces four (lo.hi, hi.lo, hi.mid, hi.hi): on x = I that sum is
//   hi + mid + lo, the value itself, where 3xTF32's hi + lo is not (a
//   residual of up to 13 significant bits in an 11-bit piece).  Each pair
//   of k-tiles' sum starts from zero and is added into the running sum
//   with an FP32 add rounded to nearest: the tensor cores' own
//   accumulation loses low bits (without this promotion the tied
//   unembed's dx, 262,144 terms, was 1.6e-4 from float64 on an H100 80GB
//   HBM3 at 700 W; with it, 7e-7).  Then the stage's epilogue (store a
//   tile or a slab's partial tile, or K3-dw's noise epilogue); no atomics
//   anywhere.
//
// Bounds on an H100 SXM: 3 (or 4) x 2 MNR FLOPs over the tensor cores'
// 495 TFLOP/s TF32 rate, and the operands' path to them: a k-tile moves
// 272 KB through shared memory (the raw ring 64 KB, the split stores 64
// KB, the products' reads 144 KB; with B in three pieces 336 KB).  What
// sets the pace at gemma3-1b's shapes is the producers' transform (timed
// variants, PERF.md): without it the consumers run a k-tile in ~1.2 us,
// with it ~2.3 us.  One CTA per SM (225 KB of shared memory: three raw
// stages with B in two pieces, two with B in three; setmaxnreg gives the
// consumers' 128 FP32 accumulators their registers).
#pragma once
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace tc {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kConsumers = 256, kProducers = 256;
constexpr int kThreads = kConsumers + kProducers;
// stages of split operands (A hi, A lo, then B's pieces: 64 or 80 KB)
constexpr int kStages = 2;
constexpr int kTileFloats = kBM * kBK;           // one operand tile, 16 KB
constexpr int kTileBytes = 4 * kTileFloats;
// stages of raw operands (A, B: 32 KB) beside the split stages of B in P
// pieces: three with 2 pieces, two with 3 (a third raw stage would take
// the 3-piece layout to 257 KB)
template <int P>
__host__ __device__ constexpr int raw_stages() {
  return P == 2 ? 3 : 2;
}
template <int P>
__host__ __device__ constexpr int smem_bytes() {
  // 1 KB to align the swizzled tiles to the 1024-byte atom the
  // descriptors assume
  return (kStages * (2 + P) + raw_stages<P>() * 2) * kTileBytes + 1024;
}
constexpr int kSmemBytes = smem_bytes<2>();
static_assert(smem_bytes<3>() == kSmemBytes, "one CTA per SM either way");
// registers a thread: consumers and producers share 2 x 128 after
// setmaxnreg (the stage's kConsumerRegs to the consumers, which hold 128
// accumulators)
constexpr int kRegPair = 2 * 65536 / kThreads;
// the per-thread groups of one operand tile: 128 rows x 8 groups of 4
constexpr int kGroups = kTileFloats / 4 / kProducers;

static_assert(kBM == kBN, "A and B tiles share one shape");

// B's pieces of a stage: its kBPieces (3: hi/mid/lo by truncation) where
// it declares one, else 2 (rna hi/lo).
template <class S, class = void>
struct BPieces : std::integral_constant<int, 2> {};
template <class S>
struct BPieces<S, std::void_t<decltype(S::kBPieces)>>
    : std::integral_constant<int, S::kBPieces> {};

// Whether A ends in the first half of every row tile (a stage's
// kHalfRows, set only where the host guarantees M <= 64): then the second
// consumer warpgroup multiplies nothing and the producers neither copy nor
// transform A's second half.  Else false.
template <class S, class = void>
struct HalfRows : std::false_type {};
template <class S>
struct HalfRows<S, std::void_t<decltype(S::kHalfRows)>>
    : std::integral_constant<bool, S::kHalfRows> {};

// Element (r, c) at p[r * s_row + c * s_red], r < rows the output index
// (A: the output row, B: the output column), c the reduction index.
// mode: how the producers copy it (kScalar, kAlongC, kAlongR), with kInt8
// set for int8 levels (B only: p then points at the levels, strides in
// bytes, and the stage's b_scale(r) dequantizes row r).
struct Operand {
  const float* p;
  long long s_row, s_red;
  int rows;
  int mode;
};

// kAlongC: s_red == 1 and the rows 16-byte aligned (16-byte copies along
// c); kAlongR: s_row == 1 and the columns aligned (16-byte copies along r);
// kScalar: any strides (4-byte copies).  With kInt8 the same layouts with
// 4-byte aligned rows or columns (4-level loads), or any strides (bytes).
constexpr int kScalar = 0, kAlongC = 1, kAlongR = 2, kInt8 = 4;
constexpr int kQScalar = kInt8 | kScalar, kQAlongC = kInt8 | kAlongC,
              kQAlongR = kInt8 | kAlongR;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(smem_u32(b))
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// -- the producers' copies and transform ------------------------------------
// Group i of producer thread `pt`: row r and reduction group cg (columns
// 4 cg .. 4 cg + 3) of the 128 x 32 tile.  kAlongC: eight threads along
// one row's 128 bytes.  kAlongR: the thread owns the 4 x 4 block of rows
// 4 rb .. 4 rb + 3, its group i the block's row i; eight threads of one
// rb take the eight cg, four rb a warp.  kScalar: 32 threads along 32
// rows.  Under each, eight consecutive threads store their group's 16
// bytes to eight distinct bank groups of the swizzled tile.
template <int LM>
__device__ __forceinline__ void group_of(int pt, int i, int& r, int& cg) {
  if constexpr (LM == kAlongR) {
    const int lane = pt & 31;
    r = 4 * (4 * (pt >> 5) + (lane >> 3)) + i;
    cg = lane & 7;
  } else {
    const int e = pt + kProducers * i;
    r = LM == kAlongC ? e / (kBK / 4) : e % kBM;
    cg = LM == kAlongC ? e % (kBK / 4) : e / kBM;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the raw values of the thread's groups of the tile at rows r0..,
// reduction columns c0.. (zeros at r >= rows or c >= ce; none at tile rows
// >= kLive, which no product reads) into its own slots of a raw stage,
// thread index fastest (conflict-free): float4 (i, pt) for 16-byte copies
// (kAlongR: copy i holds column 4 cg + i of the block), float (i, j, pt)
// otherwise.  Each producer reads back only what it copied, so no barrier
// guards the raw ring.
template <int LM, int kLive = kBM>
__device__ __forceinline__ void copy_groups(float* raw, const Operand& o,
                                            int r0, int c0, int ce, int pt) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    int r, cg;
    group_of<LM>(pt, i, r, cg);
    if (kLive < kBM && r >= kLive) continue;
    if (LM == kAlongR) {
      // copy i: the block's column c0 + 4 cg + i, its rows from r0 + r - i
      const int br = r0 + r - i, bc = c0 + 4 * cg + i;
      const int valid = bc < ce ? min(max(o.rows - br, 0), 4) : 0;
      cp_async16(raw + 4 * (i * kProducers + pt),
                 valid ? o.p + br + bc * o.s_red : o.p, 4 * valid);
      continue;
    }
    const int gr = r0 + r, gc = c0 + 4 * cg;
    const float* p = o.p + gr * o.s_row + gc * o.s_red;
    if (LM == kAlongC) {
      const int valid = gr < o.rows ? min(max(ce - gc, 0), 4) : 0;
      cp_async16(raw + 4 * (i * kProducers + pt), valid ? p : o.p, 4 * valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < o.rows && gc + j < ce;
        cp_async4(raw + (4 * i + j) * kProducers + pt,
                  ok ? p + j * o.s_red : o.p, ok ? 4 : 0);
      }
    }
  }
}

template <int LM>
__device__ __forceinline__ void read_groups(float (&v)[kGroups][4],
                                            const float* raw, int pt) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    if (LM != kScalar) {
      const float4 q =
          *reinterpret_cast<const float4*>(raw + 4 * (i * kProducers + pt));
      if (LM == kAlongC) {
        v[i][0] = q.x;
        v[i][1] = q.y;
        v[i][2] = q.z;
        v[i][3] = q.w;
      } else {  // q is the block's column i, transposed into its rows
        v[0][i] = q.x;
        v[1][i] = q.y;
        v[2][i] = q.z;
        v[3][i] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = raw[(4 * i + j) * kProducers + pt];
    }
  }
}

// -- int8 levels (B only) ---------------------------------------------------
// p[0], p[step], p[2 step], p[3 step] (0 past `valid`) as one word, level
// j in byte j: one 4-byte load when `vec` and all four are valid.
__device__ __forceinline__ uint32_t load_q4(const int8_t* p, long long step,
                                            int valid, bool vec) {
  if (vec && valid == 4)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) v |= (uint32_t)(uint8_t)__ldg(p + j * step) << (8 * j);
  return v;
}

// The levels of the thread's groups of the tile at rows r0.., reduction
// columns c0.. (zeros at r >= rows or c >= ce): word i holds group i's
// four (LM kAlongC, kScalar) or, under kAlongR, the thread's 4 x 4 block's
// column i (its four rows, one load along r).
template <int LM>
__device__ __forceinline__ void load_levels(uint32_t (&q)[kGroups],
                                            const Operand& o, int r0, int c0,
                                            int ce, int pt) {
  const int8_t* p = reinterpret_cast<const int8_t*>(o.p);
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    int r, cg;
    group_of<LM>(pt, i, r, cg);
    if (LM == kAlongR) {
      const int br = r0 + r - i, bc = c0 + 4 * cg + i;
      const int valid = bc < ce ? min(max(o.rows - br, 0), 4) : 0;
      q[i] = load_q4(valid ? p + br + bc * o.s_red : p, 1, valid, true);
    } else {
      const int gr = r0 + r, gc = c0 + 4 * cg;
      const int valid = gr < o.rows ? min(max(ce - gc, 0), 4) : 0;
      q[i] = load_q4(valid ? p + gr * o.s_row + gc * o.s_red : p, o.s_red,
                     valid, LM == kAlongC);
    }
  }
}

// The dequantized groups fl(float(q) * scale) (sc[i]: group i's row's
// scale), as read_groups lays out raw values.
template <int LM>
__device__ __forceinline__ void dequant_groups(float (&v)[kGroups][4],
                                               const uint32_t (&q)[kGroups],
                                               const float (&sc)[kGroups]) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[i][j] = LM == kAlongR ? repro::dequant(q[j], i, sc[i])
                              : repro::dequant(q[i], j, sc[i]);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x truncated to TF32: its top 11 significant bits (the low 13 of the
// FP32 significand cleared).
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// The thread's groups -> the operand's P piece tiles (piece p at
// t + p * kTileFloats), K-major with the 128-byte swizzle: element (r, c)
// at float r * 32 + ((c / 4) ^ (r % 8)) * 4 + c % 4 (eight consecutive
// threads store to eight distinct 16-byte bank groups under each
// mapping).  P = 2: hi = rna(x) and lo = rna(x - hi); P = 3: hi, mid and
// lo by truncation (hi + mid + lo == x, each partial sum exact).  OP
// selects the stage's operand function (0: A, 1: B), applied at the
// element's global (row, reduction) index.  Groups at tile rows >= kLive
// are not stored.
template <int LM, int OP, int P, int kLive = kBM, class Stage>
__device__ __forceinline__ void store_groups(const float (&v)[kGroups][4],
                                             float* t, int r0, int c0, int pt,
                                             const Stage& st,
                                             const uint32_t (&aux)[kGroups]) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    int r, cg;
    group_of<LM>(pt, i, r, cg);
    if (kLive < kBM && r >= kLive) continue;
    const int off = r * kBK + ((cg ^ (r & 7)) << 2);
    if constexpr (P == 2) {
      float h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * cg + j;
        const float x = OP == 0 ? st.a(v[i][j], r0 + r, c)
                                : st.b(v[i][j], r0 + r, c, aux[i]);
        h[j] = tf32_rna(x);
        l[j] = tf32_rna(__fsub_rn(x, h[j]));
      }
      *reinterpret_cast<float4*>(t + off) =
          make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(t + kTileFloats + off) =
          make_float4(l[0], l[1], l[2], l[3]);
    } else {
      float h[4], m[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * cg + j;
        const float x = OP == 0 ? st.a(v[i][j], r0 + r, c)
                                : st.b(v[i][j], r0 + r, c, aux[i]);
        h[j] = tf32_trunc(x);
        const float rest = __fsub_rn(x, h[j]);
        m[j] = tf32_trunc(rest);
        l[j] = __fsub_rn(rest, m[j]);
      }
      *reinterpret_cast<float4*>(t + off) =
          make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(t + kTileFloats + off) =
          make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(t + 2 * kTileFloats + off) =
          make_float4(l[0], l[1], l[2], l[3]);
    }
  }
}

// -- the consumers' products ------------------------------------------------
// The shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), the leading offset unused
// by this layout (1), start address >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n128, FP32) = A . B^T (+ d if accumulate), one 8-deep k-step
// of TF32 operands from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The accumulator's element i of consumer thread `tid`: row (within the
// 128-row tile) and column (within the 128 columns), wgmma's m64nNk8 D
// layout with warpgroup w on rows 64 w ...
__device__ __forceinline__ int acc_row(int tid, int i) {
  return 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

// Synchronize the 256 consumer threads (named barrier 1; barrier 0 is
// __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A CTA's work item: one output tile over one slab z of the reduction.
// Items are numbered slab-major (blockIdx.x), and within a slab a_fast
// walks A's row tiles fastest (CTAs launched together share a B tile),
// else B's.
struct TileIdx {
  int m0, n0, index, z;  // index: the tile's row-major place in the grid
};

__device__ __forceinline__ TileIdx tile_idx(int item, int tm, int tn,
                                            int a_fast) {
  const int z = item / (tm * tn), rest = item % (tm * tn);
  const int mt = a_fast ? rest % tm : rest / tn;
  const int nt = a_fast ? rest / tm : rest % tn;
  return TileIdx{mt * kBM, nt * kBN, mt * tn + nt, z};
}

// int8 levels of B in flight a tile ahead (q: tile t, qn: tile t + 1) and
// each group's row's scale; nothing for float operands.
template <bool Q8>
struct Levels {};
template <>
struct Levels<true> {
  uint32_t q[kGroups] = {}, qn[kGroups] = {};
  float sc[kGroups] = {};
};

// Stage: constructed in the kernel from its Args; kConsumerRegs, the
// consumers' registers (a multiple of 8; the producers get the rest of
// kRegPair); kBPieces and kHalfRows, optional (BPieces, HalfRows);
// a(v, r, c) and
// b(v, r, c, aux) the operand functions, aux = b_aux(r, c0) the stage's
// word for B's row r in the k-tile at c0 (loaded by the producers a tile
// ahead); b_scale(r), for int8 levels of B only, row r's scale;
// epilogue(acc, tile, tid) consumes the 128 x 128 tile with consumer
// thread tid's accumulators.  AM / BM: the operands' copy modes
// (Operand::mode; kInt8 for B only).  The body of every kernel on the
// template (each user names its own __global__, so a profile tells them
// apart).
template <int AM, int BM, class Stage>
__device__ __forceinline__ void gemm_body(const Operand& A, const Operand& B,
                                          int R, int k_slab, int a_fast,
                                          const typename Stage::Args& args) {
  constexpr int P = BPieces<Stage>::value;
  constexpr int kRaw = raw_stages<P>();
  constexpr int BL = BM & ~kInt8;                 // B's layout
  constexpr bool Q8 = (BM & kInt8) != 0;
  constexpr int kLive = HalfRows<Stage>::value ? kBM / 2 : kBM;
  static_assert(!(AM & kInt8), "A is float32");
  extern __shared__ unsigned char smem_dyn[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const uint32_t pad = (1024 - (smem_u32(smem_dyn) & 1023)) & 1023;
  float* base = reinterpret_cast<float*>(smem_dyn + pad);
  const int tid = threadIdx.x;
  const int tm = (A.rows + kBM - 1) / kBM, tn = (B.rows + kBN - 1) / kBN;
  const TileIdx ti = tile_idx(blockIdx.x, tm, tn, a_fast);
  const int kb = ti.z * k_slab, ke = min(R, kb + k_slab);
  const int nt = (ke - kb + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], kProducers);
      bar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();
  const Stage st(args);

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kRegPair - Stage::kConsumerRegs));
    const int pt = tid - kConsumers;
    float* raw = base + kStages * (2 + P) * kTileFloats;
    // raw stage u: A's values at raw + 2 u kTileFloats, B's after them
    // (unused for int8 levels, which load_levels brings into registers)
    auto copy = [&](int t) {
      float* r = raw + 2 * (t % kRaw) * kTileFloats;
      if (t < nt) {
        copy_groups<AM, kLive>(r, A, ti.m0, kb + t * kBK, ke, pt);
        if constexpr (!Q8)
          copy_groups<BL>(r + kTileFloats, B, ti.n0, kb + t * kBK, ke, pt);
      }
      cp_async_commit();
    };
    // the stage's word for each B group's row at tile t (the weight's
    // noise-state bits), loaded a tile ahead
    auto load_aux = [&](int t, uint32_t (&x)[kGroups]) {
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        int r, cg;
        group_of<BL>(pt, i, r, cg);
        x[i] = t < nt ? st.b_aux(ti.n0 + r, kb + t * kBK) : 0u;
      }
    };
    Levels<Q8> lv;
    if constexpr (Q8) {
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        int r, cg;
        group_of<BL>(pt, i, r, cg);
        lv.sc[i] = ti.n0 + r < B.rows ? st.b_scale(ti.n0 + r) : 0.f;
      }
      if (nt > 0) load_levels<BL>(lv.q, B, ti.n0, kb, ke, pt);
    }
    uint32_t aux[kGroups];
    load_aux(0, aux);
#pragma unroll
    for (int t = 0; t < kRaw - 1; ++t) copy(t);
    for (int t = 0; t < nt; ++t) {
      const int s = t % kStages, c0 = kb + t * kBK;
      copy(t + kRaw - 1);               // into the stage read at t - 1
      uint32_t next[kGroups];
      load_aux(t + 1, next);
      if constexpr (Q8)
        if (t + 1 < nt)
          load_levels<BL>(lv.qn, B, ti.n0, c0 + kBK, ke, pt);
      cp_async_wait<kRaw - 1>();        // this thread's copies of tile t
      float va[kGroups][4], vb[kGroups][4];
      const float* r = raw + 2 * (t % kRaw) * kTileFloats;
      read_groups<AM>(va, r, pt);
      if constexpr (Q8)
        dequant_groups<BL>(vb, lv.q, lv.sc);
      else
        read_groups<BL>(vb, r + kTileFloats, pt);
      bar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      float* sp = base + (2 + P) * s * kTileFloats;
      store_groups<AM, 0, 2, kLive>(va, sp, ti.m0, c0, pt, st, aux);
      store_groups<BL, 1, P>(vb, sp + 2 * kTileFloats, ti.n0, c0, pt, st,
                             aux);
      // the generic-proxy stores, made visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(&full[s]);
#pragma unroll
      for (int i = 0; i < kGroups; ++i) aux[i] = next[i];
      if constexpr (Q8)
#pragma unroll
        for (int i = 0; i < kGroups; ++i) lv.q[i] = lv.qn[i];
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Stage::kConsumerRegs));
    float acc[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
    const uint32_t a_off = (tid >> 7) * 64 * kBK * 4;  // this warpgroup's rows
    // the second warpgroup's rows all past A (uniform in the warpgroup)
    const bool idle = kLive < kBM && (tid >> 7);
    const uint32_t sbase = smem_u32(base);
    // one k-tile's products (12, or 16 with B in three pieces) on stage
    // t % kStages into d (from zero if `fresh`), committed as one group
    auto mma = [&](int t, bool fresh) {
      const int s = t % kStages;
      bar_wait(&full[s], (t / kStages) & 1);
      const uint32_t sp = sbase + (2 + P) * s * kTileBytes;
      const uint32_t a_hi = sp + a_off, a_lo = a_hi + kTileBytes;
      // B's pieces: hi, then lo (P = 2) or mid, lo (P = 3)
      const uint32_t b_hi = sp + 2 * kTileBytes, b_1 = b_hi + kTileBytes;
      const uint32_t b_lo = P == 2 ? b_1 : b_1 + kTileBytes;
      fence_regs(d);
      if (!idle) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint32_t o = 32 * kk;     // 8 TF32 values = 32 bytes
          wgmma_tf32(d, desc(a_lo + o), desc(b_hi + o), !fresh || kk > 0);
          wgmma_tf32(d, desc(a_hi + o), desc(b_lo + o), 1);
          if constexpr (P == 3)
            wgmma_tf32(d, desc(a_hi + o), desc(b_1 + o), 1);
          wgmma_tf32(d, desc(a_hi + o), desc(b_hi + o), 1);
        }
      }
      wgmma_commit();
    };
    // k-tiles in pairs: the second's products queue behind the first's,
    // whose stage is released as soon as they complete; the pair's sum
    // (24 or 32 products a k-step column) is added into acc once both have
    for (int t = 0; t < nt; t += 2) {
      const bool two = t + 1 < nt;
      mma(t, true);
      if (two) {
        mma(t + 1, false);
        wgmma_wait<1>();
        bar_arrive(&empty[t % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(d);
      bar_arrive(&empty[(t + two) % kStages]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
    }
    st.epilogue(acc, ti, tid);
  }
}

// K3's backward kernels (emt_matmul_bwd.cu).
template <int AM, int BM, class Stage>
__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32(const Operand A, const Operand B, int R, int k_slab, int a_fast,
            const typename Stage::Args args) {
  gemm_body<AM, BM, Stage>(A, B, R, k_slab, a_fast, args);
}

// K3's backward over a stack of experts (emt_matmul_bwd.cu's experts
// entries): expert blockIdx.y's operands start at A.p + e * a_exp and
// B.p + e * b_exp, and its stage reads the expert from blockIdx.y.  A
// kernel of its own, so that the single products' kernels read their
// operands from the parameters unchanged.
template <int AM, int BM, class Stage>
__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32_experts(Operand A, Operand B, int R, int k_slab, int a_fast,
                    long long a_exp, long long b_exp,
                    const typename Stage::Args args) {
  A.p += blockIdx.y * a_exp;
  B.p += blockIdx.y * b_exp;
  gemm_body<AM, BM, Stage>(A, B, R, k_slab, a_fast, args);
}

// The shared-memory opt-in of `kern`, once per device (0-63).
template <auto kern>
cudaError_t smem_opt_in() {
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    opted |= 1ull << dev;
  }
  return cudaSuccess;
}

// The work items of the (A.rows x B.rows) output in `splits` slabs.
inline long long work_items(const Operand& A, const Operand& B, int splits) {
  return (long long)((A.rows + kBM - 1) / kBM) * ((B.rows + kBN - 1) / kBN) *
         splits;
}

// Launch `kern` (a __global__ on gemm_body) over the (A.rows x B.rows)
// output in `splits` slabs of `k_slab` reduction columns, A's row tiles
// fastest if `a_fast`: one CTA per work item.
template <auto kern, class Args>
cudaError_t launch_kernel(const Operand& A, const Operand& B, int R,
                          int k_slab, int splits, bool a_fast,
                          const Args& args, cudaStream_t s) {
  cudaError_t err = smem_opt_in<kern>();
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)work_items(A, B, splits), kThreads, kSmemBytes, s>>>(
      A, B, R, k_slab, (int)a_fast, args);
  return cudaGetLastError();
}

// gemm_3xtf32<AM, BM, Stage> through launch_kernel.  The caller
// dispatches on the operands' modes.
template <int AM, int BM, class Stage>
cudaError_t launch(const Operand& A, const Operand& B, int R, int k_slab,
                   int splits, bool a_fast, const typename Stage::Args& args,
                   cudaStream_t s) {
  return launch_kernel<gemm_3xtf32<AM, BM, Stage>>(A, B, R, k_slab, splits,
                                                    a_fast, args, s);
}

// gemm_3xtf32_experts<AM, BM, Stage> over `experts` products (the grid's
// y), expert e's operands at their strides a_exp, b_exp.
template <int AM, int BM, class Stage>
cudaError_t launch_experts(const Operand& A, const Operand& B, int R,
                           int k_slab, int splits, bool a_fast,
                           long long a_exp, long long b_exp, int experts,
                           const typename Stage::Args& args, cudaStream_t s) {
  if (experts < 1 || experts > 65535) return cudaErrorInvalidValue;
  cudaError_t err = smem_opt_in<gemm_3xtf32_experts<AM, BM, Stage>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)work_items(A, B, splits), (unsigned)experts);
  gemm_3xtf32_experts<AM, BM, Stage><<<grid, kThreads, kSmemBytes, s>>>(
      A, B, R, k_slab, (int)a_fast, a_exp, b_exp, args);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace repro
