// Technique-A noisy crossbar matmul at M > 16 for Hopper (sm_90a), on the
// tensor cores: K3's forward on the 3xTF32 template (emt_tc.cuh).
//
// Replaces the TPU kernel repro/kernels/emt_matmul.py::emt_matmul_pallas
// for its chunk, verify, prefill and training calls (M > 16; the GEMV of
// emt_matmul.cu keeps M <= 16):
//   y = x @ (w * f),  f = fl(1 + fl(a(k, n) * sigma)),
// the RTN offset a(k, n) hashed from w's logical (k, n), the step seed and
// the layer plane, as the GEMV hashes it (no noise tensor in device
// memory; no FMA contraction in 1 + a * sigma or w * f).  The template
// computes out = A . B^T with A = x (M x K) and B the noisy weight seen as
// (N x K): B's row is w's column n and its reduction index w's row k, so
// the tied unembed's table.T is K-major in memory and the n-major
// projections are transposed on the way into shared memory.  w may also
// be int8 conductance levels with a float32 scale per column (store_int8
// serving): the producers dequantize fl(float(q) * scale[n]) and noise it
// with the float loader's rounding, so both loaders compute one
// arithmetic and an int8 tree's logits equal the float tree's bit for bit.
//
// Exact on x = I.  3xTF32 splits w~ into rna hi and lo, and the residual
// w~ - hi has up to 13 significant bits where TF32 keeps 11, so hi + lo is
// not w~.  This stage splits w~ by truncation into three pieces (hi, mid,
// lo: 11, 11 and 2 significant bits, disjoint, of w~'s sign) and runs four
// products a k-step, x_lo.hi + x_hi.lo + x_hi.mid + x_hi.hi: on a row of I
// every partial sum is exact, so the product is fluctuate(w) bit for bit;
// elsewhere it is at least as accurate as 3xTF32.
//
// What bounds it on the H100: 4 x 2 MNK TF32 FLOPs at 495 TFLOP/s (16.5 ms
// a gemma3-1b training step at M = 1,024), the weight's bytes at a chunk
// step (M = 64), and the producers' transform (the hash and the split) at
// both: every B tile is transformed once per 128-row tile of x (at most
// 64 rows, a chunk step's, use half the tile: the producers skip its
// second half, and its second consumer warpgroup its products).  So a
// two-state table's noise is hashed once per element and call where x has
// more than one row tile (emt_matmul_tc_bits: one bit an element, laid out
// (n, k / 32) as the producers walk B's rows along k; 1/32 of the weight's
// bytes, freed after the call); at one row tile, and for other tables and
// int8 levels, the producers hash.  CTAs of one weight tile run together
// (x's row tiles fastest), so the weight is read from memory about once.
#include <cstdint>

#include "common.cuh"
#include "emt_tc.cuh"

namespace {

using repro::Factors;
using repro::NoiseParams;
using repro::tc::kAlongC;
using repro::tc::kAlongR;
using repro::tc::kQAlongC;
using repro::tc::kQAlongR;
using repro::tc::kQScalar;
using repro::tc::kScalar;
using repro::tc::Operand;
using repro::tc::TileIdx;

struct FwdArgs {
  float* out;
  int M, N;
  const uint32_t* bits;
  int words;              // bits' words a row: ceil(K / 32)
  const float* scale;     // int8 levels: the per-column scale
  const float* sig;
  uint32_t seed, plane;
  NoiseParams np;
};

// K3's forward: A = x, B = the noisy weight at w's logical (k, n) in three
// TF32 pieces; the tile (or slab z's partial) to out.  NS: the state
// table (2: two states); BITS: read each element's state from `bits` (bit
// k % 32 of word (n, k / 32)), else hash it in the producers; HALF: x has
// at most 64 rows (a chunk step's), so the second half of its one row
// tile is neither transformed nor multiplied.
template <int NS, bool BITS, bool HALF = false>
struct FwdStage {
  static constexpr int kConsumerRegs = 152;
  static constexpr int kBPieces = 3;
  static constexpr bool kHalfRows = HALF;
  using Args = FwdArgs;
  const Args p;
  uint32_t pk;
  Factors F;
  __device__ explicit FwdStage(const Args& args) : p(args) {
    pk = repro::hash_pk(args.seed, args.plane);
    repro::make_factors(args.np, *args.sig, F);
  }
  __device__ float a(float v, int, int) const { return v; }
  // B's row r is w's n, its reduction index c is w's k
  __device__ uint32_t b_aux(int n, int c) const {
    if constexpr (BITS)
      return n < p.N ? __ldg(p.bits + (long long)n * p.words + (c >> 5)) : 0u;
    else
      return 0u;
  }
  __device__ float b_scale(int n) const { return __ldg(p.scale + n); }
  __device__ float b(float v, int n, int k, uint32_t aux) const {
    if constexpr (BITS)
      return __fmul_rn(v, (aux >> (k & 31)) & 1u ? F.f[1] : F.f[0]);
    else
      return repro::noisy<NS>(v, (uint32_t)k, (uint32_t)n, pk, F);
  }
  __device__ void epilogue(const float (&acc)[64], const TileIdx& ti,
                           int tid) const {
    float* o = p.out + (long long)ti.z * p.M * p.N;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int m = ti.m0 + repro::tc::acc_row(tid, i);
      const int n = ti.n0 + repro::tc::acc_col(tid, i);
      if (m < p.M && n < p.N) o[(long long)m * p.N + n] = acc[i];
    }
  }
};

template <int AM, int BM, class Stage>
__global__ void __launch_bounds__(repro::tc::kThreads, 1)
emt_matmul_tc(const Operand A, const Operand B, int R, int k_slab, int a_fast,
              const typename Stage::Args args) {
  repro::tc::gemm_body<AM, BM, Stage>(A, B, R, k_slab, a_fast, args);
}

// The two-state noise of w (K, N) in the forward's walk: bit k % 32 of
// bits[n * words + k / 32] set iff element (k, n) draws state 1 (hash
// bits >= t2, common.cuh's factor<2>).  One thread a word.
__global__ void __launch_bounds__(256)
emt_matmul_tc_bits(uint32_t* __restrict__ bits, int K, int N, int words,
                   uint32_t seed, uint32_t plane, uint32_t t2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * words) return;
  const uint32_t pk = repro::hash_pk(seed, plane);
  const int n = (int)(i / words), k0 = 32 * (int)(i % words);
  uint32_t out = 0;
#pragma unroll 8
  for (int b = 0; b < 32; ++b)
    if (k0 + b < K && repro::hash_mix(repro::hash_rc(k0 + b, n), pk) >= t2)
      out |= 1u << b;
  bits[i] = out;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// emt_matmul_tc<AM, BM, Stage> for B's mode among BMs.
template <class Stage, int AM, int... BMs>
cudaError_t go_b(const Operand& A, const Operand& B, int K, int k_slab,
                 int splits, const typename Stage::Args& args,
                 cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  ((B.mode == BMs
        ? (err = repro::tc::launch_kernel<emt_matmul_tc<AM, BMs, Stage>>(
               A, B, K, k_slab, splits, true, args, s),
           0)
        : 0),
   ...);
  return err;
}

// x along c (rows 16-byte aligned), through Half where `half` (x has at
// most 64 rows), or in 4-byte copies through Full; w's modes BMs.
template <class Full, class Half, int... BMs>
cudaError_t go(const Operand& A, const Operand& B, int K, int k_slab,
               int splits, const FwdArgs& args, bool half, cudaStream_t s) {
  if (A.mode != kAlongC)
    return go_b<Full, kScalar, BMs...>(A, B, K, k_slab, splits, args, s);
  return half ? go_b<Half, kAlongC, BMs...>(A, B, K, k_slab, splits, args, s)
              : go_b<Full, kAlongC, BMs...>(A, B, K, k_slab, splits, args, s);
}

// The shared body of the C entries: check the plan, choose the operands'
// copy modes, launch (after the state bits, where given), sum the slabs.
template <bool I8>
int run(const float* x, const void* w, const float* scale, float* y,
        float* part, uint32_t* bits, const float* sig, const long long* dims,
        unsigned int seed, unsigned int plane, const NoiseParams* np,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], N = (int)dims[1], K = (int)dims[2];
  const int splits = (int)dims[3], k_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], swk = dims[7], swn = dims[8];
  if (M < 1 || N < 1 ||
      !repro::split_plan_ok(K, splits, k_slab, repro::tc::kBK) ||
      (bits != nullptr && np->n_states != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // A = x (M rows, reduction K): along c, else 4-byte copies
  const int am = sxk == 1 && sxm % 4 == 0 && aligned(x, 16) ? kAlongC
                                                            : kScalar;
  const Operand A{x, sxm, sxk, M, am};
  // B = w seen as (N rows, reduction K): element (n, k) at w + n swn + k swk
  int bm;
  if (I8)
    bm = swn == 1 && swk % 4 == 0 && aligned(w, 4)   ? kQAlongR
         : swk == 1 && swn % 4 == 0 && aligned(w, 4) ? kQAlongC
                                                     : kQScalar;
  else
    bm = swn == 1 && swk % 4 == 0 && aligned(w, 16)   ? kAlongR
         : swk == 1 && swn % 4 == 0 && aligned(w, 16) ? kAlongC
                                                      : kScalar;
  const Operand B{static_cast<const float*>(w), swn, swk, N, bm};
  const int words = (K + 31) / 32;
  const FwdArgs args{splits > 1 ? part : y, M, N, bits, words, scale, sig,
                     seed, plane, *np};
  const bool half = M <= repro::tc::kBM / 2;
  using S2 = FwdStage<2, false>;
  using S2h = FwdStage<2, false, true>;
  using S0 = FwdStage<0, false>;
  using S0h = FwdStage<0, false, true>;
  cudaError_t err;
  if constexpr (I8) {
    err = np->n_states == 2
              ? go<S2, S2h, kQAlongR, kQAlongC, kQScalar>(
                    A, B, K, k_slab, splits, args, half, s)
              : go<S0, S0h, kQAlongR, kQAlongC, kQScalar>(
                    A, B, K, k_slab, splits, args, half, s);
  } else if (bits != nullptr) {
    const long long n = (long long)N * words;
    emt_matmul_tc_bits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        bits, K, N, words, seed, plane, np->t2);
    err = cudaGetLastError();
    using S2b = FwdStage<2, true>;
    if (err == cudaSuccess)
      err = go<S2b, S2b, kAlongR, kAlongC, kScalar>(A, B, K, k_slab, splits,
                                                   args, false, s);
  } else {
    err = np->n_states == 2
              ? go<S2, S2h, kAlongR, kAlongC, kScalar>(A, B, K, k_slab,
                                                      splits, args, half, s)
              : go<S0, S0h, kAlongR, kAlongC, kScalar>(A, B, K, k_slab,
                                                      splits, args, half, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, y, (long long)M * N, splits, s));
}

}  // namespace

// y (M, N) = x (M, K) @ noisy(w (K, N)) at M > 16; x and w of any strides.
// dims = {M, N, K, splits, k_slab, sxm, sxk, swk, swn}: `splits` CTAs per
// 128 x 128 output tile along K, each over `k_slab` rows (whole 32-row
// tiles), as planned by repro_torch/kernels/emt_matmul.py::plan; with
// splits > 1 the partials go to `part` (splits * M * N floats) and are
// summed into y in slab order.  `bits`: N * ceil(K / 32) words for a
// two-state table's noise-state bits, or null (the producers hash).
extern "C" int emt_matmul_tc_f32(const float* x, const float* w, float* y,
                                 float* part, unsigned int* bits,
                                 const float* sig, const long long* dims,
                                 unsigned int seed, unsigned int plane,
                                 const NoiseParams* np, void* stream) {
  return run<false>(x, w, nullptr, y, part, bits, sig, dims, seed, plane, np,
                    stream);
}

// The same with w stored as int8 conductance levels (K, N), any strides,
// and `scale` (N contiguous floats) their per-column scale: the producers
// dequantize w = fl(float(q) * scale[n]) before the noise, which they hash.
extern "C" int emt_matmul_tc_i8(const float* x, const int8_t* w,
                                const float* scale, float* y, float* part,
                                const float* sig, const long long* dims,
                                unsigned int seed, unsigned int plane,
                                const NoiseParams* np, void* stream) {
  return run<true>(x, w, scale, y, part, nullptr, sig, dims, seed, plane, np,
                   stream);
}
