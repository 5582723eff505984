// Backward of the technique-A noisy crossbar matmul (K3) for Hopper
// (sm_90a), on the tensor cores in 3xTF32.
//
// The TPU reference has no backward kernel: JAX differentiates
// repro/core/noise.py::fluctuate + `@` in XLA, so its VJP of
//   y = x @ (w * f),  f = fl(1 + fl(a(k, n) * sigma))
// reads the materialized noisy weight.  The port's forward kernel
// (emt_matmul.cu) never materializes the noise, so its backward hashes it
// again, from the same (seed, plane, k, n), in two kernels built on one
// template (emt_tc.cuh: producer warpgroups load each operand tile, apply
// the noise, split it into TF32 hi and lo parts in wgmma's K-major
// swizzled layout; consumer warpgroups run three wgmma products a k-step
// into FP32 sums):
//
// * K3-dx: dx (M, K) = g (M, N) @ (w * f)^T.  A is g; B is the noisy
//   weight at w's logical (k, n), stored K-major for either layout
//   (n-major projections, and the tied unembed's table.T, transposed on
//   the way into shared memory).  A two-state table's noise is hashed once
//   per element and call by noise_bits (one bit an element, 1/32 of the
//   weight's bytes, freed after the call), not once per 128-row tile of g
//   in the producers (8 times at gemma3-1b's M = 1024: the hash was 22% of
//   the kernel there); other tables hash in the producers.  What bounds
//   it: 3 x 2 MKN tensor-core FLOPs (at M = 1024 far above the bytes) and
//   the producers' transform.  Thin outputs ((1024, 1152) has 72 tiles)
//   split N by splitk.plan_waves into slabs summed in slab order
//   (repro::split_sum).
// * K3-dw: dw = (x^T g) * f and dsigma = sum fl(fl((x^T g) * w) * a), the
//   rounding XLA's VJP of w * (1 + a * sigma) gives.  The same template
//   computes x^T g (both operands MN-major in memory, transposed by the
//   producers; x^T's row tiles fastest, so the CTAs launched together
//   share a column block of g), and its epilogue hashes each output
//   element once, writes dw = fl(gw * f) and adds fl(fl(gw * w) * a) into
//   the partials in a fixed order (no second pass over dw).  Where the plan splits M (few
//   output tiles over a long M: the CNN's (27, 64) and (576, 64) over
//   M = 32,768), the slabs go to a workspace and the epilogue moves to the
//   kernel that sums them in slab order.  A one-CTA kernel adds the
//   partials in order (in double): four per output tile (its 32-row
//   quarters), whatever the split or the SM count; no atomics, so two
//   calls give the same bits.
//
// Both also run over a stack of E experts in one launch (the experts
// entry's backward, emt_matmul_experts_dx_f32 / _dw_f32): the template's
// gemm_3xtf32_experts, the grid's y the expert, each operand's base moved
// by its expert stride, and the stages instantiated with EX = true, so
// that expert e's weight is hashed at rows e * K + k of the folded (E * K,
// N) stack, as the experts' forward draws it.  K3-dw's epilogue then also
// adds the cotangent gs of the noisy stack's sum |w~| (technique B's term)
// to x^T g before the factor: c = fl(x^T g + gs sgn(w~)), sgn +1 where
// fl(w f) >= 0 (JAX's derivative of |.|, +1 at 0), dw = fl(c f) and
// dsigma = sum fl(fl(c w) a), that is XLA's VJP of w * (1 + a sigma) once
// the noisy stack's two cotangents are added.  The single products'
// kernels (EX = false) are the code they were: an expert's offsets in the
// producers cost K3-dx spills and 8% of its time at gemma3-1b's shapes.
// The experts take two copy modes each (both operands 16-byte copies, or
// both 4-byte), to keep the build short.
#include <cstdint>

#include "common.cuh"
#include "emt_tc.cuh"

namespace {

constexpr int kSumThreads = 256;

using repro::Factors;
using repro::kMaxStates;
using repro::NoiseParams;
using repro::tc::acc_col;
using repro::tc::acc_row;

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

// One weight's noise: sigma on the device, the step seed, the layer
// plane, the state table.
struct NoiseArgs {
  const float* sig;
  uint32_t seed, plane;
  NoiseParams np;
};

using repro::tc::TileIdx;

// Store the tile (row < M, col < N) at out (M, N) + z * M * N; with EX,
// expert blockIdx.y's at out + (z * E + e) * M * N: slab z's partials of
// the E experts one after the other, so that split_sum adds the slabs of
// (E, M, N) in slab order.
template <bool EX>
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* out,
                                           int M, int N, const TileIdx& ti,
                                           int tid) {
  const long long z = EX ? (long long)ti.z * gridDim.y + blockIdx.y : ti.z;
  float* o = out + z * M * N;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int m = ti.m0 + acc_row(tid, i), n = ti.n0 + acc_col(tid, i);
    if (m < M && n < N) o[(long long)m * N + n] = acc[i];
  }
}

// K3-dx: A = g, B = the noisy weight; the tile (or slab z's partial) to out.
// Two-state tables read each element's state from `bits` (noise_bits:
// bit n % 32 of word (k, n / 32)), so each weight element is hashed once
// per call; other tables hash in the producers.  With EX, expert
// blockIdx.y's weight rows are rows e * K + k of the folded stack (and of
// its bits).
template <int NS, bool EX = false>
struct DxStage {
  // the producers' transform (the bits, the split) gains from 104
  // registers; the consumers need 152 (timed variants on the H100)
  static constexpr int kConsumerRegs = 152;
  struct Args {
    float* out;
    int M, N;
    const uint32_t* bits;
    int words;
    NoiseArgs nz;
  };
  const Args p;
  uint32_t pk;
  Factors F;
  __device__ explicit DxStage(const Args& args) : p(args) {
    pk = repro::hash_pk(args.nz.seed, args.nz.plane);
    repro::make_factors(args.nz.np, *args.nz.sig, F);
  }
  __device__ float a(float v, int, int) const { return v; }
  // w's row k in the folded stack: k, or e * K + k with EX
  __device__ uint32_t row(int k) const {
    if constexpr (EX)
      return blockIdx.y * (uint32_t)p.N + (uint32_t)k;
    else
      return (uint32_t)k;
  }
  // B's row r is w's k, its reduction index c is w's n
  __device__ uint32_t b_aux(int k, int c) const {
    if constexpr (NS == 2)
      return k < p.N ? __ldg(p.bits + (long long)row(k) * p.words + (c >> 5))
                     : 0u;
    else
      return 0u;
  }
  __device__ float b(float v, int k, int n, uint32_t aux) const {
    if constexpr (NS == 2)
      return __fmul_rn(v, (aux >> (n & 31)) & 1u ? F.f[1] : F.f[0]);
    else
      return repro::noisy<NS>(v, row(k), (uint32_t)n, pk, F);
  }
  __device__ void epilogue(const float (&acc)[64], const TileIdx& ti,
                           int tid) const {
    store_tile<EX>(acc, p.out, p.M, p.N, ti, tid);
  }
};

// x^T g split along M: slab z's partial tile to the workspace (with EX,
// expert blockIdx.y's after the slab's earlier experts').
template <bool EX = false>
struct SlabStage {
  static constexpr int kConsumerRegs = 152;
  struct Args {
    float* out;
    int M, N;
  };
  const Args p;
  __device__ explicit SlabStage(const Args& args) : p(args) {}
  __device__ float a(float v, int, int) const { return v; }
  __device__ uint32_t b_aux(int, int) const { return 0u; }
  __device__ float b(float v, int, int, uint32_t) const { return v; }
  __device__ void epilogue(const float (&acc)[64], const TileIdx& ti,
                           int tid) const {
    store_tile<EX>(acc, p.out, p.M, p.N, ti, tid);
  }
};

// K3-dw's epilogue over the tile gw = x^T g: dw = fl(gw * f), and the
// partials of dsigma, sum fl(fl(gw * w) * a), one per 32-row quarter of
// the tile (4 per tile, whatever the split: dw_slab_epilogue writes the
// same ones), in the accumulator's order, then a butterfly in each warp,
// then the quarter's two warps in order, to part[4 tile index + quarter]
// (tiles row-major over the output).  The thread's values of w are loaded
// 32 at a time, in flight together (8-byte loads of column pairs where w
// is n-major: `w2`), and dw's column pairs are stored together where N is
// even.  With EX (a stack of experts): c = fl(gw + gs sgn(w~)) in place
// of gw, gs read on the device; expert e's w, dw and partials (an
// expert's tiles after the earlier experts') at their strides, its noise
// at rows e * K + k of the folded stack.
struct DwArgs {
  float* dw;
  const float* w;
  long long swk, swn;
  float* part;
  int K, N;
  int w2;
  NoiseArgs nz;
  const float* gs;  // EX: the sum |w~|'s cotangent
  long long swe;    // EX: w's expert stride
};

template <int NS, bool EX = false>
struct DwStage {
  // the epilogue (64 accumulators, 32 values of w, the hash) runs on 168
  // registers
  static constexpr int kConsumerRegs = 168;
  using Args = DwArgs;
  const Args p;
  uint32_t pk;
  Factors F;
  float off[kMaxStates];
  // EX: expert e's weight, dw and partials, its first row e * K, and gs
  const float* w;
  float* dw;
  float* part;
  uint32_t row0;
  float gs;
  // expert blockIdx.y (the GEMM's grid), or `e` (the slab epilogue's)
  __device__ explicit DwStage(const Args& args) : DwStage(args, blockIdx.y) {}
  __device__ DwStage(const Args& args, int e) : p(args) {
    pk = repro::hash_pk(args.nz.seed, args.nz.plane);
    repro::make_factors(args.nz.np, *args.nz.sig, F);
#pragma unroll
    for (int i = 0; i < kMaxStates; ++i) off[i] = args.nz.np.off[i];
    if constexpr (EX) {
      const long long tiles =
          (long long)((args.K + repro::tc::kBM - 1) / repro::tc::kBM) *
          ((args.N + repro::tc::kBN - 1) / repro::tc::kBN);
      w = args.w + e * args.swe;
      dw = args.dw + (long long)e * args.K * args.N;
      part = args.part + 4 * tiles * e;
      row0 = (uint32_t)e * (uint32_t)args.K;
      gs = *args.gs;
    }
  }
  __device__ float a(float v, int, int) const { return v; }
  __device__ uint32_t b_aux(int, int) const { return 0u; }
  __device__ float b(float v, int, int, uint32_t) const { return v; }
  __device__ const float* w_base() const {
    if constexpr (EX)
      return w;
    else
      return p.w;
  }
  // w (k, n) and w (k, n + 1), zeros outside w
  __device__ float2 w_pair(int k, int n) const {
    const float* q = w_base() + k * p.swk + n * p.swn;
    if (p.w2 && k < p.K && n + 1 < p.N)
      return __ldg(reinterpret_cast<const float2*>(q));
    return make_float2(k < p.K && n < p.N ? __ldg(q) : 0.f,
                       k < p.K && n + 1 < p.N ? __ldg(q + p.swn) : 0.f);
  }
  // dw (k, n .. n + 1) from gw's pair; dsigma's terms added to ds in order
  __device__ void pair(float gw0, float gw1, float2 wv, int k, int n,
                       float& ds) const {
    if (k >= p.K) return;
    const float g[2] = {gw0, gw1}, wk[2] = {wv.x, wv.y};
    float o[2] = {0.f, 0.f};
    uint32_t r = (uint32_t)k;
    if constexpr (EX) r += row0;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (n + e < p.N) {
        float f, oa;
        factor_offset<NS>(repro::hash_mix(repro::hash_rc(r, n + e), pk), F,
                          off, f, oa);
        float c = g[e];
        if constexpr (EX)
          c = __fadd_rn(c, __fmul_rn(wk[e], f) >= 0.f ? gs : -gs);
        o[e] = __fmul_rn(c, f);
        ds = __fadd_rn(ds, __fmul_rn(__fmul_rn(c, wk[e]), oa));
      }
    float* dwp;
    if constexpr (EX)
      dwp = dw;
    else
      dwp = p.dw;
    float* q = dwp + (long long)k * p.N + n;
    if ((p.N & 1) == 0 && n + 1 < p.N) {
      *reinterpret_cast<float2*>(q) = make_float2(o[0], o[1]);
    } else {
      if (n < p.N) q[0] = o[0];
      if (n + 1 < p.N) q[1] = o[1];
    }
  }
  __device__ void epilogue(const float (&acc)[64], const TileIdx& ti,
                           int tid) const {
    // elements i and i + 1 are columns n and n + 1 of row k (n even)
    float ds = 0.f;
#pragma unroll
    for (int h = 0; h < 64; h += 32) {
      float2 wv[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        wv[i / 2] = w_pair(ti.m0 + acc_row(tid, h + i),
                           ti.n0 + acc_col(tid, h + i));
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        pair(acc[h + i], acc[h + i + 1], wv[i / 2],
             ti.m0 + acc_row(tid, h + i), ti.n0 + acc_col(tid, h + i), ds);
    }
    // warp w holds rows 16 w .. 16 w + 15: quarter q is warps 2 q, 2 q + 1
    __shared__ float red[repro::tc::kConsumers / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ds += __shfl_xor_sync(0xffffffffu, ds, o);
    if ((tid & 31) == 0) red[tid >> 5] = ds;
    repro::tc::consumers_sync();
    if (tid < 4) {
      float* pp;
      if constexpr (EX)
        pp = part;
      else
        pp = p.part;
      pp[4 * ti.index + tid] = red[2 * tid] + red[2 * tid + 1];
    }
  }
};

// K3-dw after a split along M: one CTA per 32-row quarter of an output tile
// (grid: N's tiles, K's tiles, 4; with EX 4 quarters x E experts, slab z
// of expert e at ws + (z * E + e) K N).  Each thread takes a column pair
// and 8 rows, 4 apart; gw is the slabs of `ws` summed in slab order (4
// slabs' loads in flight at a time), then DwStage's pair epilogue; the
// quarter's partial of dsigma, the threads' in a butterfly then warp
// order, to part[4 tile index + quarter] (the expert's partials).
template <int NS, bool EX = false>
__global__ void __launch_bounds__(256)
dw_slab_epilogue(const float* __restrict__ ws, int splits,
                 const DwArgs args) {
  const int quarter = EX ? blockIdx.z & 3 : blockIdx.z;
  const int ex = EX ? blockIdx.z >> 2 : 0;
  const DwStage<NS, EX> st(args, ex);
  const int tid = threadIdx.x;
  const TileIdx ti{(int)blockIdx.y * repro::tc::kBM,
                   (int)blockIdx.x * repro::tc::kBN,
                   (int)(blockIdx.y * gridDim.x + blockIdx.x), 0};
  const int n = ti.n0 + 2 * (tid & 63);
  const int k0 = ti.m0 + 32 * quarter + (tid >> 6);
  const long long kn = (long long)args.K * args.N;
  // slab z of this expert at ws + (z * experts + ex) * kn
  const long long zs = EX ? (long long)(gridDim.z >> 2) * kn : kn;
  if constexpr (EX) ws += ex * kn;
  auto at = [&](int j, int e) -> long long {
    const int k = k0 + 4 * j;
    return k < args.K && n + e < args.N ? (long long)k * args.N + n + e : -1;
  };
  float gw[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) gw[i] = 0.f;
  int z = 0;
  for (; z + 4 <= splits; z += 4) {
    float v[4][16];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const long long o = at(i >> 1, i & 1);
        v[u][i] = o >= 0 ? ws[(z + u) * zs + o] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 16; ++i) gw[i] = z + u ? gw[i] + v[u][i] : v[u][i];
  }
  for (; z < splits; ++z)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long o = at(i >> 1, i & 1);
      const float v = o >= 0 ? ws[z * zs + o] : 0.f;
      gw[i] = z ? gw[i] + v : v;
    }
  float2 wv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wv[j] = st.w_pair(k0 + 4 * j, n);
  float ds = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n < args.N) st.pair(gw[2 * j], gw[2 * j + 1], wv[j], k0 + 4 * j, n, ds);
  __shared__ float red[8];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ds += __shfl_xor_sync(0xffffffffu, ds, o);
  if ((tid & 31) == 0) red[tid >> 5] = ds;
  __syncthreads();
  if (tid == 0) {
    float s = red[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) s += red[i];
    if constexpr (EX)
      st.part[4 * ti.index + quarter] = s;
    else
      args.part[4 * ti.index + quarter] = s;
  }
}

// The two-state noise of w (K, N), or of a folded (E * K, N) stack of
// experts (K its rows): bit n % 32 of bits[k * words + n / 32] set iff
// element (k, n) draws state 1 (hash bits >= t2, common.cuh's factor<2>).
// One thread a word.
__global__ void __launch_bounds__(256)
noise_bits(uint32_t* __restrict__ bits, int K, int N, int words,
           uint32_t seed, uint32_t plane, uint32_t t2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * words) return;
  const uint32_t pk = repro::hash_pk(seed, plane);
  const int k = (int)(i / words), n0 = 32 * (int)(i % words);
  uint32_t out = 0;
#pragma unroll 8
  for (int b = 0; b < 32; ++b)
    if (n0 + b < N &&
        repro::hash_mix(repro::hash_rc(k, n0 + b), pk) >= t2)
      out |= 1u << b;
  bits[i] = out;
}

// out[0] = the sum of part[0 .. n), in a fixed order (double).
__global__ void __launch_bounds__(kSumThreads)
partial_sum(const float* __restrict__ part, int n, float* __restrict__ out) {
  __shared__ double s[kSumThreads];
  const int tid = threadIdx.x;
  double v = 0.0;
  for (int i = tid; i < n; i += kSumThreads) v += part[i];
  s[tid] = v;
  __syncthreads();
  for (int o = kSumThreads / 2; o > 0; o >>= 1) {
    if (tid < o) s[tid] += s[tid + o];
    __syncthreads();
  }
  if (tid == 0) out[0] = (float)s[0];
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// An operand of rows x reduction, element (r, c) at p + r s_row + c s_red,
// and the way the producers copy it (16 bytes along whichever stride is 1
// where the alignment allows).
repro::tc::Operand operand(const float* p, long long s_row, long long s_red,
                           int rows) {
  using namespace repro::tc;
  const int mode = s_red == 1 && s_row % 4 == 0 && aligned(p, 16)   ? kAlongC
                   : s_row == 1 && s_red % 4 == 0 && aligned(p, 16) ? kAlongR
                                                                    : kScalar;
  return Operand{p, s_row, s_red, rows, mode};
}

// launch<AM, BM, Stage> for the operands' copy modes: AM among dispatch's
// AMs, BM among ModesB's BMs (the modes the caller's operands take).
template <class Stage, int... BMs>
struct ModesB {
  template <int AM>
  static cudaError_t go(const repro::tc::Operand& A,
                        const repro::tc::Operand& B, int R, int k_slab,
                        int splits, bool a_fast,
                        const typename Stage::Args& args, cudaStream_t s) {
    cudaError_t err = cudaErrorInvalidValue;
    ((B.mode == BMs ? (err = repro::tc::launch<AM, BMs, Stage>(
                           A, B, R, k_slab, splits, a_fast, args, s),
                       0)
                    : 0),
     ...);
    return err;
  }
};

template <class Stage, class MB, int... AMs>
cudaError_t dispatch(const repro::tc::Operand& A, const repro::tc::Operand& B,
                     int R, int k_slab, int splits, bool a_fast,
                     const typename Stage::Args& args, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  ((A.mode == AMs ? (err = MB::template go<AMs>(A, B, R, k_slab, splits,
                                                a_fast, args, s),
                     0)
                  : 0),
   ...);
  return err;
}

using repro::tc::kAlongC;
using repro::tc::kAlongR;
using repro::tc::kScalar;

// K3-dx: A = g (row-major: along c, or 4-byte copies where its rows are
// not 16-byte aligned), B = w in either layout.
template <int NS>
cudaError_t dx_go(const repro::tc::Operand& A, const repro::tc::Operand& B,
                  int N, int n_slab, int splits, const uint32_t* bits,
                  const NoiseArgs& nz, float* out, cudaStream_t s) {
  using MB = ModesB<DxStage<NS>, kAlongC, kAlongR, kScalar>;
  return dispatch<DxStage<NS>, MB, kAlongC, kScalar>(
      A, B, N, n_slab, splits, false,
      {out, A.rows, B.rows, bits, (N + 31) / 32, nz}, s);
}

// Two-state tables: the state bits first (noise_bits), then the product.
cudaError_t dx_launch(const repro::tc::Operand& A, const repro::tc::Operand& B,
                      int N, int n_slab, int splits, uint32_t* bits,
                      const NoiseArgs& nz, float* out, cudaStream_t s) {
  if (nz.np.n_states != 2)
    return dx_go<0>(A, B, N, n_slab, splits, nullptr, nz, out, s);
  const int words = (N + 31) / 32;
  const long long n = (long long)B.rows * words;
  noise_bits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      bits, B.rows, N, words, nz.seed, nz.plane, nz.np.t2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dx_go<2>(A, B, N, n_slab, splits, bits, nz, out, s);
}

// K3-dw: A = x^T and B = g^T, both along r (or 4-byte copies).
template <class Stage>
cudaError_t dw_gemm(const repro::tc::Operand& A, const repro::tc::Operand& B,
                    int M, int m_slab, int splits,
                    const typename Stage::Args& a, cudaStream_t s) {
  using MB = ModesB<Stage, kAlongR, kScalar>;
  // A = x^T is the smaller operand: its row tiles fastest, so the CTAs
  // launched together share a column block of g
  return dispatch<Stage, MB, kAlongR, kScalar>(A, B, M, m_slab, splits, true,
                                               a, s);
}

template <int NS>
cudaError_t dw_launch(const repro::tc::Operand& A, const repro::tc::Operand& B,
                      int M, int m_slab, int splits, const DwArgs& a,
                      float* ws, cudaStream_t s) {
  if (splits == 1) return dw_gemm<DwStage<NS>>(A, B, M, m_slab, 1, a, s);
  cudaError_t err =
      dw_gemm<SlabStage<>>(A, B, M, m_slab, splits, {ws, a.K, a.N}, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + repro::tc::kBN - 1) / repro::tc::kBN,
                  (a.K + repro::tc::kBM - 1) / repro::tc::kBM, 4);
  dw_slab_epilogue<NS><<<grid, 256, 0, s>>>(ws, splits, a);
  return cudaGetLastError();
}

// -- a stack of experts ----------------------------------------------------
// The experts' operands and their expert strides: both 16-byte copies in
// mode `fast` (kAlongC for dx's g and w, kAlongR for dw's x^T and g^T)
// where both allow it at every expert's base, else both 4-byte copies
// (two instantiations a stage, not the single products' six).
struct ExpertOperands {
  repro::tc::Operand A, B;
  long long a_exp, b_exp;
};

ExpertOperands expert_operands(const repro::tc::Operand& A, long long a_exp,
                               const repro::tc::Operand& B, long long b_exp,
                               int fast) {
  ExpertOperands o{A, B, a_exp, b_exp};
  if (!(A.mode == fast && B.mode == fast && a_exp % 4 == 0 &&
        b_exp % 4 == 0))
    o.A.mode = o.B.mode = kScalar;
  return o;
}

template <class Stage, int kFast>
cudaError_t experts_gemm(const ExpertOperands& o, int R, int k_slab,
                         int splits, bool a_fast, int experts,
                         const typename Stage::Args& args, cudaStream_t s) {
  using repro::tc::launch_experts;
  if (o.A.mode == kFast)
    return launch_experts<kFast, kFast, Stage>(o.A, o.B, R, k_slab, splits,
                                               a_fast, o.a_exp, o.b_exp,
                                               experts, args, s);
  return launch_experts<kScalar, kScalar, Stage>(o.A, o.B, R, k_slab, splits,
                                                 a_fast, o.a_exp, o.b_exp,
                                                 experts, args, s);
}

template <int NS>
cudaError_t experts_dx_go(const ExpertOperands& o, int N, int n_slab,
                          int splits, int experts, const uint32_t* bits,
                          const NoiseArgs& nz, float* out, cudaStream_t s) {
  return experts_gemm<DxStage<NS, true>, kAlongC>(
      o, N, n_slab, splits, false, experts,
      {out, o.A.rows, o.B.rows, bits, (N + 31) / 32, nz}, s);
}

// The experts' dx: A = g, B = w (any strides); two-state tables' bits of
// the whole (experts * K, N) stack first.
cudaError_t experts_dx_launch(const ExpertOperands& o, int N, int n_slab,
                              int splits, int experts, uint32_t* bits,
                              const NoiseArgs& nz, float* out,
                              cudaStream_t s) {
  if (nz.np.n_states != 2)
    return experts_dx_go<0>(o, N, n_slab, splits, experts, nullptr, nz, out,
                            s);
  const int words = (N + 31) / 32;
  const long long n = (long long)experts * o.B.rows * words;
  noise_bits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      bits, experts * o.B.rows, N, words, nz.seed, nz.plane, nz.np.t2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return experts_dx_go<2>(o, N, n_slab, splits, experts, bits, nz, out, s);
}

// The experts' dw: x^T g per expert, then DwStage<NS, true>'s epilogue in
// the GEMM or, split along M, in the slab epilogue.
template <int NS>
cudaError_t experts_dw_launch(const ExpertOperands& o, int M, int m_slab,
                              int splits, int experts, const DwArgs& a,
                              float* ws, cudaStream_t s) {
  if (splits == 1)
    return experts_gemm<DwStage<NS, true>, kAlongR>(o, M, m_slab, 1, true,
                                                    experts, a, s);
  cudaError_t err = experts_gemm<SlabStage<true>, kAlongR>(
      o, M, m_slab, splits, true, experts, {ws, a.K, a.N}, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + repro::tc::kBN - 1) / repro::tc::kBN,
                  (a.K + repro::tc::kBM - 1) / repro::tc::kBM, 4 * experts);
  dw_slab_epilogue<NS, true><<<grid, 256, 0, s>>>(ws, splits, a);
  return cudaGetLastError();
}

}  // namespace

// dx (M, K) = g (M, N) @ noisy(w (K, N))^T; g and w of any strides.
// dims = {M, K, N, splits, n_slab, sgm, sgn, swk, swn}: `splits` CTAs per
// 128 x 128 output tile along N, each over `n_slab` columns of g (whole
// 32-column tiles), as planned by repro_torch/kernels/emt_matmul.py
// ::plan_dx; with splits > 1 the partials go to `part` (splits * M * K
// floats) and are summed into dx in slab order.  `bits`: K * ceil(N / 32)
// words for a two-state table's noise-state bits (unused otherwise).
extern "C" int emt_matmul_dx_f32(const float* g, const float* w, float* dx,
                                 float* part, unsigned int* bits,
                                 const float* sig,
                                 const long long* dims, unsigned int seed,
                                 unsigned int plane, const NoiseParams* np,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], K = (int)dims[1], N = (int)dims[2];
  const int splits = (int)dims[3], n_slab = (int)dims[4];
  const long long sgm = dims[5], sgn = dims[6], swk = dims[7], swn = dims[8];
  if (M < 1 || K < 1 ||
      !repro::split_plan_ok(N, splits, n_slab, repro::tc::kBK) ||
      (np->n_states == 2 && bits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // A = g (M rows, reduction N), B = w (K rows, reduction N)
  repro::tc::Operand A = operand(g, sgm, sgn, M);
  const repro::tc::Operand B = operand(w, swk, swn, K);
  if (A.mode == kAlongR) A.mode = kScalar;     // a column-major g
  float* out = splits > 1 ? part : dx;
  cudaError_t err = dx_launch(A, B, N, n_slab, splits, bits,
                              NoiseArgs{sig, seed, plane, *np}, out, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, dx, (long long)M * K, splits, s));
}

// dw (K, N) = (x^T g) * f(k, n) and dsig[0] = sum (x^T g) * w * a(k, n),
// x (M, K), g (M, N) and w (K, N) of any strides, dw contiguous.
// dims = {M, K, N, splits, m_slab, sxm, sxk, sgm, sgn, swk, swn}, as
// planned by emt_matmul.py::plan_dw.  `ws`: with splits > 1, the slabs'
// partial x^T g (splits * K * N floats; unused otherwise).  `part`: four
// partials of dsigma per 128 x 128 output tile (one per 32-row quarter),
// then dsigma itself.
extern "C" int emt_matmul_dw_f32(const float* x, const float* g,
                                 const float* w, float* dw, float* ws,
                                 float* part, const float* sig,
                                 const long long* dims,
                                 unsigned int seed, unsigned int plane,
                                 const NoiseParams* np, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], K = (int)dims[1], N = (int)dims[2];
  const int splits = (int)dims[3], m_slab = (int)dims[4];
  const long long sxm = dims[5], sxk = dims[6], sgm = dims[7], sgn = dims[8];
  const long long swk = dims[9], swn = dims[10];
  if (K < 1 || N < 1 ||
      !repro::split_plan_ok(M, splits, m_slab, repro::tc::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // A = x^T (K rows, reduction M), B = g^T (N rows, reduction M)
  repro::tc::Operand A = operand(x, sxk, sxm, K);
  repro::tc::Operand B = operand(g, sgn, sgm, N);
  // a column-major x or g
  if (A.mode == kAlongC) A.mode = kScalar;
  if (B.mode == kAlongC) B.mode = kScalar;
  const int tiles = ((K + repro::tc::kBM - 1) / repro::tc::kBM) *
                    ((N + repro::tc::kBN - 1) / repro::tc::kBN);
  const NoiseArgs nz{sig, seed, plane, *np};
  // 8-byte loads of w's column pairs (n-major, even row stride)
  const int w2 = swn == 1 && swk % 2 == 0 && aligned(w, 8);
  cudaError_t err;
  if (np->n_states == 2)
    err = dw_launch<2>(A, B, M, m_slab, splits,
                       {dw, w, swk, swn, part, K, N, w2, nz}, ws, s);
  else
    err = dw_launch<0>(A, B, M, m_slab, splits,
                       {dw, w, swk, swn, part, K, N, w2, nz}, ws, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  partial_sum<<<1, kSumThreads, 0, s>>>(part, 4 * tiles, part + 4 * tiles);
  return static_cast<int>(cudaGetLastError());
}

// The experts' dx: dx[e] (M, K) = g[e] (M, N) @ noisy(w[e] (K, N))^T for
// the E experts of a stack in one launch, expert e's weight hashed at rows
// e * K + k of the folded (E * K, N) stack; g and w of any strides, dx
// (E, M, K) contiguous.  dims = {M, K, N, splits, n_slab, sgm, sgn, swk,
// swn, E, sge, swe}, as planned by emt_matmul.py::plan_dx(..., experts=E);
// `part` splits * E * M * K floats with splits > 1 (slab z's experts one
// after the other); `bits` E * K * ceil(N / 32) words for a two-state
// table.
extern "C" int emt_matmul_experts_dx_f32(const float* g, const float* w,
                                         float* dx, float* part,
                                         unsigned int* bits, const float* sig,
                                         const long long* dims,
                                         unsigned int seed, unsigned int plane,
                                         const NoiseParams* np, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], K = (int)dims[1], N = (int)dims[2];
  const int splits = (int)dims[3], n_slab = (int)dims[4], E = (int)dims[9];
  if (M < 1 || K < 1 || E < 1 ||
      !repro::split_plan_ok(N, splits, n_slab, repro::tc::kBK) ||
      (np->n_states == 2 && bits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // A = g (M rows, reduction N), B = w (K rows, reduction N)
  const ExpertOperands o =
      expert_operands(operand(g, dims[5], dims[6], M), dims[10],
                      operand(w, dims[7], dims[8], K), dims[11], kAlongC);
  float* out = splits > 1 ? part : dx;
  cudaError_t err = experts_dx_launch(o, N, n_slab, splits, E, bits,
                                      NoiseArgs{sig, seed, plane, *np}, out, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      repro::split_sum(part, dx, (long long)E * M * K, splits, s));
}

// The experts' dw: for the E experts of a stack in one launch, with gs
// the cotangent of the noisy stack's sum |w~| (a float32 scalar on the
// device), c = fl(x[e]^T g[e] + gs sgn(w~)), dw[e] = fl(c f) (E, K, N)
// contiguous, and dsig[0] = sum over the experts of fl(fl(c w) a), expert
// e's noise at rows e * K + k of the folded stack; x, g and w of any
// strides.  dims = {M, K, N, splits, m_slab, sxm, sxk, sgm, sgn, swk, swn,
// E, sxe, sge, swe}, as planned by emt_matmul.py::plan_dw(..., experts=E);
// `ws` splits * E * K * N floats with splits > 1; `part` four partials a
// tile of each expert's (K, N), expert by expert, then dsigma.
extern "C" int emt_matmul_experts_dw_f32(
    const float* x, const float* g, const float* w, float* dw, float* ws,
    float* part, const float* gs, const float* sig, const long long* dims,
    unsigned int seed, unsigned int plane, const NoiseParams* np,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = (int)dims[0], K = (int)dims[1], N = (int)dims[2];
  const int splits = (int)dims[3], m_slab = (int)dims[4], E = (int)dims[11];
  const long long swk = dims[9], swn = dims[10], swe = dims[14];
  if (K < 1 || N < 1 || E < 1 || gs == nullptr ||
      !repro::split_plan_ok(M, splits, m_slab, repro::tc::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // A = x^T (K rows, reduction M), B = g^T (N rows, reduction M)
  const ExpertOperands o =
      expert_operands(operand(x, dims[6], dims[5], K), dims[12],
                      operand(g, dims[8], dims[7], N), dims[13], kAlongR);
  const int tiles = ((K + repro::tc::kBM - 1) / repro::tc::kBM) *
                    ((N + repro::tc::kBN - 1) / repro::tc::kBN);
  // 8-byte loads of w's column pairs (n-major, even strides)
  const int w2 = swn == 1 && swk % 2 == 0 && swe % 2 == 0 && aligned(w, 8);
  const DwArgs a{dw, w, swk, swn, part, K, N, w2,
                 NoiseArgs{sig, seed, plane, *np}, gs, swe};
  cudaError_t err = np->n_states == 2
                        ? experts_dw_launch<2>(o, M, m_slab, splits, E, a, ws, s)
                        : experts_dw_launch<0>(o, M, m_slab, splits, E, a, ws,
                                               s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 4 * tiles * E;
  partial_sum<<<1, kSumThreads, 0, s>>>(part, n, part + n);
  return static_cast<int>(cudaGetLastError());
}
