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

// Store the tile (row < M, col < N) at out (M, N) + z * M * N.
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* out,
                                           int M, int N, const TileIdx& ti,
                                           int tid) {
  float* o = out + (long long)ti.z * M * N;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int m = ti.m0 + acc_row(tid, i), n = ti.n0 + acc_col(tid, i);
    if (m < M && n < N) o[(long long)m * N + n] = acc[i];
  }
}

// K3-dx: A = g, B = the noisy weight; the tile (or slab z's partial) to out.
// Two-state tables read each element's state from `bits` (noise_bits:
// bit n % 32 of word (k, n / 32)), so each weight element is hashed once
// per call; other tables hash in the producers.
template <int NS>
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
  // B's row r is w's k, its reduction index c is w's n
  __device__ uint32_t b_aux(int k, int c) const {
    if constexpr (NS == 2)
      return k < p.N ? __ldg(p.bits + (long long)k * p.words + (c >> 5)) : 0u;
    else
      return 0u;
  }
  __device__ float b(float v, int k, int n, uint32_t aux) const {
    if constexpr (NS == 2)
      return __fmul_rn(v, (aux >> (n & 31)) & 1u ? F.f[1] : F.f[0]);
    else
      return repro::noisy<NS>(v, (uint32_t)k, (uint32_t)n, pk, F);
  }
  __device__ void epilogue(const float (&acc)[64], const TileIdx& ti,
                           int tid) const {
    store_tile(acc, p.out, p.M, p.N, ti, tid);
  }
};

// x^T g split along M: slab z's partial tile to the workspace.
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
    store_tile(acc, p.out, p.M, p.N, ti, tid);
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
// even.
template <int NS>
struct DwStage {
  // the epilogue (64 accumulators, 32 values of w, the hash) runs on 168
  // registers
  static constexpr int kConsumerRegs = 168;
  struct Args {
    float* dw;
    const float* w;
    long long swk, swn;
    float* part;
    int K, N;
    int w2;
    NoiseArgs nz;
  };
  const Args p;
  uint32_t pk;
  Factors F;
  float off[kMaxStates];
  __device__ explicit DwStage(const Args& args) : p(args) {
    pk = repro::hash_pk(args.nz.seed, args.nz.plane);
    repro::make_factors(args.nz.np, *args.nz.sig, F);
#pragma unroll
    for (int i = 0; i < kMaxStates; ++i) off[i] = args.nz.np.off[i];
  }
  __device__ float a(float v, int, int) const { return v; }
  __device__ uint32_t b_aux(int, int) const { return 0u; }
  __device__ float b(float v, int, int, uint32_t) const { return v; }
  // w (k, n) and w (k, n + 1), zeros outside w
  __device__ float2 w_pair(int k, int n) const {
    const float* q = p.w + k * p.swk + n * p.swn;
    if (p.w2 && k < p.K && n + 1 < p.N)
      return __ldg(reinterpret_cast<const float2*>(q));
    return make_float2(k < p.K && n < p.N ? __ldg(q) : 0.f,
                       k < p.K && n + 1 < p.N ? __ldg(q + p.swn) : 0.f);
  }
  // dw (k, n .. n + 1) from gw's pair; dsigma's terms added to ds in order
  __device__ void pair(float gw0, float gw1, float2 wv, int k, int n,
                       float& ds) const {
    if (k >= p.K) return;
    const float g[2] = {gw0, gw1}, w[2] = {wv.x, wv.y};
    float o[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (n + e < p.N) {
        float f, oa;
        factor_offset<NS>(repro::hash_mix(repro::hash_rc(k, n + e), pk), F,
                          off, f, oa);
        o[e] = __fmul_rn(g[e], f);
        ds = __fadd_rn(ds, __fmul_rn(__fmul_rn(g[e], w[e]), oa));
      }
    float* q = p.dw + (long long)k * p.N + n;
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
    if (tid < 4) p.part[4 * ti.index + tid] = red[2 * tid] + red[2 * tid + 1];
  }
};

// K3-dw after a split along M: one CTA per 32-row quarter of an output tile
// (grid: N's tiles, K's tiles, 4).  Each thread takes a column pair and 8
// rows, 4 apart; gw is the slabs of `ws` summed in slab order (4 slabs'
// loads in flight at a time), then DwStage's pair epilogue; the quarter's
// partial of dsigma, the threads' in a butterfly then warp order, to
// part[4 tile index + quarter].
template <int NS>
__global__ void __launch_bounds__(256)
dw_slab_epilogue(const float* __restrict__ ws, int splits,
                 const typename DwStage<NS>::Args args) {
  const DwStage<NS> st(args);
  const int tid = threadIdx.x;
  const TileIdx ti{(int)blockIdx.y * repro::tc::kBM,
                   (int)blockIdx.x * repro::tc::kBN,
                   (int)(blockIdx.y * gridDim.x + blockIdx.x), 0};
  const int n = ti.n0 + 2 * (tid & 63);
  const int k0 = ti.m0 + 32 * blockIdx.z + (tid >> 6);
  const long long kn = (long long)args.K * args.N;
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
        v[u][i] = o >= 0 ? ws[(z + u) * kn + o] : 0.f;
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
      const float v = o >= 0 ? ws[z * kn + o] : 0.f;
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
    args.part[4 * ti.index + blockIdx.z] = s;
  }
}

// The two-state noise of w (K, N): bit n % 32 of bits[k * words + n / 32]
// set iff element (k, n) draws state 1 (hash bits >= t2, common.cuh's
// factor<2>).  One thread a word.
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
                      int M, int m_slab, int splits,
                      const typename DwStage<NS>::Args& a, float* ws,
                      cudaStream_t s) {
  if (splits == 1) return dw_gemm<DwStage<NS>>(A, B, M, m_slab, 1, a, s);
  cudaError_t err =
      dw_gemm<SlabStage>(A, B, M, m_slab, splits, {ws, a.K, a.N}, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + repro::tc::kBN - 1) / repro::tc::kBN,
                  (a.K + repro::tc::kBM - 1) / repro::tc::kBM, 4);
  dw_slab_epilogue<NS><<<grid, 256, 0, s>>>(ws, splits, a);
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
