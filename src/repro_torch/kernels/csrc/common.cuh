// Shared device helpers for the port's Hopper kernels: the counter-hash RNG
// (bit-exact with repro_torch/core/hashrng.py and repro/core/hashrng.py),
// the RTN state lookup and noisy weight, the weight loads, and the split-K
// slab sum shared by the noisy matmul kernels (planned in
// repro_torch/kernels/splitk.py).
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_NEG_INF (-1e30f)

namespace repro {

__device__ __forceinline__ uint32_t finalize(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// hash_counters(seed, row, col, plane) split into its (row, col) part, its
// (seed, plane) part and the mix of the two, so a kernel that hashes one
// element on many planes computes the element's part once (XOR is
// associative: the bits are the same).
__device__ __forceinline__ uint32_t hash_rc(uint32_t row, uint32_t col) {
  return (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu);
}

__device__ __forceinline__ uint32_t hash_pk(uint32_t seed, uint32_t plane) {
  return (plane * 0xC2B2AE35u) ^ seed;
}

__device__ __forceinline__ uint32_t hash_mix(uint32_t rc, uint32_t pk) {
  return finalize(finalize(rc ^ pk) ^ 0x68E31DA4u);
}

// hash_mix's first xorshift distributes over the XOR of its two terms, so
// a kernel that mixes one (row, col) term with many plane terms shifts each
// term once: hash_mix(rc, pk) == hash_mix_pre(pre(rc), pre(pk)).
__device__ __forceinline__ uint32_t pre(uint32_t t) { return t ^ (t >> 16); }

__device__ __forceinline__ uint32_t hash_mix_pre(uint32_t rcs, uint32_t pks) {
  uint32_t x = rcs ^ pks;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return finalize(x ^ 0x68E31DA4u);
}

__device__ __forceinline__ uint32_t hash_counters(uint32_t seed, uint32_t row,
                                                  uint32_t col, uint32_t plane) {
  return hash_mix(hash_rc(row, col), hash_pk(seed, plane));
}

// RTN state table: thresholds are the cumulative state probabilities as
// float32, offsets the normalized state offsets as float32 (both computed on
// the host exactly as hashrng.py computes them).  t2: for a two-state table,
// the least uint32 `bits` whose uniform fl(bits) * 2^-32 reaches thr[0]
// (uint32 -> float32 rounding is monotonic, so u >= thr[0] iff
// bits >= t2; computed on the host, repro_torch/kernels/emt_matmul.py).
constexpr int kMaxStates = 8;
struct NoiseParams {
  int n_states;
  float thr[kMaxStates - 1];
  float off[kMaxStates];
  uint32_t t2;
};

// -- the noisy weight, shared by K3 (emt_matmul.cu) and K5 (emt_bitserial.cu)
// The noise factor fl(1 + fl(a * sigma)) of every RTN state (no FMA
// contraction, as the reference rounds it), the state thresholds (unused
// ones +inf, so the lookup needs no state count) and the two-state integer
// threshold.
struct Factors {
  float thr[kMaxStates - 1];
  float f[kMaxStates];
  uint32_t t2;
};

__device__ __forceinline__ void make_factors(const NoiseParams& np, float sig,
                                             Factors& F) {
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i)
    F.f[i] = __fadd_rn(1.0f, __fmul_rn(np.off[i], sig));
#pragma unroll
  for (int i = 0; i < kMaxStates - 1; ++i)
    F.thr[i] = i < np.n_states - 1 ? np.thr[i] : INFINITY;
  F.t2 = np.t2;
}

// The factor of the state that hash bits `bits` select: NS = 2 for the
// two-state corners (every corner of the served paths: one integer
// compare), 0 for any table up to kMaxStates (the state of the last float
// threshold that u = fl(bits) * 2^-32 reaches).  The generic lookup's seven
// compare-selects cost ~0.8 ms of K3's device time a gemma3-1b step at
// M = 4 (2.96 -> 3.75 ms) and at M = 64 (7.53 -> 8.33 ms) on an H100 80GB
// HBM3 at 700 W (scripts/smoke_phase.py; PERF.md).
template <int NS>
__device__ __forceinline__ float factor(uint32_t bits, const Factors& F) {
  if constexpr (NS == 2) {
    return bits >= F.t2 ? F.f[1] : F.f[0];
  } else {
    const float u = __fmul_rn(__uint2float_rn(bits), 0x1p-32f);
    float f = F.f[0];
#pragma unroll
    for (int i = 0; i < kMaxStates - 1; ++i)
      if (u >= F.thr[i]) f = F.f[i + 1];
    return f;
  }
}

// w' = fl(w * factor(state(hash(seed, k, n, plane)))), from the element's
// (row, col) hash term rc = hash_rc(k, n) and pk = hash_pk(seed, plane).
template <int NS>
__device__ __forceinline__ float noisy_rc(float w, uint32_t rc, uint32_t pk,
                                          const Factors& F) {
  return __fmul_rn(w, factor<NS>(hash_mix(rc, pk), F));
}

template <int NS>
__device__ __forceinline__ float noisy(float w, uint32_t k, uint32_t n,
                                       uint32_t pk, const Factors& F) {
  return noisy_rc<NS>(w, hash_rc(k, n), pk, F);
}

// w[row_off + n .. n + 3] of an n-major weight (0 past N).  vw: the widest
// load the row alignment allows (4, 2 or 1 floats).
__device__ __forceinline__ float4 load_n4(const float* __restrict__ w,
                                          long long row_off, int n, int N,
                                          int vw) {
  const float* p = w + row_off + n;
  if (n + 3 < N) {
    if (vw == 4) return __ldg(reinterpret_cast<const float4*>(p));
    if (vw == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  return make_float4(n < N ? __ldg(p) : 0.f, n + 1 < N ? __ldg(p + 1) : 0.f,
                     n + 2 < N ? __ldg(p + 2) : 0.f, 0.f);
}

// w[k .. k + 3, n] of a weight with any strides (0 past ke or N); vw == 4:
// swk == 1 and the column is 16-byte aligned at k.
__device__ __forceinline__ float4 load_k4(const float* __restrict__ w, int k,
                                          int ke, int n, int N, long long swk,
                                          long long swn, int vw) {
  if (n >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = w + n * swn;
  if (vw == 4 && k + 3 < ke)
    return __ldg(reinterpret_cast<const float4*>(p + k));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = k + j < ke ? __ldg(p + (k + j) * swk) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float f4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// -- int8 weights (store_int8 serving; K3 only) ----------------------------
// 16 int8 levels p[0], p[step], ..., p[15 * step] (0 past `valid`): one
// 16-byte load when `vec` (step 1, p 16-byte aligned) and all 16 are valid.
__device__ __forceinline__ uint4 load_q16(const int8_t* __restrict__ p,
                                          long long step, int valid,
                                          bool vec) {
  if (vec && valid >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < valid)
      v[j >> 2] |= (uint32_t)(uint8_t)__ldg(p + j * step) << (8 * (j & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Level j (0-3) of the 4 packed in `word`, as float (exact).
__device__ __forceinline__ float level(uint32_t word, int j) {
  return __int2float_rn((int)(int8_t)(word >> (8 * j)));
}

// The dequantized weight fl(float(q) * scale): one rounding, as the
// reference's w_int8.astype(f32) * w_scale.
__device__ __forceinline__ float dequant(uint32_t word, int j, float scale) {
  return __fmul_rn(level(word, j), scale);
}

// -- split-K ---------------------------------------------------------------
// A kernel split along K writes slab z's partial (M, N) sums to
// part[z * M * N ...]; split_sum adds the slabs in slab order into y, so the
// result is the same bits on every run (no atomics).

// True iff `splits` slabs of `k_slab` rows (a whole number of `bk`-row
// tiles) cover K with no slab empty: the planner's contract.
inline bool split_plan_ok(int K, int splits, int k_slab, int bk) {
  if (K <= 0) return splits == 1;
  if (splits < 1 || k_slab < bk || k_slab % bk != 0) return false;
  const long long cover = (long long)splits * k_slab;
  return cover >= K && cover - k_slab < K;
}

template <int kUnused = 0>
__global__ void split_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ y, long long mn,
                                 int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[z * mn + i];
  y[i] = s;
}

// y (mn floats) = sum of the `splits` slabs of `part`; returns the launch's
// cudaGetLastError().  (Templates, so a source that never sums slabs
// compiles no sum kernel.)
template <int kUnused = 0>
cudaError_t split_sum(const float* part, float* y, long long mn,
                             int splits, cudaStream_t s) {
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  split_sum_kernel<kUnused><<<blocks, 256, 0, s>>>(part, y, mn, splits);
  return cudaGetLastError();
}

}  // namespace repro
