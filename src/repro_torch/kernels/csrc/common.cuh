// Shared device helpers for the port's Hopper kernels: the counter-hash RNG
// (bit-exact with repro_torch/core/hashrng.py and repro/core/hashrng.py),
// the RTN state lookup, and the split-K slab sum shared by the noisy matmul
// kernels (planned in repro_torch/kernels/splitk.py).
#pragma once
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

__device__ __forceinline__ uint32_t hash_counters(uint32_t seed, uint32_t row,
                                                  uint32_t col, uint32_t plane) {
  return hash_mix(hash_rc(row, col), hash_pk(seed, plane));
}

// RTN state table: thresholds are the cumulative state probabilities as
// float32, offsets the normalized state offsets as float32 (both computed on
// the host exactly as hashrng.py computes them).
constexpr int kMaxStates = 8;
struct NoiseParams {
  int n_states;
  float thr[kMaxStates - 1];
  float off[kMaxStates];
};

__device__ __forceinline__ float state_offset(uint32_t bits,
                                              const NoiseParams& p) {
  // uint32 -> float32 round-to-nearest, times 2^-32 (exact)
  const float u = __fmul_rn(__uint2float_rn(bits), 0x1p-32f);
  int state = 0;
#pragma unroll
  for (int i = 0; i < kMaxStates - 1; ++i)
    if (i < p.n_states - 1 && u >= p.thr[i]) state = i + 1;
  return p.off[state];
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
