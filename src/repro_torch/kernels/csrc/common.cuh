// Shared device helpers for the port's Hopper kernels: the counter-hash RNG
// (bit-exact with repro_torch/core/hashrng.py and repro/core/hashrng.py) and
// the RTN state lookup.
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

}  // namespace repro
