// K3's tiled noisy matmul (emt_matmul.cu, M > 16): out (M, N) = x (M, K) @
// noisy(w) with w (K, N) of any strides, the RTN noise hashed per element
// at (row k, col n) inside the tile.  (K3's backward runs on the 3xTF32
// tensor-core template, emt_tc.cuh.)
//
// Design: a 64 x 64 output tile per CTA, 32-deep reduction tiles, float4
// loads along whichever of w's strides is 1.  The raw w and x tiles of the
// next reduction tile are loaded into registers while this tile's FMAs
// run, then hashed into the other of two shared-memory buffers (one
// barrier a tile); every w element is hashed once per 64-row tile.  Split
// along K by the host's plan (repro_torch/kernels/splitk.py): CTA z writes
// its partial sums to out + z * M * N.
//
// The weight loader is a template parameter: float32 (I8 false), or int8
// conductance levels with a float32 scale per column (I8 true, store_int8
// serving).  The int8 loader reads the 32 x 64 tile (2 KB) in 16-byte
// loads, 16 levels each, by lanes 0-15 of every warp; lane l + 16 takes
// the upper 8 levels of lane l's load by two shuffles, and every lane
// dequantizes its 8 as fl(float(q) * scale[n]) and noises them as the
// float loader does, into the same float32 shared-memory tile: the FMA
// loop is the float path's.
//
// EX (K3's experts entry, n-major float32 weights): grid z holds E experts
// times the slabs (z = e * splits + slab); expert e reads its x rows and
// weight at the Experts strides, hashes at rows e * K + k of the folded
// stack, writes its slab's (M, N) partial at out + (slab * E + e) * M * N,
// and the CTAs of the first row tile (each weight element is hashed once
// a row tile) sum |w'| and take its max for the stack's statistics
// (common.cuh cta_stats).
#pragma once
#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int kTiledThreads = 256;
constexpr int kTBM = 64, kTBN = 64, kTBK = 32;

// KC: w is not n-contiguous (swn != 1; the load runs along k).  I8: w is
// int8 levels and `scale` their per-column scale (else unused).  EX: a
// stack of experts (above; float32 n-major weights only).
template <bool KC, int NS, bool I8, bool EX>
__global__ void __launch_bounds__(kTiledThreads, 2)
emt_tiled(const float* __restrict__ x, const void* __restrict__ wv,
          const float* __restrict__ scale, float* __restrict__ out,
          const float* __restrict__ sig_ptr, int M, int N, int K, int k_slab,
          long long sxm, long long sxk, long long swk, long long swn, int vw,
          int xvec, uint32_t seed, uint32_t plane, NoiseParams np,
          Experts ex) {
  static_assert(!(EX && (KC || I8)), "experts: float32 n-major weights");
  __shared__ __align__(16) float ws[2][kTBK][kTBN];
  __shared__ __align__(16) float xs[2][kTBK][kTBM + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;                  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;                  // rows ty*4 .. ty*4+3
  const int m0 = blockIdx.y * kTBM;
  const int n0 = blockIdx.x * kTBN;
  const int splits = EX ? (K + k_slab - 1) / k_slab : 1;
  const int ei = EX ? blockIdx.z / splits : 0;      // the expert
  const int zs = EX ? blockIdx.z % splits : blockIdx.z;
  const int kb = zs * k_slab;
  const int ke = min(K, kb + k_slab);
  if constexpr (EX) x += ei * ex.sxe;
  const uint32_t row0 = EX ? (uint32_t)ei * (uint32_t)K : 0u;
  const uint32_t pk = hash_pk(seed, plane);
  Factors F;
  make_factors(np, *sig_ptr, F);
  // loader coordinates: n-major weights by (row, 4-column group); k-major
  // weights and x by (column or row, 8-deep K run)
  const int ln = tid & 63, lq = tid >> 6;
  const float* __restrict__ w =
      static_cast<const float*>(wv) + (EX ? ei * ex.swe : 0);
  // EX: this thread's share of the stack's sum and max of |w'|
  const bool stats = EX && blockIdx.y == 0;
  double ssum = 0.0;
  float smax = 0.f;
  // int8 loader: load e (lanes 0-15 of each warp) covers 16 levels of
  // n-major row e / 4 from column 16 * (e % 4), or of k-major column e / 2
  // from row 16 * (e % 2); lane l + 16 dequantizes the upper 8 of lane l's
  const int8_t* __restrict__ wq = static_cast<const int8_t*>(wv);
  const int lane = tid & 31, half = lane >> 4;
  const int e8 = (tid >> 5) * 16 + (lane & 15);
  const int qk = KC ? 16 * (e8 & 1) : e8 >> 2;            // tile row
  const int qn = KC ? e8 >> 1 : 16 * (e8 & 3);            // tile column
  float sc[KC ? 1 : 8];
  if constexpr (I8) {
#pragma unroll
    for (int j = 0; j < (KC ? 1 : 8); ++j) {
      const int n = n0 + qn + (KC ? 0 : 8 * half + j);
      sc[j] = n < N ? __ldg(scale + n) : 0.f;
    }
  }
  // the noisy value of element (k, n), hashed at (row0 + k, n)
  auto hashed = [&](float v, int k, int n) {
    return noisy<NS>(v, row0 + (uint32_t)k, (uint32_t)n, pk, F);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 wr[2], xr[2];
  uint4 q8 = make_uint4(0u, 0u, 0u, 0u);
  auto load_tile = [&](int k0) {
    if constexpr (I8) {
      if (lane < 16) {
        if constexpr (KC) {
          const int n = n0 + qn, k = k0 + qk;
          q8 = load_q16(wq + n * swn + k * swk, swk,
                        n < N ? min(16, ke - k) : 0, vw == 16);
        } else {
          const int k = k0 + qk, n = n0 + qn;
          q8 = load_q16(wq + k * swk + n, 1, k < ke ? min(16, N - n) : 0,
                        vw == 16);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (I8) {
      } else if constexpr (KC) {
        wr[r] = load_k4(w, k0 + 8 * lq + 4 * r, ke, n0 + ln, N, swk, swn, vw);
      } else {
        const int e = tid + kTiledThreads * r, k = k0 + (e >> 4);
        wr[r] = k < ke ? load_n4(w, k * swk, n0 + 4 * (e & 15), N, vw)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const int m = m0 + ln, k = k0 + 8 * lq + 4 * r;
      if (m >= M) {
        xr[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (xvec && k + 3 < ke) {
        xr[r] = __ldg(reinterpret_cast<const float4*>(x + m * sxm + k));
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = k + j < ke ? __ldg(x + m * sxm + (k + j) * sxk) : 0.f;
        xr[r] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_tile = [&](int buf, int k0) {               // the hash
    if constexpr (I8) {
      // lane l + 16 takes words z, w (levels 8-15) of lane l's load
      const uint32_t hz = __shfl_sync(0xffffffffu, q8.z, lane & 15);
      const uint32_t hw = __shfl_sync(0xffffffffu, q8.w, lane & 15);
      const uint32_t lo = half ? hz : q8.x, hi = half ? hw : q8.y;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? lo : hi;
        const int kk = qk + (KC ? 8 * half + j : 0);
        const int c = qn + (KC ? 0 : 8 * half + j);
        v[j] = hashed(dequant(word, j & 3, sc[KC ? 0 : j]), k0 + kk, n0 + c);
      }
      if constexpr (KC) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ws[buf][qk + 8 * half + j][qn] = v[j];
      } else {
        const int c = qn + 8 * half;
        *reinterpret_cast<float4*>(&ws[buf][qk][c]) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(&ws[buf][qk][c + 4]) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (I8) {
      } else if constexpr (KC) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = 8 * lq + 4 * r + j;
          ws[buf][kk][ln] = hashed(f4(wr[r], j), k0 + kk, n0 + ln);
        }
      } else {
        const int e = tid + kTiledThreads * r, kk = e >> 4, c = 4 * (e & 15);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = hashed(f4(wr[r], j), k0 + kk, n0 + c + j);
        if (stats) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a = fabsf(v[j]);
            ssum += a;
            smax = fmaxf(smax, a);
          }
        }
        *reinterpret_cast<float4*>(&ws[buf][kk][c]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[buf][8 * lq + 4 * r + j][ln] = f4(xr[r], j);
    }
  };

  const int nt = (ke - kb + kTBK - 1) / kTBK;
  load_tile(kb);
  store_tile(0, kb);
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) load_tile(kb + (t + 1) * kTBK);     // in flight
#pragma unroll 8
    for (int kk = 0; kk < kTBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = f4(a, i);
        acc[i][0] = fmaf(ai, b.x, acc[i][0]);
        acc[i][1] = fmaf(ai, b.y, acc[i][1]);
        acc[i][2] = fmaf(ai, b.z, acc[i][2]);
        acc[i][3] = fmaf(ai, b.w, acc[i][3]);
      }
    }
    if (t + 1 < nt) store_tile(buf ^ 1, kb + (t + 1) * kTBK);
    __syncthreads();
  }

  // slab zs of expert ei (E = gridDim.z / splits)
  const int n_ex = EX ? gridDim.z / splits : 1;
  float* o = out + ((long long)zs * n_ex + ei) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) o[(long long)m * N + n] = acc[i][j];
    }
  }
  if constexpr (EX) cta_stats<kTiledThreads>(ssum, smax, ex.stats);
}

// Launch emt_tiled<KC, NS, I8, EX> over an (M, N) output (of each of E
// experts, EX) in `splits` slabs of `k_slab` reduction rows.
template <int NS, bool I8, bool EX>
void launch_tiled(const float* x, const void* w, const float* scale,
                  float* out, const float* sig, int M, int N, int K,
                  int k_slab, long long sxm, long long sxk, long long swk,
                  long long swn, int vw, int xvec, uint32_t seed,
                  uint32_t plane, const NoiseParams& np, bool kc, int splits,
                  int E, const Experts& ex, cudaStream_t s) {
  dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM, splits * E);
  if constexpr (EX) {
    emt_tiled<false, NS, false, true><<<grid, kTiledThreads, 0, s>>>(
        x, w, scale, out, sig, M, N, K, k_slab, sxm, sxk, swk, swn, vw, xvec,
        seed, plane, np, ex);
  } else if (kc) {
    emt_tiled<true, NS, I8, false><<<grid, kTiledThreads, 0, s>>>(
        x, w, scale, out, sig, M, N, K, k_slab, sxm, sxk, swk, swn, vw, xvec,
        seed, plane, np, ex);
  } else {
    emt_tiled<false, NS, I8, false><<<grid, kTiledThreads, 0, s>>>(
        x, w, scale, out, sig, M, N, K, k_slab, sxm, sxk, swk, swn, vw, xvec,
        seed, plane, np, ex);
  }
}

}  // namespace repro
