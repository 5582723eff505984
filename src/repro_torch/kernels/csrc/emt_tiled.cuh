// K3's experts entry at M > 16 (emt_matmul.cu, emt_matmul_experts_f32):
// for each of E experts, out (M, N) = x (M, K) @ noisy(w) with w (K, N)
// n-major, the RTN noise hashed per element inside the tile.  (K3's other
// calls at M > 16 and its backward run on the 3xTF32 tensor-core template,
// emt_tc.cuh; the experts' M > 16 case needs a capacity above 16, which no
// served path reaches.)
//
// Design: a 64 x 64 output tile per CTA, 32-deep reduction tiles, float4
// loads of w's rows.  The raw w and x tiles of the next reduction tile are
// loaded into registers while this tile's FMAs run, then hashed into the
// other of two shared-memory buffers (one barrier a tile); every w element
// is hashed once per 64-row tile.  Grid z holds E experts times the slabs
// of K (z = e * splits + slab, the host's plan, repro_torch/kernels/
// splitk.py): expert e reads its x rows and weight at the Experts strides,
// hashes at rows e * K + k of the folded stack, writes its slab's (M, N)
// partial at out + (slab * E + e) * M * N, and the CTAs of the first row
// tile (each weight element is hashed once a row tile) sum |w'| and take
// its max for the stack's statistics (common.cuh cta_stats).
#pragma once
#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int kTiledThreads = 256;
constexpr int kTBM = 64, kTBN = 64, kTBK = 32;

template <int NS>
__global__ void __launch_bounds__(kTiledThreads, 2)
emt_tiled(const float* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ out, const float* __restrict__ sig_ptr, int M,
          int N, int K, int k_slab, long long sxm, long long sxk,
          long long swk, int vw, int xvec, uint32_t seed, uint32_t plane,
          NoiseParams np, Experts ex) {
  __shared__ __align__(16) float ws[2][kTBK][kTBN];
  __shared__ __align__(16) float xs[2][kTBK][kTBM + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;                  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;                  // rows ty*4 .. ty*4+3
  const int m0 = blockIdx.y * kTBM;
  const int n0 = blockIdx.x * kTBN;
  const int splits = (K + k_slab - 1) / k_slab;
  const int ei = blockIdx.z / splits;               // the expert
  const int zs = blockIdx.z % splits;
  const int kb = zs * k_slab;
  const int ke = min(K, kb + k_slab);
  x += ei * ex.sxe;
  w += ei * ex.swe;
  const uint32_t row0 = (uint32_t)ei * (uint32_t)K;
  const uint32_t pk = hash_pk(seed, plane);
  Factors F;
  make_factors(np, *sig_ptr, F);
  // loader coordinates: x by (row, 8-deep K run)
  const int ln = tid & 63, lq = tid >> 6;
  // this thread's share of the stack's sum and max of |w'|
  const bool stats = blockIdx.y == 0;
  double ssum = 0.0;
  float smax = 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 wr[2], xr[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + kTiledThreads * r, k = k0 + (e >> 4);
      wr[r] = k < ke ? load_n4(w, k * swk, n0 + 4 * (e & 15), N, vw)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      const int m = m0 + ln, kx = k0 + 8 * lq + 4 * r;
      if (m >= M) {
        xr[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (xvec && kx + 3 < ke) {
        xr[r] = __ldg(reinterpret_cast<const float4*>(x + m * sxm + kx));
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = kx + j < ke ? __ldg(x + m * sxm + (kx + j) * sxk) : 0.f;
        xr[r] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_tile = [&](int buf, int k0) {               // the hash
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + kTiledThreads * r, kk = e >> 4, c = 4 * (e & 15);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = noisy<NS>(f4(wr[r], j), row0 + (uint32_t)(k0 + kk),
                         (uint32_t)(n0 + c + j), pk, F);
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
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xs[buf][8 * lq + 4 * r + j][ln] = f4(xr[r], j);
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
  const int n_ex = gridDim.z / splits;
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
  cta_stats<kTiledThreads>(ssum, smax, ex.stats);
}

// Launch emt_tiled<NS> over E experts' (M, N) outputs in `splits` slabs of
// `k_slab` reduction rows each.
template <int NS>
void launch_tiled(const float* x, const float* w, float* out,
                  const float* sig, int M, int N, int K, int k_slab,
                  long long sxm, long long sxk, long long swk, int vw,
                  int xvec, uint32_t seed, uint32_t plane,
                  const NoiseParams& np, int splits, int E,
                  const Experts& ex, cudaStream_t s) {
  dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM, splits * E);
  emt_tiled<NS><<<grid, kTiledThreads, 0, s>>>(x, w, out, sig, M, N, K,
                                               k_slab, sxm, sxk, swk, vw,
                                               xvec, seed, plane, np, ex);
}

}  // namespace repro
