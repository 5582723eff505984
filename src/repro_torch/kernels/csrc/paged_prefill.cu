// Flash-style chunked prefill over the paged KV cache for Hopper (sm_90a),
// plain FP32.
//
// Replaces the TPU kernel repro/kernels/paged_prefill.py::
// paged_prefill_pallas (_prefill_kernel).  The (B, C, H, hd) query chunk is
// regrouped by the wrapper to (B, KV, R = C * G, hd); each row attends the
// K/V resolved through its block table with causality derived in the
// kernel (position p is visible to row r iff p <= qpos[b, r]), softcap
// before the mask, and an online softmax (NEG_INF lanes exact zeros, m_safe
// guard, max(l, 1e-30) divide, so a fully masked row gives exact zeros).
// Positions past qlast[b] = max(qpos[b]) are neither loaded nor computed,
// as the TPU kernel skips its dead chunks.
//
// What bounds it on the H100: the K/V bytes up to qlast and ~4 FLOPs per
// (row, position, dim): at the gemma3-1b chunk shape (B 4, KV 1, R 64,
// hd 256, 8 blocks of 16) about 1 MB a launch, 0.3 us at the H100 SXM's
// published 3.35 TB/s, so in practice latency does: the walk over the
// blocks is a chain of dependent loads, and the old kernel's 32 CTAs each
// walked all of it with every thread redoing the softmax.
// Design:
// * One warp per query row (kRT = 4 rows a CTA share the staged K/V); lanes
//   split hd (lane l holds dims l, l + 32, ...) for q, the q.k dot products
//   and the P.V accumulation.  Each score and probability is computed once,
//   by the lane of its position, and broadcast with a shuffle.
// * K/V are walked in chunks of P logical positions (P = min(32, 4096 / hd),
//   any block size: lane j resolves position j of the chunk through the
//   table), staged in shared memory by cp.async into two buffers, so the
//   next chunk loads while this one is used.
// * The walk of each row tile is split across `splits` (1, 2, 4 or 8) CTAs,
//   planned in Python from the SM count so the chunk step fills the card
//   (64 row tiles x 4 = 256 CTAs at the gemma3 chunk shape).  The CTAs of one row tile
//   form a thread-block cluster: each leaves its rows' (m, l, acc) in its
//   shared memory and rank 0 merges them by log-sum-exp in rank order
//   (deterministic), so one launch does it all, with no workspace.
// Not yet done (later work): tensor cores for q.k and p.v, TMA.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRT = 4;                  // query rows per CTA (one warp each)
constexpr int kThreads = 32 * kRT;
constexpr int kMaxHd = 256;
constexpr int kDPL = kMaxHd / 32;       // dims per lane
constexpr int kStage = 4096;            // floats per K (or V) stage
constexpr int kMaxSplits = 8;           // a portable cluster

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Shape {
  int KV, R, hd, bs, T, P, splits, vec;
  float scale, softcap;
};

// Stage positions p0 .. p0 + P - 1 (those <= last) of kv head h of table
// row `trow` into Kd / Vd ([P][hd]).  Lane j resolves position p0 + j's
// row through the table once; warps take positions in turn, lanes the
// position's dims (16-byte cp.async pieces, or floats when hd % 4 != 0).
__device__ __forceinline__ void stage_chunk(
    float* Kd, float* Vd, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int* __restrict__ trow, int p0,
    int last, int h, const Shape& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)s.KV * s.hd;
  const int pl = p0 + lane;
  const long long off_l =
      lane < s.P && pl <= last
          ? trow[pl / s.bs] * (long long)s.bs * row + (pl % s.bs) * row +
                (long long)h * s.hd
          : 0;
  const int jn = min(s.P, last - p0 + 1);
  for (int j = warp; j < jn; j += kRT) {
    const long long off = __shfl_sync(0xffffffffu, off_l, j);
    float* kd = Kd + j * s.hd;
    float* vd = Vd + j * s.hd;
    if (s.vec) {
      for (int d = 4 * lane; d < s.hd; d += 128) {
        cp_async16(kd + d, kpool + off + d);
        cp_async16(vd + d, vpool + off + d);
      }
    } else {
      for (int d = lane; d < s.hd; d += 32) {
        kd[d] = kpool[off + d];
        vd[d] = vpool[off + d];
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ kpool,
                     const float* __restrict__ vpool,
                     const int* __restrict__ table,
                     const int* __restrict__ qpos,
                     const int* __restrict__ qlast, float* __restrict__ out,
                     Shape s) {
  extern __shared__ __align__(16) float smem[];     // K[2][stage], V[2][stage]
  __shared__ int s_qmax[kRT];
  const int bh = blockIdx.x, b = bh / s.KV, h = bh % s.KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.y * kRT + warp;
  const bool live = r < s.R;
  const int stage = s.P * s.hd;
  const long long qrow = ((long long)bh * s.R + r) * s.hd;

  const int qp = live ? qpos[b * s.R + r] : -1;
  if (lane == 0) s_qmax[warp] = qp;
  float qr[kDPL], acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = live && d < s.hd ? q[qrow + d] : 0.f;
    acc[i] = 0.f;
  }
  __syncthreads();
  int last = s_qmax[0];
#pragma unroll
  for (int w = 1; w < kRT; ++w) last = max(last, s_qmax[w]);
  last = min(last, min(qlast[b], s.T * s.bs - 1));
  // this split's chunks of the CTA's visible range
  const int nch = last >= 0 ? (last + s.P) / s.P : 0;
  const int per = (nch + s.splits - 1) / s.splits;
  const int c0 = blockIdx.z * per, c1 = min(nch, c0 + per);
  const int* trow = table + (long long)b * s.T;

  float m = REPRO_NEG_INF, l = 0.f;
  if (c0 < c1)
    stage_chunk(smem, smem + 2 * stage, kpool, vpool, trow, c0 * s.P, last, h,
                s);
  for (int c = c0; c < c1; ++c) {
    const int st = (c - c0) & 1;
    if (c + 1 < c1) {
      stage_chunk(smem + (st ^ 1) * stage, smem + (2 + (st ^ 1)) * stage,
                  kpool, vpool, trow, (c + 1) * s.P, last, h, s);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = smem + st * stage;
    const float* Vs = smem + (2 + st) * stage;
    const int p0 = c * s.P;
    const int jn = min(s.P, last - p0 + 1);         // loaded positions
    if (live) {
      // lane j: score of position p0 + j (softcap, then the causal mask)
      float sj = REPRO_NEG_INF;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int d = lane + 32 * i;
          if (d < s.hd) dot = fmaf(qr[i], Ks[j * s.hd + d], dot);
        }
        dot = warp_sum(dot);
        if (lane == j) {
          float v = dot * s.scale;
          if (s.softcap > 0.f) v = s.softcap * tanhf(v / s.softcap);
          sj = v + (p0 + j <= qp ? 0.f : REPRO_NEG_INF);
        }
      }
      const float m_new = fmaxf(m, warp_max(sj));
      const float m_safe = m_new > REPRO_NEG_INF / 2 ? m_new : 0.f;
      const float corr = expf(m - m_safe);
      const float pj = sj > REPRO_NEG_INF / 2 ? expf(sj - m_safe) : 0.f;
      l = l * corr + warp_sum(pj);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[i] *= corr;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int d = lane + 32 * i;
          if (d < s.hd) acc[i] = fmaf(pb, Vs[j * s.hd + d], acc[i]);
        }
      }
      m = m_new;
    }
    __syncthreads();              // this buffer is restaged two chunks on
  }
  if (s.splits == 1) {
    if (!live) return;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < s.hd) out[qrow + d] = acc[i] / den;
    }
    return;
  }
  // Split walk: the `splits` CTAs of this row tile form one cluster.  Each
  // puts its rows' (acc, m, l) in its own shared memory (the staging
  // buffers are free: the loop ended on a barrier), and rank 0 merges them
  // by log-sum-exp in rank order: out = sum_z w_z acc_z / max(sum_z w_z l_z,
  // 1e-30), w_z = exp(m_z - max m) over the ranks that saw a visible
  // position.
  const int stride = s.hd + 2;
  float* mine = smem + warp * stride;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    if (d < s.hd) mine[d] = acc[i];
  }
  if (lane == 0) {
    mine[s.hd] = m;
    mine[s.hd + 1] = l;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && live) {
    const float* pz[kMaxSplits];
    float mz[kMaxSplits], wz[kMaxSplits];
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      pz[z] = z < s.splits ? cluster.map_shared_rank(mine, z) : mine;
      mz[z] = z < s.splits ? pz[z][s.hd] : REPRO_NEG_INF;
      mx = fmaxf(mx, mz[z]);
    }
    const float m_safe = mx > REPRO_NEG_INF / 2 ? mx : 0.f;
    float L = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      wz[z] = z < s.splits && mz[z] > REPRO_NEG_INF / 2
                  ? expf(mz[z] - m_safe) : 0.f;
      if (z < s.splits) L += wz[z] * pz[z][s.hd + 1];
    }
    const float den = fmaxf(L, 1e-30f);
    for (int d = lane; d < s.hd; d += 32) {
      float a = 0.f;
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < s.splits) a += wz[z] * pz[z][d];
      out[qrow + d] = a / den;
    }
  }
  cluster.sync();                 // the other ranks' memory outlives the reads
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dims = {B, KV, R, hd, bs, T, splits} (one host array, so a ctypes call
// converts 11 arguments, not 17).  `splits` (1, 2, 4 or 8) CTAs share each
// row tile's K/V walk as one cluster, as planned by
// repro_torch/kernels/paged_prefill.py::kv_splits.
extern "C" int paged_prefill_f32(const float* q, const float* kpool,
                                 const float* vpool, const int* table,
                                 const int* qpos, const int* qlast, float* out,
                                 const int* dims, float scale, float softcap,
                                 void* stream) {
  const int B = dims[0], KV = dims[1], R = dims[2], hd = dims[3];
  const int bs = dims[4], T = dims[5], splits = dims[6];
  if (hd < 1 || hd > kMaxHd || splits < 1 || splits > kMaxSplits ||
      (splits & (splits - 1)) != 0 || B < 1 || KV < 1 || R < 1 || bs < 1 ||
      T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = min(32, kStage / hd);
  const int vec = hd % 4 == 0 && aligned16(kpool) && aligned16(vpool);
  Shape s{KV, R, hd, bs, T, P, splits, vec, scale, softcap};
  const size_t smem = sizeof(float) * 4 * P * hd;
  // allow the largest staging (4 * kStage floats, 64 KB) once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && !(dev < 64 && opted_in[dev])) {
    e = cudaFuncSetAttribute(paged_prefill_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * 4 * kStage));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) opted_in[dev] = true;
  }
  // the `splits` CTAs of a row tile (grid z) form one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV, (R + kRT - 1) / kRT, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_prefill_kernel, q, kpool, vpool, table,
                         qpos, qlast, out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
