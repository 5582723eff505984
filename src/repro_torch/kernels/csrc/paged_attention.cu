// Paged-attention decode for Hopper (sm_90a), plain FP32, in two entries
// built from one kernel template:
//
// * paged_decode_f32 (K1): K/V write + attend in one launch.  Replaces the
//   TPU kernel repro/kernels/paged_attention.py::
//   paged_attention_decode_pallas (_decode_kernel via _call, has_write=True).
// * paged_attend_f32 (K4): the same attend with the write compiled out, over
//   read-only pools.  Replaces repro/kernels/paged_attention.py::
//   paged_attention_pallas (_call with has_write=False): the enc-dec cross
//   attention reads the cross K/V written once at admission.
//
// Per batch row b and kv head h: with kWrite and wok[b], write the step's
// new K/V row into pool[wblk[b], woff[b], h, :] in place; then one-token GQA
// attention of the G query heads over the row's block table with an
// additive mask, softcap before the mask, an online softmax in which NEG_INF
// lanes contribute exact zeros, the m_safe guard (fully-masked rows, such as
// an idle slot's cross attention with encoder length 0, give zeros, not NaN)
// and a max(l, 1e-30) divide.
//
// What bounds it on the H100: the K/V bytes of the visible blocks
// (2 * bs * hd * 4 per block and head) against ~4 * G FLOPs per byte, about
// 2 MB a gemma3-1b decode launch (B 4, KV 1, G 4, hd 256, 8 blocks of 16),
// under a microsecond at 3.35 TB/s: in practice latency bounds it, the
// chain of dependent loads and reductions of one walk over the blocks.
// Design:
// * The walk of each (b, h) is split over a thread-block cluster of S CTAs
//   (S <= 8, a portable cluster; planned in Python from T, the batch and
//   the SM count, repro_torch/kernels/paged_attention.py::kv_splits), so a
//   gemma3-1b decode launch runs 32 CTAs, not 4, and a seamless-m4t-medium
//   one 512.  Each CTA lists the row's visible blocks (a block whose bs
//   mask entries are all at or below NEG_INF / 2 adds exact zeros to the
//   online softmax, and is neither loaded nor computed; the mask row is
//   read with every load in flight at once, the row's table once into
//   shared memory) and rank r walks visible blocks r, r + S, ...  The
//   ranks' (m, l, acc) are merged by log-sum-exp in rank order through
//   distributed shared memory, each rank merging a slice of the outputs:
//   one launch, no workspace, the same bits on every run.
// * Blocks are walked in chunks of P = min(bs, 32, 4096 / hd) positions,
//   staged by cp.async into two buffers, so the next chunk loads while this
//   one is used.
// * Warp g computes head g's scores for the chunk (lanes split hd, lane j
//   keeps position j's score, its mask entry loaded while the chunk lands),
//   then the chunk's maximum, its exps and the correction, once, into
//   shared memory; every thread then reads them for the P.V sum of the
//   outputs it owns.
// * The thread count follows (G, hd): G * hd rounded up to a warp, at
//   least 128 (the warps also stage the chunks and scan the mask) and at
//   most 256, thread e owning outputs e, e + threads, ... of the G x hd
//   tile (K1 on gemma3-1b: 256 threads, 4 outputs each; K1 and K4 on
//   seamless-m4t-medium: 128 threads, the first 64 owning one each).
//   Any group G <= 16 with G * hd <= 2048 is taken (llama3-405b's 16 x
//   128, gemma2-9b's 2 x 256, llama4-scout's 5 x 128): at most 8 outputs
//   a thread, and a warp scores heads g, g + 8, ... of a chunk.  The TPU
//   kernel pads G up to its sublane tile; here no head is padded.
// Ordering (K1): the Pallas kernel wrote at grid step c == 0 of a sequential
// grid axis.  Here rank 0 of the cluster writes the row in place, and every
// CTA that reads position (wblk[b], woff[b]) takes that row from
// k_new / v_new instead of the pool, so no CTA depends on when the write
// lands: no fence and no barrier between CTAs (a cluster barrier with
// release/acquire after the write would put a cluster-wide wait before
// every walk).  No other row can read that block row: without a prefix
// cache no other row's table names the block, and CTAs of other heads
// touch other head slices.  Tiles are chosen for Hopper, not from the
// TPU's VMEM budget.
// Pool entries at masked positions are assumed finite.  The plain version
// (kernels/ref.py) and the TPU kernel multiply every masked position's V
// row by p = 0, so a NaN or Inf there gives NaN (0 * NaN); this kernel
// skips fully masked blocks, so such a value reaches its output only when
// its block also holds a visible position.  With non-finite values at
// masked positions the result would depend on the block boundaries; the
// engines' pools hold zeros or written K/V rows.
// Not yet done (later work): tensor cores for q.k and p.v, TMA.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxG = 16;              // llama3-405b: 128 heads over 8
constexpr int kMaxHd = 256;
constexpr int kMaxGH = 2048;           // G * hd: 16 x 128, 8 x 256
constexpr int kMaxOut = kMaxGH / kMaxThreads;          // outputs a thread
constexpr int kStage = 4096;            // floats per K (or V) chunk
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
  int KV, G, hd, bs, T, S, P, vec;
  float scale, softcap;
};

// kWrite false compiles the write out; the pools are then only read.
template <bool kWrite>
__global__ void __launch_bounds__(kMaxThreads)
paged_decode_kernel(const float* __restrict__ q, float* kpool, float* vpool,
                    const int* __restrict__ table,
                    const float* __restrict__ mask,
                    const float* __restrict__ knew,
                    const float* __restrict__ vnew,
                    const int* __restrict__ wblk, const int* __restrict__ woff,
                    const int* __restrict__ wok, float* __restrict__ out,
                    Shape s) {
  extern __shared__ __align__(16) float smem[];   // 3 x T ints, K[2], V[2]
  __shared__ __align__(16) float qs[kMaxGH];
  __shared__ float ps[kMaxG][32];                 // a chunk's probabilities
  __shared__ float cs[kMaxG], ms[kMaxG], ls[kMaxG];
  __shared__ int wcount[kMaxWarps];
  const int nt = blockDim.x, nw = nt >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / s.KV, h = bh % s.KV;
  const int r = blockIdx.x;                       // rank in the cluster
  const int GH = s.G * s.hd;
  const long long row = (long long)s.KV * s.hd;   // one pool position
  const long long blk_stride = (long long)s.bs * row;
  const long long src = (long long)bh * s.hd;     // k_new / v_new row
  const int tpad = (s.T + 3) & ~3;
  int* vis = reinterpret_cast<int*>(smem);        // visible blocks, in order
  int* seen = vis + tpad;                         // per block: any visible?
  int* tbl = seen + tpad;                         // the row's table
  float* buf = smem + 3 * tpad;
  const int stage = s.P * s.hd;

  int wb = -1, wo = -1;
  if (kWrite && wok[b] != 0) {
    wb = wblk[b];
    wo = woff[b];
    if (r == 0) {
      const long long dst = wb * blk_stride + wo * row + (long long)h * s.hd;
      for (int d = tid; d < s.hd; d += nt) {
        kpool[dst + d] = knew[src + d];
        vpool[dst + d] = vnew[src + d];
      }
    }
  }
  for (int e = tid; e < GH; e += nt) qs[e] = q[(long long)bh * GH + e];
  if (tid < s.G) {
    ms[tid] = REPRO_NEG_INF;
    ls[tid] = 0.f;
  }
  const int* trow = table + (long long)b * s.T;
  for (int t = tid; t < s.T; t += nt) {
    seen[t] = 0;
    tbl[t] = trow[t];
  }
  __syncthreads();
  // the row's visible blocks, in table order: every mask entry read once,
  // all in flight together, then the blocks listed by ballots
  const float* mrow = mask + (long long)b * s.T * s.bs;
  for (int i = tid; i < s.T * s.bs; i += nt)
    if (mrow[i] > REPRO_NEG_INF / 2) seen[i / s.bs] = 1;
  __syncthreads();
  int nvis = 0;
  for (int t0 = 0; t0 < s.T; t0 += nt) {
    const int t = t0 + tid;
    const bool v = t < s.T && seen[t] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = nvis;
    for (int u = 0; u < warp; ++u) off += wcount[u];
    if (v) vis[off + __popc(bal & ((1u << lane) - 1u))] = t;
    for (int u = 0; u < nw; ++u) nvis += wcount[u];
    __syncthreads();
  }

  // this rank's chunks: blocks vis[r], vis[r + S], ..., each in nck chunks
  const int nck = (s.bs + s.P - 1) / s.P;
  const int nch = (nvis > r ? (nvis - r + s.S - 1) / s.S : 0) * nck;
  auto stage_chunk = [&](int c, int into) {
    const int t = vis[r + s.S * (c / nck)];
    const int j0 = (c % nck) * s.P, jn = min(s.P, s.bs - j0);
    const long long base = tbl[t] * blk_stride + (long long)h * s.hd;
    const bool wblock = kWrite && tbl[t] == wb;
    float* kd = buf + into * stage;
    float* vd = buf + (2 + into) * stage;
    for (int j = warp; j < jn; j += nw) {
      const bool fresh = wblock && j0 + j == wo;   // the row being written
      const float* ks = fresh ? knew + src : kpool + base + (j0 + j) * row;
      const float* vs = fresh ? vnew + src : vpool + base + (j0 + j) * row;
      if (s.vec) {
        for (int d = 4 * lane; d < s.hd; d += 128) {
          cp_async16(kd + j * s.hd + d, ks + d);
          cp_async16(vd + j * s.hd + d, vs + d);
        }
      } else {
        for (int d = lane; d < s.hd; d += 32) {
          kd[j * s.hd + d] = ks[d];
          vd[j * s.hd + d] = vs[d];
        }
      }
    }
    cp_async_commit();
  };

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  if (nch > 0) stage_chunk(0, 0);
  for (int c = 0; c < nch; ++c) {
    const int st = c & 1;
    const int t = vis[r + s.S * (c / nck)];
    const int j0 = (c % nck) * s.P, jn = min(s.P, s.bs - j0);
    // lane j's mask entry, loaded while the chunk lands
    const float mj = lane < jn ? mrow[t * s.bs + j0 + lane] : 0.f;
    if (c + 1 < nch) {
      stage_chunk(c + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = buf + st * stage;
    const float* Vs = buf + (2 + st) * stage;
    // warp g: head g's scores (lane j keeps position j's), then the chunk's
    // softmax update, once
    for (int g = warp; g < s.G; g += nw) {
      float sj = REPRO_NEG_INF;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxHd / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < s.hd) dot = fmaf(qs[g * s.hd + d], Ks[j * s.hd + d], dot);
        }
        dot = warp_sum(dot);
        if (lane == j) {
          float v = dot * s.scale;
          if (s.softcap > 0.f) v = s.softcap * tanhf(v / s.softcap);
          sj = v + mj;
        }
      }
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(sj));
      const float m_safe = m_new > REPRO_NEG_INF / 2 ? m_new : 0.f;
      const float corr = expf(m_old - m_safe);
      const float p = sj > REPRO_NEG_INF / 2 ? expf(sj - m_safe) : 0.f;
      const float l_new = ls[g] * corr + warp_sum(p);
      ps[g][lane] = p;
      if (lane == 0) {
        cs[g] = corr;
        ms[g] = m_new;
        ls[g] = l_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int e = tid + i * nt;
      if (e >= GH) break;
      const int g = e / s.hd, d = e % s.hd;
      float a = acc[i] * cs[g];
#pragma unroll 4
      for (int j = 0; j < jn; ++j) a = fmaf(ps[g][j], Vs[j * s.hd + d], a);
      acc[i] = a;
    }
    __syncthreads();              // this buffer is restaged two chunks on
  }

  float* o = out + (long long)bh * GH;
  if (s.S == 1) {
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int e = tid + i * nt;
      if (e >= GH) break;
      o[e] = acc[i] / fmaxf(ls[e / s.hd], 1e-30f);
    }
    return;
  }
  // Split walk: the S CTAs of (b, h) form one cluster.  Each leaves its
  // (acc, m, l) in its own shared memory (the staging buffers are free: the
  // walk ended on a barrier, or never ran), and rank r merges outputs
  // [r * per, (r + 1) * per) by log-sum-exp in rank order:
  // out = sum_z w_z acc_z / max(sum_z w_z l_z, 1e-30), w_z = exp(m_z - max m)
  // over the ranks that saw a visible position.
  float* mine = buf;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int e = tid + i * nt;
    if (e < GH) mine[e] = acc[i];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (GH + s.S - 1) / s.S;
  const int hi = min(GH, (r + 1) * per);
  for (int e = r * per + tid; e < hi; e += nt) {
    const int g = e / s.hd;
    float mz[kMaxSplits];
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      mz[z] = z < s.S ? *cluster.map_shared_rank(&ms[g], z) : REPRO_NEG_INF;
      mx = fmaxf(mx, mz[z]);
    }
    const float m_safe = mx > REPRO_NEG_INF / 2 ? mx : 0.f;
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      if (z >= s.S) break;
      const float wz = mz[z] > REPRO_NEG_INF / 2 ? expf(mz[z] - m_safe) : 0.f;
      L += wz * *cluster.map_shared_rank(&ls[g], z);
      a += wz * cluster.map_shared_rank(mine, z)[e];
    }
    o[e] = a / fmaxf(L, 1e-30f);
  }
  cluster.sync();                 // the other ranks' memory outlives the reads
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// dims = {B, KV, G, hd, bs, T, S, threads}, as planned by
// repro_torch/kernels/paged_attention.py (S a power of two up to 8).
template <bool kWrite>
int launch(const float* q, float* kpool, float* vpool, const int* table,
           const float* mask, const float* knew, const float* vnew,
           const int* wblk, const int* woff, const int* wok, float* out,
           const int* dims, float scale, float softcap, void* stream) {
  const int B = dims[0], KV = dims[1], G = dims[2], hd = dims[3];
  const int bs = dims[4], T = dims[5], S = dims[6], nt = dims[7];
  if (B < 1 || KV < 1 || G < 1 || G > kMaxG || hd < 1 || hd > kMaxHd ||
      G * hd > kMaxGH || bs < 1 || T < 1 || S < 1 || S > kMaxSplits || (S & (S - 1)) != 0 ||
      nt < 32 || nt > kMaxThreads || nt % 32 != 0 ||
      (G * hd + nt - 1) / nt > kMaxOut)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = min(bs, min(32, kStage / hd));
  const int vec = hd % 4 == 0 && aligned16(kpool) && aligned16(vpool) &&
                  (!kWrite || (aligned16(knew) && aligned16(vnew)));
  Shape s{KV, G, hd, bs, T, S, P, vec, scale, softcap};
  const size_t smem =
      sizeof(float) * (3 * ((T + 3) & ~3) + max(4 * P * hd, G * hd));
  // allow the dynamic shared memory above 48 KB, once per size and device
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && !(dev < 64 && allowed[dev] >= smem)) {
    e = cudaFuncSetAttribute(paged_decode_kernel<kWrite>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) allowed[dev] = smem;
  }
  // the S CTAs of one (b, h) (grid x) form one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, B * KV);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_decode_kernel<kWrite>, q, kpool, vpool,
                         table, mask, knew, vnew, wblk, woff, wok, out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs = {q, k_pool, v_pool, table, mask, k_new, v_new, wblk, woff, wok,
// out} and dims = {B, KV, G, hd, bs, T, S, threads}: two host arrays, so a
// ctypes call converts 5 arguments, not 20.
extern "C" int paged_decode_f32(void* const* ptrs, const int* dims,
                                float scale, float softcap, void* stream) {
  return launch<true>(
      static_cast<const float*>(ptrs[0]), static_cast<float*>(ptrs[1]),
      static_cast<float*>(ptrs[2]), static_cast<const int*>(ptrs[3]),
      static_cast<const float*>(ptrs[4]), static_cast<const float*>(ptrs[5]),
      static_cast<const float*>(ptrs[6]), static_cast<const int*>(ptrs[7]),
      static_cast<const int*>(ptrs[8]), static_cast<const int*>(ptrs[9]),
      static_cast<float*>(ptrs[10]), dims, scale, softcap, stream);
}

// ptrs = {q, k_pool, v_pool, table, mask, out}; the pools are only read.
extern "C" int paged_attend_f32(void* const* ptrs, const int* dims,
                                float scale, float softcap, void* stream) {
  return launch<false>(
      static_cast<const float*>(ptrs[0]), static_cast<float*>(ptrs[1]),
      static_cast<float*>(ptrs[2]), static_cast<const int*>(ptrs[3]),
      static_cast<const float*>(ptrs[4]), nullptr, nullptr, nullptr,
      nullptr, nullptr, static_cast<float*>(ptrs[5]), dims, scale, softcap,
      stream);
}
