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
// Ordering (K1): the Pallas kernel wrote at grid step c == 0 of a sequential
// grid axis.  Here one CTA owns (b, h): it writes, __syncthreads(), and only
// then reads, so the row always sees its own write.  No other CTA can read
// that block row while it is written: without a prefix cache no other row's
// table names the block, and CTAs of other heads touch other head slices.
//
// What bounds it on the H100: the K/V view bytes (2 * T * bs * hd * 4 per
// row and head) against ~4 * G FLOPs per byte: memory and, at serving
// batch sizes, latency.  Design: one 256-thread CTA per (b, h) walks the
// table one block at a time with the block's (bs x hd) K and V tiles in
// shared memory (32 KB at bs = 16, hd = 256 in f32); thread d owns output
// column d of all G heads, warps compute the G x bs scores.  With B = 4 and
// one kv head there are only 4 CTAs on 132 SMs (K1 on gemma3-1b); the cross
// attention of seamless-m4t-medium (16 kv heads, hd 64) gives 64 CTAs of
// which only 64 threads each own an output column.  Slow by design: skipping
// the blocks past a row's last visible position and split-KV
// (flash-decoding, with the write in the owning CTA or a pre-pass) are later
// work.  Tiles are chosen for Hopper, not from the TPU's VMEM budget.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kWrite false compiles the write out; the pools are then only read (the
// read-only entry casts its const pools to the shared signature).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, float* kpool, float* vpool,
                    const int* __restrict__ table,
                    const float* __restrict__ mask,
                    const float* __restrict__ knew,
                    const float* __restrict__ vnew,
                    const int* __restrict__ wblk, const int* __restrict__ woff,
                    const int* __restrict__ wok, float* __restrict__ out,
                    int KV, int G, int hd, int bs, int T, float scale,
                    float softcap) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [bs][hd]
  float* Vs = Ks + bs * hd;         // [bs][hd]
  float* qs = Vs + bs * hd;         // [G][hd]
  float* ps = qs + G * hd;          // [G][bs]
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;
  const long long row = (long long)KV * hd;      // one pool position
  const long long blk_stride = (long long)bs * row;

  if (kWrite && wok[b] != 0) {
    const long long dst = wblk[b] * blk_stride + woff[b] * row + h * hd;
    const long long src = ((long long)b * KV + h) * hd;
    for (int d = tid; d < hd; d += kThreads) {
      kpool[dst + d] = knew[src + d];
      vpool[dst + d] = vnew[src + d];
    }
  }
  for (int e = tid; e < G * hd; e += kThreads)
    qs[e] = q[((long long)b * KV + h) * G * hd + e];
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) { m[g] = REPRO_NEG_INF; l[g] = 0.f; acc[g] = 0.f; }

  for (int t = 0; t < T; ++t) {
    const long long base = (long long)table[b * T + t] * blk_stride + h * hd;
    for (int e = tid; e < bs * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      Ks[e] = kpool[base + j * row + d];
      Vs[e] = vpool[base + j * row + d];
    }
    __syncthreads();
    for (int i = warp; i < G * bs; i += nwarps) {
      const int g = i / bs, j = i % bs;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += qs[g * hd + d] * Ks[j * hd + d];
      part = warp_sum(part);
      if (lane == 0) {
        float s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ps[i] = s + mask[(long long)b * T * bs + t * bs + j];
      }
    }
    __syncthreads();
    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float mx = REPRO_NEG_INF;
        for (int j = 0; j < bs; ++j) mx = fmaxf(mx, ps[g * bs + j]);
        const float m_new = fmaxf(m[g], mx);
        const float m_safe = m_new > REPRO_NEG_INF / 2 ? m_new : 0.f;
        const float corr = expf(m[g] - m_safe);
        float sum = 0.f, a = 0.f;
        for (int j = 0; j < bs; ++j) {
          const float s = ps[g * bs + j];
          const float p = s > REPRO_NEG_INF / 2 ? expf(s - m_safe) : 0.f;
          sum += p;
          a += p * Vs[j * hd + tid];
        }
        l[g] = l[g] * corr + sum;
        acc[g] = acc[g] * corr + a;
        m[g] = m_new;
      }
    }
    __syncthreads();
  }
  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      out[(((long long)b * KV + h) * G + g) * hd + tid] =
          acc[g] / fmaxf(l[g], 1e-30f);
    }
  }
}

template <bool kWrite>
int launch(const float* q, float* kpool, float* vpool, const int* table,
           const float* mask, const float* knew, const float* vnew,
           const int* wblk, const int* woff, const int* wok, float* out, int B,
           int KV, int G, int hd, int bs, int T, float scale, float softcap,
           void* stream) {
  if (G > kMaxG || hd > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * bs * hd + G * hd + G * bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<kWrite>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, KV);
  paged_decode_kernel<kWrite><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, table, mask, knew, vnew, wblk, woff, wok, out, KV, G,
      hd, bs, T, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_f32(const float* q, float* kpool, float* vpool,
                                const int* table, const float* mask,
                                const float* knew, const float* vnew,
                                const int* wblk, const int* woff,
                                const int* wok, float* out, int B, int KV,
                                int G, int hd, int bs, int T, float scale,
                                float softcap, void* stream) {
  return launch<true>(q, kpool, vpool, table, mask, knew, vnew, wblk, woff,
                      wok, out, B, KV, G, hd, bs, T, scale, softcap, stream);
}

extern "C" int paged_attend_f32(const float* q, const float* kpool,
                                const float* vpool, const int* table,
                                const float* mask, float* out, int B, int KV,
                                int G, int hd, int bs, int T, float scale,
                                float softcap, void* stream) {
  return launch<false>(q, const_cast<float*>(kpool), const_cast<float*>(vpool),
                       table, mask, nullptr, nullptr, nullptr, nullptr,
                       nullptr, out, B, KV, G, hd, bs, T, scale, softcap,
                       stream);
}
