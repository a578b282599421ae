// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends over a KV cache scattered across fixed-size physical pages.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:paged_attention
// (Pallas body _kernel). Same contract: scale 1/sqrt(D), masking with -1e30,
// fp32 running max / sum / accumulator, l clamped at 1e-30, output in the
// input type; pages at or beyond a sequence's length are never touched, so
// the null page 0 is never read live.
//
// What bounds it on this card: bytes. Each decoded token reads every live
// K/V position of its sequence once and does 4*G*D flops per position
// (G = 3 at smollm-360m), far below the ~295 flop/byte the H100 needs
// before compute matters. The design therefore spends nothing on tensor
// cores: one CTA per (sequence, kv head) holds the whole GQA group, so each
// K/V page is read from HBM exactly once for all G query heads that share
// it, and rows of a page are loaded by consecutive threads (coalesced D-wide
// rows). The TPU kernel got the block table by scalar prefetch; here the
// CTA reads table[b, j] itself. Split-K over pages, cp.async/TMA
// double-buffering and wgmma are later work.
//
// Layouts: q (B, Hkv, G, D); k_pages, v_pages (P, page, Hkv, D);
// table (B, maxp) int32; lengths (B,) int32; out (B, Hkv, G, D).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int g, int d, int page, int maxp, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int ds = d + 1;  // padded row stride: row-parallel reads hit distinct banks

  extern __shared__ float smem[];
  float* qs = smem;                 // (g, ds)
  float* ks = qs + g * ds;          // (page, ds)
  float* vs = ks + page * ds;       // (page, ds)
  float* ss = vs + page * ds;       // (g, page) scores, then probabilities
  float* acc = ss + g * page;       // (g, d)
  float* m = acc + g * d;           // (g) running max
  float* l = m + g;                 // (g) running sum
  float* corr = l + g;              // (g) rescale of this page

  const int len = lengths[b];
  const long long qbase = ((long long)b * hkv + h) * g * d;
  for (int i = tid; i < g * d; i += kThreads) {
    qs[(i / d) * ds + i % d] = to_f(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int npages = (len + page - 1) / page;
  for (int j = 0; j < npages; ++j) {
    const long long pg = table[(long long)b * maxp + j];
    __syncthreads();  // previous page fully consumed (and q/acc initialised)
    for (int i = tid; i < page * d; i += kThreads) {
      const int t = i / d, c = i % d;
      const long long off = ((pg * page + t) * hkv + h) * d + c;
      ks[t * ds + c] = to_f(kp[off]);
      vs[t * ds + c] = to_f(vp[off]);
    }
    __syncthreads();
    for (int i = tid; i < g * page; i += kThreads) {
      const int r = i / page, t = i % page;
      const float* qr = qs + r * ds;
      const float* kr = ks + t * ds;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
      s *= scale;
      ss[i] = (j * page + t < len) ? s : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < g; r += kThreads) {
      float* sr = ss + r * page;
      float mx = m[r];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(sr[t] - mx);
        sr[t] = p;
        sum += p;
      }
      const float c = expf(m[r] - mx);
      corr[r] = c;
      l[r] = l[r] * c + sum;
      m[r] = mx;
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const float* pr = ss + r * page;
      float a = acc[i] * corr[r];
      for (int t = 0; t < page; ++t) a = fmaf(pr[t], vs[t * ds + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += kThreads) {
    const float lr = fmaxf(l[i / d], 1e-30f);
    out[qbase + i] = from_f<T>(acc[i] / lr);
  }
}

size_t smem_bytes(int g, int d, int page) {
  const int ds = d + 1;
  return sizeof(float) * ((size_t)g * ds + 2 * (size_t)page * ds +
                          (size_t)g * page + (size_t)g * d + 3 * (size_t)g);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* out, int b, int hkv, int g, int d,
           int page, int maxp, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d, page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)d);
  paged_decode_kernel<T><<<dim3(b, hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(out), hkv, g,
      d, page, maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lengths, void* out, int b,
                                     int hkv, int g, int d, int page, int maxp,
                                     int dtype, void* stream) {
  if (b == 0) return 0;
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tbl, lens, out, b, hkv, g, d,
                         page, maxp, s);
  return launch<__nv_bfloat16>(q, k_pages, v_pages, tbl, lens, out, b, hkv, g,
                               d, page, maxp, s);
}
