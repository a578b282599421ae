// Paged attention for Hopper (sm_90a) over a KV cache scattered across
// fixed-size physical pages: the decode step (one query token per sequence)
// and the verify step of self-speculative decoding (Sq query tokens per
// sequence at consecutive positions).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:paged_attention
// (Pallas body _kernel) and :paged_attention_verify (body _verify_kernel).
// Same contract: scale 1/sqrt(D), masking with -1e30, fp32 running max /
// sum / accumulator, l clamped at 1e-30, output in the input type. Each CTA
// walks only the pages below its deepest row's causal bound and never more
// than the table's maxp columns, so a position past the slot's capacity
// (a spec tick near max_cache) reads no other row's table entries.
//
// What bounds it on this card: bytes. Each decode or verify step reads every
// live K/V position of its sequence once and does 4*R*D flops per position
// for the R = Sq*G query rows of a kv head (G = 3 at smollm-360m, so 15 rows
// for a 5-row verify), far below the ~295 flop/byte the H100 needs before
// compute matters. The design therefore spends nothing on tensor cores: one
// CTA per (sequence, kv head) holds all R query rows in shared memory, so
// each K/V page is read from HBM exactly once for every query that shares
// it, and rows of a page are loaded by consecutive threads (coalesced D-wide
// rows). The TPU kernels got the block table by scalar prefetch; here the CTA
// reads table[b, j] itself. Split-K over pages, cp.async/TMA double-buffering
// and wgmma are later work.
//
// Rows of a CTA are (query, group) row-major: row r is query r / G, group
// lane r % G, and attends kpos <= first + r / G, where first is the
// sequence's first query position (decode: lengths[b] - 1; verify: pos[b]).
//
// Layouts: decode q (B, Hkv, G, D), lengths (B,) int32; verify q
// (B, Hkv, Sq*G, D), pos (B,) int32; k_pages, v_pages (P, page, Hkv, D);
// table (B, maxp) int32; out shaped as q.
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

// One CTA: the `rows` = sq * g query rows of kv head h of sequence b, whose
// first query sits at position `first`.
template <typename T>
__device__ __forceinline__ void paged_body(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, T* __restrict__ out, int first, int hkv,
    int g, int sq, int d, int page, int maxp, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int rows = sq * g;
  const int ds = d + 1;  // padded row stride: row-parallel reads hit distinct banks

  extern __shared__ float smem[];
  float* qs = smem;                 // (rows, ds)
  float* ks = qs + rows * ds;       // (page, ds)
  float* vs = ks + page * ds;       // (page, ds)
  float* ss = vs + page * ds;       // (rows, page) scores, then probabilities
  float* acc = ss + rows * page;    // (rows, d)
  float* m = acc + rows * d;        // (rows) running max
  float* l = m + rows;              // (rows) running sum
  float* corr = l + rows;           // (rows) rescale of this page

  const long long qbase = ((long long)b * hkv + h) * rows * d;
  for (int i = tid; i < rows * d; i += kThreads) {
    qs[(i / d) * ds + i % d] = to_f(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < rows; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  // pages holding positions 0 .. first + sq - 1, capped at the table width
  const int npages = min(maxp, (first + sq + page - 1) / page);
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
    for (int i = tid; i < rows * page; i += kThreads) {
      const int r = i / page, t = i % page;
      const float* qr = qs + r * ds;
      const float* kr = ks + t * ds;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
      s *= scale;
      ss[i] = (j * page + t <= first + r / g) ? s : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
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
    for (int i = tid; i < rows * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const float* pr = ss + r * page;
      float a = acc[i] * corr[r];
      for (int t = 0; t < page; ++t) a = fmaf(pr[t], vs[t * ds + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * d; i += kThreads) {
    const float lr = fmaxf(l[i / d], 1e-30f);
    out[qbase + i] = from_f<T>(acc[i] / lr);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int g, int d, int page, int maxp, float scale) {
  paged_body<T>(q, kp, vp, table, out, lengths[blockIdx.x] - 1, hkv, g, 1, d,
                page, maxp, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out, int hkv,
                    int g, int sq, int d, int page, int maxp, float scale) {
  paged_body<T>(q, kp, vp, table, out, pos[blockIdx.x], hkv, g, sq, d, page,
                maxp, scale);
}

size_t smem_bytes(int rows, int d, int page) {
  const int ds = d + 1;
  return sizeof(float) * ((size_t)rows * ds + 2 * (size_t)page * ds +
                          (size_t)rows * page + (size_t)rows * d +
                          3 * (size_t)rows);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* first, void* out, int b, int hkv, int g, int sq, int d,
           int page, int maxp, bool verify, cudaStream_t stream) {
  const size_t smem = smem_bytes(sq * g, d, page);
  const float scale = 1.0f / sqrtf((float)d);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(kp);
  const T* tv = static_cast<const T*>(vp);
  T* to = static_cast<T*>(out);
  cudaError_t err;
  if (verify) {
    err = cudaFuncSetAttribute(paged_verify_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    paged_verify_kernel<T><<<dim3(b, hkv), kThreads, smem, stream>>>(
        tq, tk, tv, table, first, to, hkv, g, sq, d, page, maxp, scale);
  } else {
    err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    paged_decode_kernel<T><<<dim3(b, hkv), kThreads, smem, stream>>>(
        tq, tk, tv, table, first, to, hkv, g, d, page, maxp, scale);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* kp, const void* vp, const void* table,
             const void* first, void* out, int b, int hkv, int g, int sq,
             int d, int page, int maxp, int dtype, bool verify, void* stream) {
  if (b == 0) return 0;
  const int* tbl = static_cast<const int*>(table);
  const int* fst = static_cast<const int*>(first);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kp, vp, tbl, fst, out, b, hkv, g, sq, d, page,
                         maxp, verify, s);
  return launch<__nv_bfloat16>(q, kp, vp, tbl, fst, out, b, hkv, g, sq, d,
                               page, maxp, verify, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lengths, void* out, int b,
                                     int hkv, int g, int d, int page, int maxp,
                                     int dtype, void* stream) {
  return dispatch(q, k_pages, v_pages, table, lengths, out, b, hkv, g, 1, d,
                  page, maxp, dtype, false, stream);
}

extern "C" int repro_paged_attention_verify(const void* q, const void* k_pages,
                                            const void* v_pages,
                                            const void* table, const void* pos,
                                            void* out, int b, int hkv, int g,
                                            int sq, int d, int page, int maxp,
                                            int dtype, void* stream) {
  return dispatch(q, k_pages, v_pages, table, pos, out, b, hkv, g, sq, d,
                  page, maxp, dtype, true, stream);
}
