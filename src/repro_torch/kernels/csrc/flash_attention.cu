// Flash attention (prefill) for Hopper (sm_90a): blocked GQA attention with
// an online softmax over KV blocks, causal or not, any sequence length.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention
// (Pallas body _kernel). Same contract: scale 1/sqrt(D), masking with -1e30,
// fp32 running max / sum / accumulator, l clamped at 1e-30, output in the
// input type; KV blocks wholly in the future are skipped. Unlike the TPU
// kernel (which asserts S % block == 0) it masks the ragged tail, because
// the engine's prompts have any length.
//
// What bounds it on this card: operations. A 64-row q block reuses each
// K/V block for 64 query rows, so prefill at S ~ 10^3 does ~S/2 flops per
// byte moved — above the ridge. This first version does them on CUDA cores
// in fp32 (exact against the plain version, 15x below the bf16 tensor-core
// peak); what the design already does about the bound is to keep the score
// tile and the running state on chip (shared memory and registers), so the
// (S, S) score matrix never reaches HBM, and to skip the future half of the
// causal blocks. Tensor cores (mma/wgmma), TMA and warp specialisation are
// later work.
//
// Layouts: q (B, H, S, D); k, v (B, Hkv, S, D); out (B, H, S, D).
// One CTA per (64-row q block, q head, batch); 128 threads, two per q row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;    // q rows and kv rows per tile
constexpr int kThreads = 128; // two threads per q row
constexpr int kHalf = kBlock / 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int h, int hkv,
             int s, int causal, float scale) {
  constexpr int DS = D + 1;          // padded row stride (bank spread)
  constexpr int SS = kBlock + 1;
  constexpr int DH = D / 2;          // output dims owned by one thread
  const int qb = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 1;            // q row within the block
  const int half = tid & 1;          // which half of the kv columns / dims
  const int q0 = qb * kBlock;
  const int qpos = q0 + r;

  extern __shared__ float smem[];
  float* qs = smem;                  // (kBlock, DS)
  float* ks = qs + kBlock * DS;      // (kBlock, DS)
  float* vs = ks + kBlock * DS;      // (kBlock, DS)
  float* ps = vs + kBlock * DS;      // (kBlock, SS) probabilities

  const long long qbase = ((long long)b * h + head) * s * D;
  const long long kbase = ((long long)b * hkv + kvh) * s * D;
  for (int i = tid; i < kBlock * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    qs[rr * DS + c] = (q0 + rr < s) ? to_f(q[qbase + (long long)(q0 + rr) * D + c]) : 0.f;
  }

  float acc[DH];
#pragma unroll
  for (int x = 0; x < DH; ++x) acc[x] = 0.f;
  float m = kNegInf, l = 0.f;

  const int nkv_all = (s + kBlock - 1) / kBlock;
  const int nkv = causal ? min(qb + 1, nkv_all) : nkv_all;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // previous tile consumed (and the q tile loaded)
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int t = i / D, c = i % D;
      const bool ok = k0 + t < s;
      const long long off = kbase + (long long)(k0 + t) * D + c;
      ks[t * DS + c] = ok ? to_f(k[off]) : 0.f;
      vs[t * DS + c] = ok ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[kHalf];
#pragma unroll
    for (int c = 0; c < kHalf; ++c) sc[c] = 0.f;
    const float* qr = qs + r * DS;
    const float* kr = ks + half * kHalf * DS;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qr[dd];
#pragma unroll
      for (int c = 0; c < kHalf; ++c) sc[c] = fmaf(qv, kr[c * DS + dd], sc[c]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const int kpos = k0 + half * kHalf + c;
      const bool ok = kpos < s && (!causal || kpos <= qpos);
      sc[c] = ok ? sc[c] * scale : kNegInf;
      mx = fmaxf(mx, sc[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    float* pr = ps + r * SS + half * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const float p = expf(sc[c] - m_new);
      pr[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the partner's half of this row's probabilities is visible

    const float* prow = ps + r * SS;
    const float* vcol = vs + half * DH;
#pragma unroll
    for (int x = 0; x < DH; ++x) acc[x] *= corr;
    for (int t = 0; t < kBlock; ++t) {
      const float p = prow[t];
      const float* vr = vcol + t * DS;
#pragma unroll
      for (int x = 0; x < DH; ++x) acc[x] = fmaf(p, vr[x], acc[x]);
    }
  }

  if (qpos < s) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + qbase + (long long)qpos * D + half * DH;
#pragma unroll
    for (int x = 0; x < DH; ++x) orow[x] = from_f<T>(acc[x] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int hkv, int s, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kBlock * (D + 1) + kBlock * (kBlock + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((s + kBlock - 1) / kBlock, h, b);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, hkv, s, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int h, int hkv, int s, int d, int causal, cudaStream_t stream) {
  if (d == 16) return launch<T, 16>(q, k, v, out, b, h, hkv, s, causal, stream);
  if (d == 32) return launch<T, 32>(q, k, v, out, b, h, hkv, s, causal, stream);
  if (d == 64) return launch<T, 64>(q, k, v, out, b, h, hkv, s, causal, stream);
  if (d == 128) return launch<T, 128>(q, k, v, out, b, h, hkv, s, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, 64, 128}. Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int h,
                                     int hkv, int s, int d, int causal,
                                     int dtype, void* stream) {
  if (b == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, out, b, h, hkv, s, d, causal, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, b, h, hkv, s, d, causal, st);
}
