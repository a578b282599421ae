// Grouped matmul for MoE expert compute on Hopper (sm_90a):
// (E, C, D) x (E, D, F) -> (E, C, F), fp32 accumulation, output in the input
// type, rows >= group_sizes[e] exactly zero.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py:moe_gmm (Pallas body _kernel).
// Contract of its oracle, ref.py::gmm_ref, for any input: the TPU kernel skips
// whole row blocks past an expert's live rows and relies on callers to pass
// zero rows inside a partly live block; here every dead row is masked, so the
// output is zero there whatever x holds. C, D and F need not be multiples of
// a tile (the engine's capacities are 64, 252, 320...): the ragged edges are
// masked. The TPU kernel asserts divisibility.
//
// What bounds it on this card: at decode, bytes. Eight slots route 64
// assignments over 40 experts, ~1.6 live rows per expert in a 64-row buffer,
// so the call is the read of the live experts' weights (~1.5 MB each in
// bf16) and does ~2 flops per weight byte. At prefill (C ~ 100-320, most rows
// live) it does ~C/2 flops per weight byte: operations. What the design does
// about it: the grid is fixed from the shapes (E x row tiles x column
// tiles) and group_sizes stays on the device, so the host never syncs; a CTA
// whose row tile starts at or past its expert's live rows writes zeros and
// returns without reading that expert's weights; inside a live tile, only the
// threads that own live rows do arithmetic and only live rows of x are read.
// Each weight tile is read from HBM once per row tile. This first version
// multiplies on CUDA cores in fp32 from shared-memory tiles; tensor cores
// (mma.sync / wgmma), TMA and a fused gate-up-SiLU epilogue are later work.
//
// Layouts: x (E, C, D), w (E, D, F), group_sizes (E,) int32, out (E, C, F),
// all contiguous. One CTA per (64-column tile, 64-row tile, expert); 256
// threads as 16 x 16, each owning 4 consecutive rows x 4 columns strided by
// 16 (so the live rows of a sparse decode buffer fall to the first threads).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBM = 64;      // rows per tile
constexpr int kBN = 64;      // columns per tile
constexpr int kBK = 16;      // contraction depth per shared-memory step
constexpr int kTM = 4;       // rows per thread (consecutive)
constexpr int kTN = 4;       // columns per thread (strided by kBN / kTN)
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kColStride = kBN / kTN;                 // 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ group_sizes, T* __restrict__ out,
               int c, int d, int f) {
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kColStride;   // column group
  const int ty = tid / kColStride;   // row group
  const int live = min(max(group_sizes[e], 0), c);
  const int nlive = min(kBM, live - m0);   // live rows in this tile
  T* __restrict__ o = out + (long long)e * c * f;

  if (nlive <= 0) {  // no live row: zeros, and the expert's weights are not read
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = m0 + i / kBN, col = n0 + i % kBN;
      if (r < c && col < f) o[(long long)r * f + col] = from_f<T>(0.f);
    }
    return;
  }

  __shared__ float as[kBK][kBM + 4];   // x tile, transposed: as[k][row]
  __shared__ float bs[kBK][kBN + 4];   // w tile: bs[k][col]
  const T* __restrict__ xe = x + (long long)e * c * d;
  const T* __restrict__ we = w + (long long)e * d * f;
  const bool computes = ty * kTM < nlive;   // owns at least one live row

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gk = k0 + kk;
      as[kk][r] = (r < nlive && gk < d)
                      ? to_f(xe[(long long)(m0 + r) * d + gk]) : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, col = i % kBN;
      const int gk = k0 + kk, gc = n0 + col;
      bs[kk][col] = (gk < d && gc < f) ? to_f(we[(long long)gk * f + gc]) : 0.f;
    }
    __syncthreads();
    if (computes) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = as[kk][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = bs[kk][tx + j * kColStride];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // the tiles are consumed before the next step loads
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    if (m0 + r >= c) break;
    const bool row_live = r < nlive;
    T* orow = o + (long long)(m0 + r) * f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + j * kColStride;
      if (col < f) orow[col] = from_f<T>(row_live ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* sizes, void* out, int e,
           int c, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  moe_gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), sizes,
      static_cast<T*>(out), c, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int repro_moe_gmm(const void* x, const void* w,
                             const void* group_sizes, void* out, int e, int c,
                             int d, int f, int dtype, void* stream) {
  if (e == 0 || c == 0 || f == 0) return 0;
  if (e > 65535 || (c + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  if (dtype == 0) return launch<float>(x, w, sizes, out, e, c, d, f, st);
  return launch<__nv_bfloat16>(x, w, sizes, out, e, c, d, f, st);
}
