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
// bf16) and does ~2 flops per weight byte. At prefill and verify (C ~ 250-320,
// most rows live) it does ~C/2 flops per weight byte: operations. What every
// body does about it: the grid is fixed from the shapes (E x row tiles x
// column tiles) and group_sizes stays on the device, so the host never syncs;
// a CTA whose row tile starts at or past its expert's live rows writes zeros
// and returns without reading that expert's weights; only live rows of x are
// read. Two bodies, chosen by dtype and shape:
//
// * bf16 with D and F multiples of 8 and 16-byte-aligned pointers ("mma",
//   the main path): 64 x 64 output tiles on the tensor cores, four warps of
//   32 x 32 running mma.sync m16n8k16 (bf16 in, fp32 accumulate) from
//   ldmatrix fragments (the weight tile by ldmatrix.trans). A 4-stage ring
//   of XOR-swizzled shared tiles is filled by 16-byte cp.async, so three
//   K steps of weights are in flight per CTA; x's rows past the live ones
//   are zero-filled by the copy's source size (never read), and a warp
//   whose rows are all dead issues no mma. The K step is 64 where the grid
//   fits on the card at three CTAs per SM (the decode gate / up shape: 320
//   CTAs, each streaming its expert's 1536 x 64 weight panel), else 32
//   (32 KB of ring: the decode down shape's 960 CTAs, of which the dead
//   ones exit at once, and the prefill shapes' many waves).
// * fp32, or a D / F that is not a multiple of 8 ("cuda_core"): the first
//   version, fp32 FMAs on CUDA cores from shared-memory tiles.
//
// Layouts: x (E, C, D), w (E, D, F), group_sizes (E,) int32, out (E, C, F),
// all contiguous. One CTA per (64-column tile, 64-row tile, expert). The
// CUDA-core body runs 256 threads as 16 x 16, each owning 4 consecutive
// rows x 4 columns strided by 16 (so the live rows of a sparse decode
// buffer fall to the first threads).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tensor_core.cuh"

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

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------
using namespace repro_tc;

// One output tile of BM x BN per CTA, K step BK, a STAGES-deep cp.async
// ring; warps of WM x WN (WM / 16 row fragments x WN / 8 column fragments).
template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct Tiles {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int kXC = BK / 8;        // 16-byte chunks per x tile row
  static constexpr int kWC = BN / 8;        // 16-byte chunks per w tile row
  static constexpr int kXT = BM * kXC;      // 16-byte units per x tile
  static constexpr int kWT = BK * kWC;      // 16-byte units per w tile
  static constexpr int kMF = WM / 16;       // row fragments per warp
  static constexpr int kNF = WN / 8;        // column fragments per warp
  static constexpr size_t kSmem = sizeof(uint4) * STAGES * (kXT + kWT);
  static_assert(kNF % 2 == 0 && kWT % kThreads == 0 && BK % 16 == 0, "tile");
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__((Tiles<BM, BN, BK, WM, WN, STAGES>::kThreads))
moe_gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ group_sizes,
                   __nv_bfloat16* __restrict__ out, int c, int d, int f) {
  using T = Tiles<BM, BN, BK, WM, WN, STAGES>;
  constexpr int kThr = T::kThreads, XC = T::kXC, WC = T::kWC, XT = T::kXT,
                WT = T::kWT, MF = T::kMF, NF = T::kNF;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int live = min(max(group_sizes[e], 0), c);
  const int nlive = min(BM, live - m0);   // live rows in this tile
  __nv_bfloat16* __restrict__ o = out + (long long)e * c * f;

  if (nlive <= 0) {  // no live row: zeros, and the expert's weights are not read
    for (int i = tid; i < BM * WC; i += kThr) {
      const int r = m0 + i / WC, col = n0 + (i % WC) * 8;
      if (r < c && col < f)
        *reinterpret_cast<uint4*>(o + (long long)r * f + col) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ uint4 smem4[];
  const uint32_t xs = smem_u32(smem4);            // STAGES x XT units
  const uint32_t ws = xs + STAGES * XT * 16;      // STAGES x WT units
  const __nv_bfloat16* __restrict__ xe = x + (long long)e * c * d;
  const __nv_bfloat16* __restrict__ we = w + (long long)e * d * f;
  // rows the mma reads: the live rows, rounded up to a 16-row fragment
  const int xrows = min(BM, (nlive + 15) & ~15);
  const int nk = (d + BK - 1) / BK;

  // This thread's copies, fixed across K steps: x chunk tid + i * kThr
  // (i < XI, while inside the rows the mma reads) and w chunk tid + i * kThr.
  constexpr int XI = (BM * XC + kThr - 1) / kThr, WI = WT / kThr;
  uint32_t x_dst[XI], w_dst[WI];
  const __nv_bfloat16* x_src[XI];
  const __nv_bfloat16* w_src[WI];
  int x_col[XI], w_row[WI];        // column of x / row of w within a step
  bool x_copy[XI], x_live[XI], w_live[WI];
#pragma unroll
  for (int i = 0; i < XI; ++i) {
    const int u = tid + i * kThr, r = u / XC, ch = u % XC;
    x_copy[i] = u < xrows * XC;
    x_live[i] = r < nlive;
    x_dst[i] = swz<XC>(r, ch) * 16;
    x_col[i] = ch * 8;
    x_src[i] = xe + (long long)(m0 + (x_live[i] ? r : 0)) * d + ch * 8;
  }
#pragma unroll
  for (int i = 0; i < WI; ++i) {
    const int u = tid + i * kThr, r = u / WC, ch = u % WC;
    w_live[i] = n0 + ch * 8 < f;
    w_dst[i] = swz<WC>(r, ch) * 16;
    w_row[i] = r;
    w_src[i] = we + (long long)r * f + (w_live[i] ? n0 + ch * 8 : 0);
  }

  // one K step into ring slot st; copies past D or F, and rows past the
  // live ones, are zero-filled (nothing is read for them)
  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      if (!x_copy[i]) break;
      const bool ok = x_live[i] && k0 + x_col[i] < d;
      cp_async16(xs + st * XT * 16 + x_dst[i], ok ? x_src[i] + k0 : xe,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const bool ok = w_live[i] && k0 + w_row[i] < d;
      cp_async16(ws + st * WT * 16 + w_dst[i],
                 ok ? w_src[i] + (long long)k0 * f : we, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }

  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  // row fragments of this warp that hold a live row (0 .. MF)
  const int mfrag = min(MF, max(0, (nlive - wm * WM + 15) / 16));
  float acc[MF][NF][4];
#pragma unroll
  for (int a = 0; a < MF; ++a)
#pragma unroll
    for (int b = 0; b < NF; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();    // step kt has landed
    __syncthreads();                // ... for every thread; step kt-1 is consumed
    {
      const int kn = kt + STAGES - 1;
      if (kn < nk) load_stage(kn % STAGES, kn);
      cp_async_commit();
    }
    if (mfrag == 0) continue;
    const uint32_t xt = xs + (kt % STAGES) * XT * 16;
    const uint32_t wt = ws + (kt % STAGES) * WT * 16;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t bf[NF][2];
#pragma unroll
      for (int np = 0; np < NF / 2; ++np)
        ldsm_x4_trans(wt + swz<WC>(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   wn * (WN / 8) + np * 2 + (lane >> 4)) * 16,
                      bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0], bf[2 * np + 1][1]);
#pragma unroll
      for (int mt = 0; mt < MF; ++mt) {
        if (mt >= mfrag) break;
        uint32_t af[4];
        ldsm_x4(xt + swz<XC>(wm * WM + mt * 16 + (lane & 15),
                             ks * 2 + (lane >> 4)) * 16,
                af[0], af[1], af[2], af[3]);
#pragma unroll
        for (int nt = 0; nt < NF; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the CTA

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MF; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * WM + mt * 16 + hf * 8 + g;   // row in the tile
      if (m0 + r >= c) continue;
      const bool row_live = r < nlive;
      __nv_bfloat16* orow = o + (long long)(m0 + r) * f;
#pragma unroll
      for (int nt = 0; nt < NF; ++nt) {
        const int col = n0 + wn * WN + nt * 8 + 2 * t;
        if (col >= f) continue;
        *reinterpret_cast<uint32_t*>(orow + col) =
            row_live ? pack_bf16(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1])
                     : 0u;
      }
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
int launch_mma(const void* x, const void* w, const int* sizes, void* out,
               int e, int c, int d, int f, cudaStream_t stream) {
  using T = Tiles<BM, BN, BK, WM, WN, STAGES>;
  auto kernel = moe_gmm_mma_kernel<BM, BN, BK, WM, WN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  if ((c + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((f + BN - 1) / BN, (c + BM - 1) / BM, e);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      sizes, static_cast<__nv_bfloat16*>(out), c, d, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CUDA-core launcher
// ---------------------------------------------------------------------------
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

// dtype: 0 = float32, 1 = bfloat16. Writes the body it takes to *path: 1
// ("mma") for bf16 with D and F multiples of 8 and 16-byte-aligned pointers
// (what cp.async needs), else 0 ("cuda_core"). Returns cudaGetLastError().
extern "C" int repro_moe_gmm(const void* x, const void* w,
                             const void* group_sizes, void* out, int e, int c,
                             int d, int f, int dtype, void* stream, int* path) {
  using repro_tc::aligned16;
  *path = dtype == 1 && d % 8 == 0 && f % 8 == 0 && aligned16(x) &&
          aligned16(w) && aligned16(out);
  if (e == 0 || c == 0 || f == 0) return 0;
  if (e > 65535 || (c + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  if (*path) {
    // K step 64 (64 KB of ring, three CTAs per SM) where the whole grid is
    // resident at that occupancy, else 32 (32 KB, up to seven per SM)
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    const long long ctas = (long long)e * ((c + kBM - 1) / kBM) * ((f + kBN - 1) / kBN);
    if (ctas <= 3LL * sms)
      return launch_mma<64, 64, 64, 32, 32, 4>(x, w, sizes, out, e, c, d, f, st);
    return launch_mma<64, 64, 32, 32, 32, 4>(x, w, sizes, out, e, c, d, f, st);
  }
  if (dtype == 0) return launch<float>(x, w, sizes, out, e, c, d, f, st);
  return launch<__nv_bfloat16>(x, w, sizes, out, e, c, d, f, st);
}
