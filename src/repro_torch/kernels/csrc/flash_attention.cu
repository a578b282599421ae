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
// byte moved, above the ridge. Two bodies, chosen by dtype:
//
// * bf16 ("mma", the main path): FA2-style on the tensor cores. One CTA of
//   eight warps per (64-row q block, q head, batch): two groups of four
//   warps, each warp owning 16 q rows, split the KV loop between them (even
//   and odd KV tiles) and merge their softmax states at the end, so the
//   heaviest causal block's serial chain is half its tiles. K / V slots of
//   two tiles arrive by 16-byte cp.async in a double-buffered ring of
//   XOR-swizzled shared tiles (ldmatrix without bank conflicts). Up to D =
//   128 a tile is 64 rows and the Q fragments stay in registers; at D = 256
//   (gemma-7b, paligemma-3b) a tile is 32 rows, so that Q and the ring take
//   160 KB of the 227 KB a block may have (64-row tiles would take 288 KB),
//   and the Q fragments are re-read by ldmatrix at each k step (held, they
//   would take 64 registers beside the output accumulator's 128: 16 rows x
//   256 fp32 over a warp). S = Q K^T and O += P V run on
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate), the online softmax in
//   registers with exp2f on pre-scaled scores. P goes from
//   the S accumulators to the A fragments of the PV product in registers,
//   rounded to bf16 (the TPU kernel keeps P in fp32; the JAX package's
//   _sdpa rounds it to bf16 as here); V is read with ldmatrix.trans. q
//   blocks launch heaviest first, so the causal triangle leaves no tail
//   wave. The score matrix never reaches HBM. What still costs: every warp
//   reads the whole K and V tile from shared memory for its own mma.sync B
//   fragments (64 KB per q block and KV tile), where wgmma would read them
//   once per warpgroup. At D = 256 that traffic (with the Q re-reads, 40 KB
//   a warp for each 32-row tile's 128 mma) and the whole K / V prefix
//   copied into every q block's CTA bound the body, one CTA an SM.
// * fp32 ("cuda_core"): the first version on CUDA cores in fp32, exact to
//   summation order against the plain version (tensor cores would need
//   TF32, three decimal digits). bf16 whose pointers are not 16-byte
//   aligned (cp.async's unit) takes it too, and bf16 at the head dim 112
//   (tensor_core.cuh:mma_dim). Two threads per q row.
//
// Layouts: q (B, H, S, D); k, v (B, Hkv, S, D); out (B, H, S, D).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlock = 64;    // q rows and kv rows per tile
constexpr int kThreads = 128; // two per q row, or four warps of 16 q rows
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

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kGroups = 2;                     // warp groups splitting the KV loop
constexpr int kMmaThreads = kGroups * kThreads;   // 8 warps

// KV rows of one group's tile: 64, or 32 at D = 256 (the ring's shared
// memory); a ring slot holds one tile per group.
template <int D>
__host__ __device__ constexpr int kv_rows() { return D > 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int kv_step() { return kGroups * kv_rows<D>(); }
// Q fragments held in registers (KD x 4 a thread) up to D = 128
template <int D>
__host__ __device__ constexpr bool hold_q() { return D <= 128; }

using namespace repro_tc;

// Copy rows [r0, r0 + ROWS) of a (s, D) bf16 matrix into a swizzled ROWS x D
// tile by 16-byte cp.async; rows at or past s are zero-filled (not read).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint4* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int s, int tid) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += kMmaThreads) {
    const int row = i / CPR, ch = i % CPR;
    const bool ok = r0 + row < s;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + row) * D + ch * 8 : src;
    cp_async16(smem_u32(dst + swz<CPR>(row, ch)), g, ok ? 16 : 0);
  }
}

// Eight warps per (64-row q block, q head, batch): warp group g (warps
// 4g .. 4g+3, 16 q rows each) runs the online softmax over KV tiles g,
// g + 2, g + 4, ... (each ring slot holds two KVR-row tiles, one per group),
// which halves the serial KV chain of the heaviest causal blocks; the two
// partial (max, sum, output) states are merged at the end.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int h, int hkv, int s,
                 int causal, float scale_log2) {
  constexpr int CPR = D / 8;            // 16-byte chunks per row
  constexpr int KVR = kv_rows<D>();     // KV rows of one group's tile
  constexpr int KS = kv_step<D>();      // KV rows of a ring slot
  constexpr int QT = kBlock * CPR;      // 16-byte units of the Q tile
  constexpr int KVT = KS * CPR;         // 16-byte units of a K or V ring slot
  constexpr int KD = D / 16;            // k steps over D (S = Q K^T)
  constexpr int ND = D / 8;             // 8-wide output column tiles
  constexpr int NK = KVR / 8;           // 8-wide score column tiles
  constexpr bool HQ = hold_q<D>();
  const int head = blockIdx.x, b = blockIdx.z;
  const int qb = gridDim.y - 1 - blockIdx.y;   // heaviest q block first
  const int kvh = head / (h / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / 4, rw = warp % 4;     // warp group, row slab
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBlock;
  const int row0 = q0 + rw * 16 + g;    // this thread's rows: row0, row0 + 8

  extern __shared__ uint4 smem4[];
  uint4* qs = smem4;                    // QT
  uint4* ks = qs + QT;                  // kStages x KVT
  uint4* vs = ks + kStages * KVT;       // kStages x KVT

  const __nv_bfloat16* qg = q + ((long long)b * h + head) * s * D;
  const long long kvoff = ((long long)b * hkv + kvh) * s * D;
  const __nv_bfloat16* kg = k + kvoff;
  const __nv_bfloat16* vg = v + kvoff;

  // KVR-row tiles: all of them, or (causal) those starting before the q
  // block's last row
  const int nkv_all = (s + KVR - 1) / KVR;
  const int nkv = causal ? min((q0 + kBlock + KVR - 1) / KVR, nkv_all)
                         : nkv_all;
  const int nsteps = (nkv + kGroups - 1) / kGroups;           // ring slots

  // prologue: Q and the first kStages - 1 slots, one group per slot
  load_tile<D, kBlock>(qs, qg, q0, s, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nsteps) {
      load_tile<D, KS>(ks + st * KVT, kg, st * KS, s, tid);
      load_tile<D, KS>(vs + st * KVT, vg, st * KS, s, tid);
    }
    cp_async_commit();
  }

  uint32_t qf[HQ ? KD : 1][4];          // (HQ) the Q fragments
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;     // running max, scaled log2 domain
  float l0 = 0.f, l1 = 0.f;             // this thread's part of the row sums

  for (int j = 0; j < nsteps; ++j) {
    cp_async_wait<kStages - 2>();       // slot j (and Q) have landed
    __syncthreads();                    // ... for every thread; slot j-1 is consumed
    {
      const int jn = j + kStages - 1;
      if (jn < nsteps) {
        load_tile<D, KS>(ks + (jn % kStages) * KVT, kg, jn * KS, s, tid);
        load_tile<D, KS>(vs + (jn % kStages) * KVT, vg, jn * KS, s, tid);
      }
      cp_async_commit();
    }
    if constexpr (HQ) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_a<CPR>(qs, rw * 16, kk, lane, qf[kk]);
      }
    }
    const int tile = j * kGroups + grp;   // this group's KV tile
    if (tile >= nkv) continue;
    const int r_kv = grp * KVR;           // its first row in the slot
    const uint4* kt = ks + (j % kStages) * KVT;
    const uint4* vt = vs + (j % kStages) * KVT;

    // S = Q K^T: 16 rows x KVR kv columns per warp
    float sc[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (HQ) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_a<CPR>(qs, rw * 16, kk, lane, qa);
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt + swz<CPR>(r_kv + np * 16 + (lane & 7) + (lane >> 4) * 8,
                                       kk * 2 + ((lane >> 3) & 1))),
                b0, b1, b2, b3);
        mma_bf16(sc[2 * np], qa, b0, b1);
        mma_bf16(sc[2 * np + 1], qa, b2, b3);
      }
    }

    // scale into the log2 domain; mask the ragged tail and the future. With
    // 32-row tiles a warp's rows may all precede a tile; its running max
    // then stays put (or, on group 1's first tile of q block 0, stays -1e30
    // with a junk sum that the merge weights by exp2(-1e30 - m) = 0: group
    // 0's tile 0 holds a live key of every row).
    const int k0 = tile * KVR;
    const bool masked = k0 + KVR > s ||
                        (causal && k0 + KVR - 1 > q0 + rw * 16);
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale_log2;
        if (masked) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (kpos >= s || (causal && kpos > qpos)) x = kNegInf;
        }
        sc[nt][e] = x;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - mn0);
      sc[nt][1] = exp2f(sc[nt][1] - mn0);
      sc[nt][2] = exp2f(sc[nt][2] - mn1);
      sc[nt][3] = exp2f(sc[nt][3] - mn1);
      sum0 += sc[nt][0] + sc[nt][1];
      sum1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= corr0;
      o[i][1] *= corr0;
      o[i][2] *= corr1;
      o[i][3] *= corr1;
    }

    // O += P V: P (bf16) from the score accumulators, V by ldmatrix.trans
#pragma unroll
    for (int kv = 0; kv < NK / 2; ++kv) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kv][0], sc[2 * kv][1]),
                              pack_bf16(sc[2 * kv][2], sc[2 * kv][3]),
                              pack_bf16(sc[2 * kv + 1][0], sc[2 * kv + 1][1]),
                              pack_bf16(sc[2 * kv + 1][2], sc[2 * kv + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(vt + swz<CPR>(r_kv + kv * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8,
                                             dp * 2 + (lane >> 4))),
                      b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pa, b0, b1);
        mma_bf16(o[2 * dp + 1], pa, b2, b3);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // merge group 1's state into group 0's through the (now idle) ring: the
  // partner of a thread is the one with the same row slab and lane, so it
  // holds the same rows and columns. A group that saw no live key of a row
  // has max -1e30 there and weight exp2(-1e30 - m) = 0.
  constexpr int kState = 4 + 4 * ND;    // floats a thread hands over
  float* xfer = reinterpret_cast<float*>(ks) + (rw * 32 + lane) * kState;
  cp_async_wait<0>();
  __syncthreads();                      // every group is done with the ring
  if (grp == 1) {
    xfer[0] = m0; xfer[1] = m1; xfer[2] = l0; xfer[3] = l1;
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) xfer[4 + 4 * i + e] = o[i][e];
  }
  __syncthreads();
  if (grp == 1) return;
  {
    const float pm0 = xfer[0], pm1 = xfer[1];
    const float mn0 = fmaxf(m0, pm0), mn1 = fmaxf(m1, pm1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    const float b0 = exp2f(pm0 - mn0), b1 = exp2f(pm1 - mn1);
    l0 = l0 * a0 + xfer[2] * b0;
    l1 = l1 * a1 + xfer[3] * b1;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] = o[i][0] * a0 + xfer[4 + 4 * i + 0] * b0;
      o[i][1] = o[i][1] * a0 + xfer[4 + 4 * i + 1] * b0;
      o[i][2] = o[i][2] * a1 + xfer[4 + 4 * i + 2] * b1;
      o[i][3] = o[i][3] * a1 + xfer[4 + 4 * i + 3] * b1;
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + ((long long)b * h + head) * s * D;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int col = i * 8 + 2 * t;
    if (row0 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * D + col) =
          pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    if (row0 + 8 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * D + col) =
          pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename T, int D>
int launch_cuda_core(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int hkv, int s, int causal,
                     cudaStream_t stream) {
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int h, int hkv, int s, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(uint4) * (kBlock + 2 * kStages * kv_step<D>()) * (D / 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e)/sqrt(D)
  const int nqb = (s + kBlock - 1) / kBlock;
  if (nqb > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(h, nqb, b);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      h, hkv, s, causal, scale_log2);
  return (int)cudaGetLastError();
}

// path: 1 = the bf16 tensor-core body, else the CUDA-core body in T
template <typename T, int D>
int launch_path(int path, const void* q, const void* k, const void* v,
                void* out, int b, int h, int hkv, int s, int causal,
                cudaStream_t st) {
  if constexpr (mma_dim(D)) {
    if (path == 1) return launch_mma<D>(q, k, v, out, b, h, hkv, s, causal, st);
  }
  return launch_cuda_core<T, D>(q, k, v, out, b, h, hkv, s, causal, st);
}

template <typename T>
int launch_d(int path, const void* q, const void* k, const void* v,
             void* out, int b, int h, int hkv, int s, int d, int causal,
             cudaStream_t st) {
  if (d == 16) return launch_path<T, 16>(path, q, k, v, out, b, h, hkv, s, causal, st);
  if (d == 32) return launch_path<T, 32>(path, q, k, v, out, b, h, hkv, s, causal, st);
  if (d == 64) return launch_path<T, 64>(path, q, k, v, out, b, h, hkv, s, causal, st);
  if (d == 112) return launch_path<T, 112>(path, q, k, v, out, b, h, hkv, s, causal, st);
  if (d == 128) return launch_path<T, 128>(path, q, k, v, out, b, h, hkv, s, causal, st);
  if (d == 256) return launch_path<T, 256>(path, q, k, v, out, b, h, hkv, s, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, 64, 112, 128, 256}. Writes
// the body it takes to *path: 1 ("mma") for bf16 with 16-byte-aligned
// pointers (what cp.async needs) at d in {16, 32, 64, 128, 256}, else 0
// ("cuda_core"). Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int h,
                                     int hkv, int s, int d, int causal,
                                     int dtype, void* stream, int* path) {
  using repro_tc::aligned16;
  using repro_tc::mma_dim;
  *path = dtype == 1 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(out) && mma_dim(d);
  if (b == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(*path, q, k, v, out, b, h, hkv, s, d, causal, st);
  return launch_d<__nv_bfloat16>(*path, q, k, v, out, b, h, hkv, s, d, causal, st);
}
