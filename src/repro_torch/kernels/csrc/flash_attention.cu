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
//   128 a tile is 64 rows and the Q fragments stay in registers; at D = 112
//   (kimi-k2) each row lies in a 16-chunk slot of which cp.async fills the
//   14 live chunks (tensor_core.cuh:slot_chunks), so the shared memory and
//   tiles are D = 128's and the loops run 7 k steps and 14 n8 tiles; at D = 256
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
//   copied into every q block's CTA bound the body, one CTA an SM. Under
//   GQA each q head's CTA copies its kv head's K / V again (kimi-k2's 64 /
//   8 heads at D = 112: eight copies of each tile, where one CTA over the
//   group's eight q heads would need one).
// * fp32 ("cuda_core"): the first version on CUDA cores in fp32, exact to
//   summation order against the plain version (tensor cores would need
//   TF32, three decimal digits). bf16 whose pointers are not 16-byte
//   aligned (cp.async's unit) takes it too. Two threads per q row.
//
// With a non-null lse (training) the mma body also stores each row's
// log-sum-exp of the scaled scores, (B, H, S) fp32, for the backward; the
// serving prefill passes null and stores none. One instance serves both.
// Against a template with an instance each way, the one instance with this
// runtime branch after the merge took 128 registers at D = 64 (32 bytes
// spilled, as the storing instance did) where the serving instance took 135
// (no spill), 207 where it took 210 at D = 128; it served 20% faster at
// minicpm-2b's and qwen3-4b's prefill shapes (D = 64 and 128, 1,000-3,584
// rows), within 2% at D = 112 and 256, trained as fast, and wrote the same
// bits (H100 80GB HBM3, 700 W). At D = 64, 128 registers let two CTAs share
// an SM, where 135 left one; at smollm-360m's 15 / 5 heads (B = 1, S =
// 1,000: 240 CTAs, one wave either way) it reads ~7% slower, 0.0222
// against 0.0208 ms, across two runs.
//
// Backward (flash_bwd_*): replaces none: the TPU kernel has no backward;
// added because training's attention was the largest share of a training
// step's device time (its torch route writes the (S, S) fp32 scores to HBM
// through six elementwise passes, each way). bf16 on the tensor cores at D =
// 64 and 128, causal alone (training's one mask), the forward's building
// blocks (mma.sync m16n8k16, ldmatrix from XOR-swizzled tiles, a cp.async
// ring). What bounds it: operations, as
// the forward, and more of them: P and dP are recomputed in two kernels
// (7 products of 2 D flops a kept (q, k) pair where one pass with atomics
// would take 5). That is the price of a bitwise-repeatable result: no
// atomics anywhere, every sum in a fixed order, so a resumed run trains as
// the uninterrupted one. Three launches:
//   1. flash_bwd_delta_kernel: Delta = rowsum(dO o O), fp32;
//   2. flash_bwd_dkdv_kernel: one CTA per (64-row KV block, kv head,
//      batch) walks the group's q heads and the q blocks at or after it,
//      dK and dV held in registers for the whole walk;
//   3. flash_bwd_dq_kernel: one CTA per (64-row q block, q head, batch)
//      walks the KV blocks up to the diagonal, dQ in registers.
// S and dP accumulate in fp32; P and dS are rounded to bf16 only as the A
// operands of the next product (the torch route rounds S itself to bf16);
// scale 1/sqrt(D), the forward's causal mask and ragged-tail handling.
//
// Layouts: q (B, H, S, D); k, v (B, Hkv, S, D); out (B, H, S, D).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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

// Copy rows [r0, r0 + ROWS) of a (s, D) bf16 matrix into a swizzled tile of
// ROWS slots (slot_chunks(D / 8) chunks each, only the D / 8 live ones
// written) by 16-byte cp.async; rows at or past s are zero-filled (not read).
template <int D, int ROWS, int NT = kMmaThreads>
__device__ __forceinline__ void load_tile(uint4* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int s, int tid) {
  constexpr int CPR = D / 8;
  constexpr int SC = slot_chunks(CPR);
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int row = i / CPR, ch = i % CPR;
    const bool ok = r0 + row < s;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + row) * D + ch * 8 : src;
    cp_async16(smem_u32(dst + swz<SC>(row, ch)), g, ok ? 16 : 0);
  }
}

// Eight warps per (64-row q block, q head, batch): warp group g (warps
// 4g .. 4g+3, 16 q rows each) runs the online softmax over KV tiles g,
// g + 2, g + 4, ... (each ring slot holds two KVR-row tiles, one per group),
// which halves the serial KV chain of the heaviest causal blocks; the two
// partial (max, sum, output) states are merged at the end. A non-null lse
// also receives each row's log-sum-exp (training).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int h, int hkv, int s, int causal, float scale_log2) {
  constexpr int SC = slot_chunks(D / 8);  // 16-byte chunks per shared row
  constexpr int KVR = kv_rows<D>();     // KV rows of one group's tile
  constexpr int KS = kv_step<D>();      // KV rows of a ring slot
  constexpr int QT = kBlock * SC;       // 16-byte units of the Q tile
  constexpr int KVT = KS * SC;          // 16-byte units of a K or V ring slot
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
        for (int kk = 0; kk < KD; ++kk) ldsm_a<SC>(qs, rw * 16, kk, lane, qf[kk]);
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
        ldsm_a<SC>(qs, rw * 16, kk, lane, qa);
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt + swz<SC>(r_kv + np * 16 + (lane & 7) + (lane >> 4) * 8,
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
        ldsm_x4_trans(smem_u32(vt + swz<SC>(r_kv + kv * 16 + (lane & 7) +
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
    m0 = mn0;
    m1 = mn1;
  }

  if (lse != nullptr) {                 // the backward's, in natural log
    if (t == 0) {
      float* lr = lse + ((long long)b * h + head) * s;
      if (row0 < s) lr[row0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
      if (row0 + 8 < s) lr[row0 + 8] = (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
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
// backward: bf16 on the tensor cores, D = 64 and 128, no atomics
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 128;   // four warps of 16 rows
constexpr int kDeltaThreads = 256;

// q columns of one S^T chunk in the dK / dV kernel: the whole 64-row q tile
// at D = 64, half of it at D = 128, where the dK and dV accumulators take
// 2 x 64 registers a thread
template <int D>
__host__ __device__ constexpr int bwd_chunk() { return D > 64 ? 32 : 64; }

// Delta = rowsum(dO o O) in fp32, one row per D / 8 threads (a 16-byte load
// of each), summed by a fixed shuffle tree.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  constexpr int TPR = D / 8;
  const long long idx = (long long)blockIdx.x * kDeltaThreads + threadIdx.x;
  const long long row = idx / TPR;
  const int part = (int)(idx % TPR);
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(c2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[row] = acc;
}

// dK and dV of one 64-row KV block: one CTA of four warps (16 kv rows
// each) per (KV block, kv head, batch) walks the (q head of the group, q
// block at or after it) tiles, Q / dO tiles by cp.async in a two-slot
// ring. Per tile and warp, on mma.sync:
//   S^T = K Q^T, dP^T = V dO^T        (16 kv rows x chunk q columns, fp32)
//   P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T o (dP^T - Delta)
//   dV += P^T dO, dK += dS^T Q        (P^T, dS^T rounded to bf16 as the
//                                      A operands, from the accumulators)
// dK, dV stay in registers for the whole walk; dK is scaled at the store.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int h, int hkv, int s,
                      float scale, float scale_log2) {
  constexpr int SC = D / 8;             // 16-byte chunks of a shared row
  constexpr int T = kBlock * SC;        // 16-byte units of a 64-row tile
  constexpr int KD = D / 16;            // k steps over D
  constexpr int ND = D / 8;             // 8-wide output column tiles
  constexpr int QC = bwd_chunk<D>();    // q columns of a chunk
  constexpr int NQ = QC / 8;            // 8-wide score column tiles
  const int kvh = blockIdx.x, kb = blockIdx.y, b = blockIdx.z;
  const int grp = h / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kb * kBlock;
  const int krow = k0 + warp * 16 + g;  // this thread's kv rows: krow, krow + 8

  extern __shared__ uint4 smem4[];
  uint4* ks = smem4;                    // T
  uint4* vs = ks + T;                   // T
  uint4* qs = vs + T;                   // kStages x T
  uint4* dos = qs + kStages * T;        // kStages x T
  float* ls = reinterpret_cast<float*>(dos + kStages * T);  // kStages x 64: lse log2e
  float* dls = ls + kStages * kBlock;                        // kStages x 64: Delta

  const long long kvoff = ((long long)b * hkv + kvh) * s * D;
  const int nqb = (s + kBlock - 1) / kBlock;
  const int per = nqb - kb;             // q blocks a q head: those at or after kb
  const int n = grp * per;              // tiles of the walk
  // tile it: q head kvh * grp + it / per, q block kb + it % per
  auto head_of = [&](int it) { return kvh * grp + it / per; };
  auto q0_of = [&](int it) { return (kb + it % per) * kBlock; };
  auto load_q = [&](int it, int slot) {
    const long long off = ((long long)b * h + head_of(it)) * s * D;
    load_tile<D, kBlock, kBwdThreads>(qs + slot * T, q + off, q0_of(it), s, tid);
    load_tile<D, kBlock, kBwdThreads>(dos + slot * T, dout + off, q0_of(it), s, tid);
  };
  // row tid of tile it: its lse in the log2 domain and its Delta (0 past s)
  auto row_stats = [&](int it, float& l, float& dl) {
    const int row = q0_of(it) + tid;
    l = dl = 0.f;
    if (row < s) {
      const long long at = ((long long)b * h + head_of(it)) * s + row;
      l = lse[at] * kLog2e;
      dl = delta[at];
    }
  };

  load_tile<D, kBlock, kBwdThreads>(ks, k + kvoff, k0, s, tid);
  load_tile<D, kBlock, kBwdThreads>(vs, v + kvoff, k0, s, tid);
  load_q(0, 0);
  cp_async_commit();
  if (tid < kBlock) row_stats(0, ls[tid], dls[tid]);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int slot = it % kStages;
    cp_async_wait<0>();                 // tile it (and K, V) have landed
    __syncthreads();                    // ... for every thread; tile it-1 is consumed
    float nl = 0.f, ndl = 0.f;          // the next tile's row stats, stored after
    if (it + 1 < n) {
      load_q(it + 1, (it + 1) % kStages);
      if (tid < kBlock) row_stats(it + 1, nl, ndl);
    }
    cp_async_commit();
    const int q0 = q0_of(it);
    const uint4* qt = qs + slot * T;
    const uint4* dot = dos + slot * T;
    const float* lt = ls + slot * kBlock;
    const float* dlt = dls + slot * kBlock;
    // the diagonal tile, and ragged tails of q or kv
    const bool masked = q0 == k0 || q0 + kBlock > s || k0 + kBlock > s;

#pragma unroll
    for (int c = 0; c < kBlock / QC; ++c) {
      float st[NQ][4], dp[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_a<SC>(ks, warp * 16, kk, lane, ka);
        ldsm_a<SC>(vs, warp * 16, kk, lane, va);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int r = c * QC + np * 16 + (lane & 7) + (lane >> 4) * 8;
          const int ch = kk * 2 + ((lane >> 3) & 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(qt + swz<SC>(r, ch)), b0, b1, b2, b3);
          mma_bf16(st[2 * np], ka, b0, b1);
          mma_bf16(st[2 * np + 1], ka, b2, b3);
          ldsm_x4(smem_u32(dot + swz<SC>(r, ch)), b0, b1, b2, b3);
          mma_bf16(dp[2 * np], va, b0, b1);
          mma_bf16(dp[2 * np + 1], va, b2, b3);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c * QC + nt * 8 + 2 * t + (e & 1);   // row of the q tile
          float p = exp2f(fmaf(st[nt][e], scale_log2, -lt[qc]));
          if (masked) {
            const int kpos = krow + (e >> 1) * 8, qpos = q0 + qc;
            if (qpos >= s || kpos >= s || kpos > qpos) p = 0.f;
          }
          st[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dlt[qc]);
        }
      }
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(st[2 * j][0], st[2 * j][1]),
                                pack_bf16(st[2 * j][2], st[2 * j][3]),
                                pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]),
                                pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3])};
        const uint32_t sa[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                                pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                                pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                                pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          const int r = c * QC + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int ch = dd * 2 + (lane >> 4);
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(smem_u32(dot + swz<SC>(r, ch)), b0, b1, b2, b3);
          mma_bf16(dva[2 * dd], pa, b0, b1);
          mma_bf16(dva[2 * dd + 1], pa, b2, b3);
          ldsm_x4_trans(smem_u32(qt + swz<SC>(r, ch)), b0, b1, b2, b3);
          mma_bf16(dka[2 * dd], sa, b0, b1);
          mma_bf16(dka[2 * dd + 1], sa, b2, b3);
        }
      }
    }
    if (it + 1 < n && tid < kBlock) {
      ls[((it + 1) % kStages) * kBlock + tid] = nl;
      dls[((it + 1) % kStages) * kBlock + tid] = ndl;
    }
  }

  __nv_bfloat16* dkb = dk + kvoff;
  __nv_bfloat16* dvb = dv + kvoff;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int col = i * 8 + 2 * t;
    if (krow < s) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)krow * D + col) =
          pack_bf16(dka[i][0] * scale, dka[i][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)krow * D + col) =
          pack_bf16(dva[i][0], dva[i][1]);
    }
    if (krow + 8 < s) {
      *reinterpret_cast<uint32_t*>(dkb + (long long)(krow + 8) * D + col) =
          pack_bf16(dka[i][2] * scale, dka[i][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (long long)(krow + 8) * D + col) =
          pack_bf16(dva[i][2], dva[i][3]);
    }
  }
}

// dQ of one 64-row q block: one CTA of four warps (16 q rows each) per (q
// block, q head, batch) walks the KV blocks up to the diagonal, K /
// V tiles by cp.async in a two-slot ring, and recomputes P as the dK / dV
// kernel does:
//   S = Q K^T, dP = dO V^T, P = exp2(S scale log2e - lse log2e),
//   dS = P o (dP - Delta), dQ += dS K   (dS rounded to bf16, from the
//                                        accumulators)
// The Q and dO fragments stay in registers at D = 64 and are re-read by
// ldmatrix at each k step at D = 128 (beside its 64 accumulator registers).
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int h, int hkv, int s,
                    float scale, float scale_log2) {
  constexpr int SC = D / 8;
  constexpr int T = kBlock * SC;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NK = kBlock / 8;        // 8-wide score column tiles
  constexpr bool HQ = D <= 64;          // Q, dO fragments held in registers
  const int head = blockIdx.x, b = blockIdx.z;
  const int qb = gridDim.y - 1 - blockIdx.y;   // heaviest q block first
  const int kvh = head / (h / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBlock;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  extern __shared__ uint4 smem4[];
  uint4* qs = smem4;                    // T
  uint4* dos = qs + T;                  // T
  uint4* ks = dos + T;                  // kStages x T
  uint4* vs = ks + kStages * T;         // kStages x T

  const long long qrow = ((long long)b * h + head) * s;
  const long long kvoff = ((long long)b * hkv + kvh) * s * D;
  const int nkv = qb + 1;               // the KV blocks up to the diagonal

  load_tile<D, kBlock, kBwdThreads>(qs, q + qrow * D, q0, s, tid);
  load_tile<D, kBlock, kBwdThreads>(dos, dout + qrow * D, q0, s, tid);
  load_tile<D, kBlock, kBwdThreads>(ks, k + kvoff, 0, s, tid);
  load_tile<D, kBlock, kBwdThreads>(vs, v + kvoff, 0, s, tid);
  cp_async_commit();
  const float l0 = row0 < s ? lse[qrow + row0] * kLog2e : 0.f;
  const float l1 = row0 + 8 < s ? lse[qrow + row0 + 8] * kLog2e : 0.f;
  const float d0 = row0 < s ? delta[qrow + row0] : 0.f;
  const float d1 = row0 + 8 < s ? delta[qrow + row0 + 8] : 0.f;

  uint32_t qf[HQ ? KD : 1][4], df[HQ ? KD : 1][4];
  float dqa[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int j = 0; j < nkv; ++j) {
    cp_async_wait<0>();                 // KV tile j (and Q, dO) have landed
    __syncthreads();                    // ... for every thread; tile j-1 is consumed
    if (j + 1 < nkv) {
      const int slot = (j + 1) % kStages;
      load_tile<D, kBlock, kBwdThreads>(ks + slot * T, k + kvoff, (j + 1) * kBlock, s, tid);
      load_tile<D, kBlock, kBwdThreads>(vs + slot * T, v + kvoff, (j + 1) * kBlock, s, tid);
    }
    cp_async_commit();
    if constexpr (HQ) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_a<SC>(qs, warp * 16, kk, lane, qf[kk]);
          ldsm_a<SC>(dos, warp * 16, kk, lane, df[kk]);
        }
      }
    }
    const uint4* kt = ks + (j % kStages) * T;
    const uint4* vt = vs + (j % kStages) * T;

    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (HQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { qa[e] = qf[kk][e]; da[e] = df[kk][e]; }
      } else {
        ldsm_a<SC>(qs, warp * 16, kk, lane, qa);
        ldsm_a<SC>(dos, warp * 16, kk, lane, da);
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int ch = kk * 2 + ((lane >> 3) & 1);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt + swz<SC>(r, ch)), b0, b1, b2, b3);
        mma_bf16(sc[2 * np], qa, b0, b1);
        mma_bf16(sc[2 * np + 1], qa, b2, b3);
        ldsm_x4(smem_u32(vt + swz<SC>(r, ch)), b0, b1, b2, b3);
        mma_bf16(dp[2 * np], da, b0, b1);
        mma_bf16(dp[2 * np + 1], da, b2, b3);
      }
    }

    const int k0 = j * kBlock;
    const bool masked = k0 == q0 || k0 + kBlock > s || q0 + kBlock > s;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float p = exp2f(fmaf(sc[nt][e], scale_log2, hi ? -l1 : -l0));
        if (masked) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = row0 + (hi ? 8 : 0);
          if (kpos >= s || qpos >= s || kpos > qpos) p = 0.f;
        }
        dp[nt][e] = p * (dp[nt][e] - (hi ? d1 : d0));
      }
    }

    // dQ += dS K: dS (bf16) from the accumulators, K by ldmatrix.trans
#pragma unroll
    for (int kv = 0; kv < NK / 2; ++kv) {
      const uint32_t sa[4] = {pack_bf16(dp[2 * kv][0], dp[2 * kv][1]),
                              pack_bf16(dp[2 * kv][2], dp[2 * kv][3]),
                              pack_bf16(dp[2 * kv + 1][0], dp[2 * kv + 1][1]),
                              pack_bf16(dp[2 * kv + 1][2], dp[2 * kv + 1][3])};
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(kt + swz<SC>(kv * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8,
                                             dd * 2 + (lane >> 4))),
                      b0, b1, b2, b3);
        mma_bf16(dqa[2 * dd], sa, b0, b1);
        mma_bf16(dqa[2 * dd + 1], sa, b2, b3);
      }
    }
  }

  __nv_bfloat16* dqb = dq + qrow * D;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int col = i * 8 + 2 * t;
    if (row0 < s)
      *reinterpret_cast<uint32_t*>(dqb + (long long)row0 * D + col) =
          pack_bf16(dqa[i][0] * scale, dqa[i][1] * scale);
    if (row0 + 8 < s)
      *reinterpret_cast<uint32_t*>(dqb + (long long)(row0 + 8) * D + col) =
          pack_bf16(dqa[i][2] * scale, dqa[i][3] * scale);
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
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int h, int hkv, int s, int causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(uint4) * (kBlock + 2 * kStages * kv_step<D>()) *
                      slot_chunks(D / 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const int nqb = (s + kBlock - 1) / kBlock;
  if (nqb > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(h, nqb, b);
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, h, hkv, s, causal, scale_log2);
  return (int)cudaGetLastError();
}

// path: 1 = the bf16 tensor-core body, else the CUDA-core body in T. An
// lse is stored by the tensor-core body alone.
template <typename T, int D>
int launch_path(int path, const void* q, const void* k, const void* v,
                void* out, float* lse, int b, int h, int hkv, int s,
                int causal, cudaStream_t st) {
  if constexpr (mma_dim(D)) {
    if (path == 1)
      return launch_mma<D>(q, k, v, out, lse, b, h, hkv, s, causal, st);
  }
  if (lse != nullptr) return (int)cudaErrorInvalidValue;
  return launch_cuda_core<T, D>(q, k, v, out, b, h, hkv, s, causal, st);
}

template <typename T>
int launch_d(int path, const void* q, const void* k, const void* v,
             void* out, float* lse, int b, int h, int hkv, int s, int d,
             int causal, cudaStream_t st) {
  if (d == 16) return launch_path<T, 16>(path, q, k, v, out, lse, b, h, hkv, s, causal, st);
  if (d == 32) return launch_path<T, 32>(path, q, k, v, out, lse, b, h, hkv, s, causal, st);
  if (d == 64) return launch_path<T, 64>(path, q, k, v, out, lse, b, h, hkv, s, causal, st);
  if (d == 112) return launch_path<T, 112>(path, q, k, v, out, lse, b, h, hkv, s, causal, st);
  if (d == 128) return launch_path<T, 128>(path, q, k, v, out, lse, b, h, hkv, s, causal, st);
  if (d == 256) return launch_path<T, 256>(path, q, k, v, out, lse, b, h, hkv, s, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The three backward launches on one stream: Delta, then dK / dV and dQ.
template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int hkv, int s,
               cudaStream_t st) {
  using bf = __nv_bfloat16;
  const int nb = (s + kBlock - 1) / kBlock;
  if (nb > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * h * s;
  const long long threads = rows * (D / 8);
  flash_bwd_delta_kernel<D><<<(unsigned)((threads + kDeltaThreads - 1) / kDeltaThreads),
                              kDeltaThreads, 0, st>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const size_t tile = sizeof(uint4) * kBlock * (D / 8);
  const size_t smem_kv = tile * (2 + 2 * kStages) + sizeof(float) * 2 * kStages * kBlock;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<dim3(hkv, nb, b), kBwdThreads, smem_kv, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv), h, hkv, s, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_q = tile * (2 + 2 * kStages);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3(h, nb, b), kBwdThreads, smem_q, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), h, hkv, s, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, 64, 112, 128, 256}. Writes
// the body it takes to *path: 1 ("mma") for bf16 with 16-byte-aligned
// pointers (what cp.async needs), else 0 ("cuda_core"). lse, when not null,
// receives each row's log-sum-exp of the scaled scores, (b, h, s) fp32 (the
// backward's input; the mma body alone writes it). Returns
// cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int b, int h, int hkv, int s, int d,
                                     int causal, int dtype, void* stream,
                                     int* path) {
  using repro_tc::aligned16;
  using repro_tc::mma_dim;
  *path = dtype == 1 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(out) && mma_dim(d);
  if (b == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return launch_d<float>(*path, q, k, v, out, l, b, h, hkv, s, d, causal, st);
  return launch_d<__nv_bfloat16>(*path, q, k, v, out, l, b, h, hkv, s, d, causal, st);
}

// The backward of repro_flash_attention's bf16 causal body: q, o, dout (b, h, s,
// d), k, v (b, hkv, s, d) bf16, lse (b, h, s) fp32 as the forward wrote
// it; writes dq, dk, dv (the inputs' shapes, bf16) and uses delta (b, h, s)
// fp32 as scratch. d in {64, 128}, every pointer 16-byte aligned: *path = 1
// ("mma", the one body), else 0 and nothing runs. Returns
// cudaGetLastError().
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk,
                                         void* dv, int b, int h, int hkv,
                                         int s, int d, void* stream,
                                         int* path) {
  using repro_tc::aligned16;
  *path = (d == 64 || d == 128) && aligned16(q) && aligned16(k) &&
          aligned16(v) && aligned16(o) && aligned16(dout) && aligned16(dq) &&
          aligned16(dk) && aligned16(dv);
  if (!*path) return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (d == 64)
    return launch_bwd<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, h, hkv, s, st);
  return launch_bwd<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, h, hkv, s, st);
}
