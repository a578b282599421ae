// Paged attention for Hopper (sm_90a) over a KV cache scattered across
// fixed-size physical pages: the decode step (one query token per sequence)
// and the verify step of self-speculative decoding (Sq query tokens per
// sequence at consecutive positions).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:paged_attention
// (Pallas body _kernel) and :paged_attention_verify (body _verify_kernel).
// Same contract: scale 1/sqrt(D), masking with -1e30, fp32 running max /
// sum / accumulator, l clamped at 1e-30, output in the input type, the loop
// capped at the table's maxp columns, and no read of a table entry past the
// sequence's causal bound (a spec tick near max_cache reads no other row's
// entries).
//
// What bounds it on this card: bytes. A step reads every live K/V position
// of its sequence once and does 4*R*D flops per position for the R query
// rows of a kv head (G = 3 at smollm-360m: 3 rows for decode, 15 for a
// 5-row verify), far below the ~295 flop/byte where compute matters. At the
// main decode shape (8 slots, Hkv 5, D 64, lengths 102-1100) that is 4.7 MB,
// 1.4 us at 3.35 TB/s. One CTA per (sequence, kv head) walking its pages in
// order left 92 of 132 SMs idle, and the longest lane's serial chain set
// the time; so the design is about latency and parallelism:
//
// * Split-K over pages (flash-decoding). The grid is (row block, kv head,
//   sequence, split), flattened with the split outermost, so every
//   sequence's first (live) splits are dispatched before the later ones
//   that only long lanes need. A split is a fixed run of pages_per_split
//   pages; nsplit and pages_per_split are a function of (B, Hkv, maxp,
//   page) alone, chosen on the host (ops.py:split_rule): about four CTAs an
//   SM over B*Hkv*nsplit, each split a whole number of 64-token tiles. At
//   the main decode shape that is 12 splits of 8 pages (480 CTAs, ~170 of
//   them live for the trace's lengths), at the verify shape (maxp 32) 8
//   splits of 4 pages. The host never reads the lengths: a CTA whose split
//   starts past its rows' causal bound reads no page and only writes the
//   empty state m = -1e30, l = 0. Every other CTA writes, per query row, its
//   running max m (log2 domain), sum l and unnormalised fp32 accumulator to
//   scratch that the wrapper allocates. A second launch, one thread per
//   output element, merges them in split order, 8 (or 16) splits' states
//   loaded at once and folded into a running state, skipping empty ones:
//   the same bits on every run, no atomics. With one split the CTA writes
//   the output itself and there is no merge.
// * Loads. The CTA copies its split's table entries (only those below the
//   bound) into shared memory once; K/V rows then arrive as 16-byte cp.async
//   copies, neighbouring threads on neighbouring addresses, into a
//   three-stage ring of 64-token tiles in XOR-swizzled rows, two tiles in
//   flight before the first is computed (a decode split is exactly two).
//   Positions past the bound are zero-filled, not read. K/V stay in the
//   input type in shared memory and are converted in registers. Pointers
//   that are not 16-byte aligned (a view) take element copies into the same
//   ring.
// * Bodies, by kernel_path (ops.py), the same rule for both entries and any
//   number of rows, so that each verify row computes bitwise what the
//   decode step computes at its position (the speculative streams of the
//   MoE run in chip_smoke.py phase 6 part at near-tied experts otherwise).
//   Each warp keeps its own online-softmax state over its tokens of every
//   tile; the warps' states are merged in warp order at the end of the CTA.
//   - "mma" (bf16, 16-byte-aligned pointers): four warps of 16 tokens; 16
//     rows a CTA (G = 3 decode rows padded, the verify's 15 rows at smollm)
//     as one m16 tile of A fragments in registers; S = Q K^T on mma.sync
//     m16n8k16 (two n8 tiles, D/16 k steps, K by ldmatrix), the causal mask
//     kpos <= first + r / G on the accumulators, P re-packed as A fragments
//     and PV on mma.sync with V by ldmatrix.trans. P goes in as two bf16
//     parts, hi + lo, so it keeps ~16 bits, close to the fp32 P of the TPU
//     kernels (rounding P to bf16 once, as flash does, moved the MoE spec
//     run's verify rows off its decode rows). Up to D = 128 the Q fragments
//     stay in registers; at D = 112 (kimi-k2) each K / V / Q row lies in a
//     16-chunk slot of which cp.async fills the 14 live chunks
//     (tensor_core.cuh:slot_chunks: the D = 128 ring, 14% of it padding),
//     and the loops run 7 k steps and 14 n8 tiles; at D = 256 (gemma-7b,
//     paligemma-3b) they are
//     re-read by ldmatrix at each k step (held, they would take 64
//     registers beside the output accumulator's 128), and the three-stage
//     ring of 64-token tiles takes 192 KB, the Q tile 8 KB and the table at
//     most 2 KB: one CTA an SM, which a kernel bound by bytes can afford
//     (each CTA keeps two 64 KB tiles in flight).
//   - "cuda_core" (fp32, and bf16 that is not 16-byte aligned): eight
//     warps, 8 tokens of a tile each (four warps of 16 spent ~2.4 us a tile
//     on their serial instruction chains); the 8 rows of a row block in
//     registers (rows past the kv head's skipped); a K row of CPR 16-byte
//     chunks lies over the next power of two of CPR lanes (past 32 chunks,
//     fp32 at D = 256, each lane takes CPR / 32), so a warp pass covers
//     32 / lanes tokens; dot products reduced by shuffles, one softmax
//     update per tile (or four passes); P stays fp32. fp32 at D = 256 takes
//     32-token tiles so that three ring stages fit in shared memory.
// What is left: a CTA's time is a chain of global latencies (lengths, then
// table entries, then K/V, then the partial state) plus the merge launch;
// wgmma / TMA would take the per-warp ldmatrix traffic off the mma body,
// and a persistent grid would drop the empty CTAs.
//
// Rows of a kv head are (query, group) row-major: row r is query r / G and
// q head h*G + r % G, and attends kpos <= first + r / G, where first is the
// sequence's first query position (decode: lengths[b] - 1; verify: pos[b]).
//
// Layouts: q, out (B, Sq, H, D) with H = Hkv*G (decode: Sq = 1, (B, H, D));
// lengths / pos (B,) int32; k_pages, v_pages (P, page, Hkv, D); table
// (B, maxp) int32; partials fp32, (B, Hkv, nsplit, R, D) accumulators then
// (B, Hkv, nsplit, R, 2) (m, l).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace repro_tc;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;                    // the mma body and the merge
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                    // tokens per ring stage
constexpr int kWarpTokens = kTile / kWarps;  // tokens of a stage per mma warp
constexpr int kStages = 3;
constexpr int kMmaRows = 16;                 // rows of one m16 tile
constexpr int kCcRows = 8;                   // rows of a CUDA-core row block

// How the CUDA-core body lays a token's row of CPR 16-byte chunks over a
// warp: the next power of two of CPR lanes take one chunk each (lanes past
// CPR idle, as for D = 112), or, past 32 chunks (fp32 at D = 256), all 32
// lanes take CPR / 32 chunks each; 32 / lanes tokens go through a warp pass.
template <int CPR>
__host__ __device__ constexpr int cc_lanes() {
  return CPR > 16 ? 32 : CPR > 8 ? 16 : CPR > 4 ? 8 : CPR > 2 ? 4 : CPR > 1 ? 2 : 1;
}
template <int CPR>
__host__ __device__ constexpr int cc_chunks() {
  return CPR > 32 ? CPR / 32 : 1;
}
template <typename T, int D>
__host__ __device__ constexpr int cc_cpr() {
  return D * (int)sizeof(T) / 16;
}
template <typename T, int D>
__host__ __device__ constexpr int cc_tpp() {
  return 32 / cc_lanes<cc_cpr<T, D>()>();
}
// Tokens of a CUDA-core ring stage: 64, or 32 where a row is over 512 bytes
// (fp32 at D = 256), so that three stages of K and V fit in shared memory.
template <typename T, int D>
__host__ __device__ constexpr int cc_tile() {
  return D * (int)sizeof(T) > 512 ? kTile / 2 : kTile;
}

// Warps of the CUDA-core body: 8, each taking tile / 8 tokens of a tile (so
// each warp's serial chain of instructions is short), or fewer where one
// warp pass already covers more tokens (bf16 at D = 16: 16 tokens a pass).
template <typename T, int D>
__host__ __device__ constexpr int cc_warps() {
  return cc_tile<T, D>() / cc_tpp<T, D>() < 8
             ? cc_tile<T, D>() / cc_tpp<T, D>()
             : 8;
}

// Index, in 16-byte units, of chunk `ch` of ring row `row` of CPR live
// chunks: the XOR swizzle of tensor_core.cuh over rows of slot_chunks(CPR)
// chunks (CPR = 14 and 28 at D = 112 lie in 16- and 32-chunk slots).
template <int CPR>
__device__ __forceinline__ int ring_at(int row, int ch) {
  return swz<slot_chunks(CPR)>(row, ch);
}

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* table;
  const int* idx;      // lengths (decode) or first positions (verify)
  void* out;
  float* part;         // partial states when nsplit > 1
  int off;             // first = idx[b] + off
  int batch, hkv, g, sq, rows, page, maxp, pps, nsplit, nrb;
  int vec;             // K/V 16-byte aligned: cp.async, else element copies
  float scale_log2;    // log2(e) / sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes of one chunk as fp32
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[4]) {
  f[0] = __uint_as_float(c.x);
  f[1] = __uint_as_float(c.y);
  f[2] = __uint_as_float(c.z);
  f[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16 of the rest: hi +
// lo carries ~16 bits of each, so P (hi + lo) V on the tensor cores keeps P
// to about fp32's accuracy.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Element offset of query / output row r of kv head h of sequence b.
__device__ __forceinline__ long long row_off(const Params& p, int b, int h,
                                             int r, int d) {
  return (((long long)b * p.sq + r / p.g) * p.hkv * p.g + h * p.g + r % p.g) *
         (long long)d;
}

// The last position row r attends (inclusive): its causal bound, capped at
// the table's capacity; -1 for a row past the kv head's rows.
__device__ __forceinline__ int row_limit(const Params& p, int first, int r) {
  if (r >= p.rows) return -1;
  return min(first + r / p.g, p.maxp * p.page - 1);
}

// What one CTA covers: tokens [s0, s0 + ntok) of its split (s0 a page
// boundary), every one at or before the last row's bound.
struct Work {
  int b, h, rb, s, first, s0, s_end, ntok;
};

__device__ __forceinline__ Work work_of(const Params& p, int rb_rows) {
  // split outermost: every sequence's first splits (the ones a short lane
  // still has live) are dispatched before any sequence's later splits
  int x = blockIdx.x;
  Work w;
  w.rb = x % p.nrb;
  x /= p.nrb;
  w.h = x % p.hkv;
  x /= p.hkv;
  w.b = x % p.batch;
  w.s = x / p.batch;
  w.first = p.idx[w.b] + p.off;
  const int split_tokens = p.pps * p.page;
  w.s0 = w.s * split_tokens;
  w.s_end = min(w.s0 + split_tokens, p.maxp * p.page);
  const int last = min(w.rb * rb_rows + rb_rows, p.rows) - 1;
  const int lim = min(row_limit(p, w.first, last), w.s_end - 1);
  w.ntok = max(0, lim + 1 - w.s0);
  return w;
}

// Copy the split's table entries (only those a live position needs) into
// shared memory.
template <int NT>
__device__ __forceinline__ void stage_table(const Params& p, const Work& w,
                                            int* pages_s) {
  const int npg = w.ntok ? (w.ntok - 1) / p.page + 1 : 0;
  const int* row = p.table + (long long)w.b * p.maxp + w.s * p.pps;
  for (int i = threadIdx.x; i < npg; i += NT) pages_s[i] = row[i];
}

// The partial (m, l) rows of a split with no live position: m = -1e30 and
// l = 0, which the merge skips.
template <int NT>
__device__ __forceinline__ void write_empty(const Params& p, const Work& w,
                                            int rb_rows, int d) {
  const int r0 = w.rb * rb_rows;
  const int nr = min(rb_rows, p.rows - r0);
  const long long at = ((long long)(w.b * p.hkv + w.h) * p.nsplit + w.s) *
                           p.rows + r0;
  float* pml = p.part + (long long)p.batch * p.hkv * p.nsplit * p.rows * d;
  for (int i = threadIdx.x; i < nr; i += NT) {
    pml[(at + i) * 2] = kNegInf;
    pml[(at + i) * 2 + 1] = 0.f;
  }
}

// K and V rows of tile j (tokens s0 + TILE j ..) into one ring stage: 16-byte
// cp.async copies (or element copies), zero-filled past the CTA's tokens.
template <typename T, int D, int NT, int TILE>
__device__ __forceinline__ void load_tile(const Params& p, const Work& w,
                                          const int* pages_s, int j,
                                          uint4* ks, uint4* vs) {
  constexpr int CPR = D * (int)sizeof(T) / 16;
  constexpr int EPC = 16 / (int)sizeof(T);
  const T* kp = static_cast<const T*>(p.kp);
  const T* vp = static_cast<const T*>(p.vp);
  for (int i = threadIdx.x; i < TILE * CPR; i += NT) {
    const int row = i / CPR, ch = i % CPR;
    const int rel = j * TILE + row;            // token - s0
    const bool ok = rel < w.ntok;
    long long src = 0;
    if (ok) {
      const long long pg = pages_s[rel / p.page];
      src = ((pg * p.page + rel % p.page) * p.hkv + w.h) * D + ch * EPC;
    }
    const int dst = ring_at<CPR>(row, ch);
    if (p.vec) {
      cp_async16(smem_u32(ks + dst), kp + src, ok ? 16 : 0);
      cp_async16(smem_u32(vs + dst), vp + src, ok ? 16 : 0);
    } else {
      T* kd = reinterpret_cast<T*>(ks + dst);
      T* vd = reinterpret_cast<T*>(vs + dst);
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        kd[e] = ok ? kp[src + e] : from_f<T>(0.f);
        vd[e] = ok ? vp[src + e] : from_f<T>(0.f);
      }
    }
  }
}

// Merge the NW warps' states (st_m, st_l: (NW, RBX); st_o: (NW, RBX, D))
// in warp order, then write the output (one split) or this split's
// partial state.
template <typename T, int D, int RBX, int NW>
__device__ __forceinline__ void combine_warps(const Params& p, const Work& w,
                                              const float* st_m,
                                              const float* st_l,
                                              const float* st_o) {
  const int r0 = w.rb * RBX;
  const int nr = min(RBX, p.rows - r0);
  const long long slot =
      ((long long)(w.b * p.hkv + w.h) * p.nsplit + w.s) * p.rows;
  float* pacc = p.part;
  float* pml = p.part + (long long)p.batch * p.hkv * p.nsplit * p.rows * D;
  for (int i = threadIdx.x; i < nr * D; i += 32 * NW) {
    const int r = i / D, c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int wp = 0; wp < NW; ++wp) mx = fmaxf(mx, st_m[wp * RBX + r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int wp = 0; wp < NW; ++wp) {
      const float a = exp2f(st_m[wp * RBX + r] - mx);
      l = fmaf(a, st_l[wp * RBX + r], l);
      o = fmaf(a, st_o[(wp * RBX + r) * D + c], o);
    }
    if (p.nsplit == 1) {
      T* out = static_cast<T*>(p.out);
      out[row_off(p, w.b, w.h, r0 + r, D) + c] =
          from_f<T>(o / fmaxf(l, 1e-30f));
    } else {
      pacc[(slot + r0 + r) * D + c] = o;
      if (c == 0) {
        pml[(slot + r0 + r) * 2] = mx;
        pml[(slot + r0 + r) * 2 + 1] = l;
      }
    }
  }
}

// Shared memory of one CTA: the ring (TILE rows of K and of V a stage, each
// row in a slot of slot_chunks 16-byte chunks), then (mma) the Q tile, then
// the split's table entries. The warps' states reuse the ring at the end.
template <typename T, int D, int TILE>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)kStages * 2 * TILE * slot_chunks(D * (int)sizeof(T) / 16) *
         16;
}

// ---------------------------------------------------------------------------
// CUDA-core body: the rows of a row block in registers
// ---------------------------------------------------------------------------
template <typename T, int D>
__device__ __forceinline__ void cuda_core_body(const Params& p) {
  constexpr int RB = kCcRows;
  constexpr int CPR = cc_cpr<T, D>();            // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a chunk
  constexpr int LPR = cc_lanes<CPR>();           // lanes of one token row
  constexpr int CPL = cc_chunks<CPR>();          // chunks a lane holds
  constexpr int EPL = CPL * EPC;                 // elements a lane holds
  constexpr int TPP = 32 / LPR;                  // tokens a warp pass
  constexpr int TILE = cc_tile<T, D>();
  constexpr int NW = cc_warps<T, D>();
  constexpr int NT = 32 * NW;
  constexpr int WT = TILE / NW;                  // tokens of a stage per warp
  constexpr int PASSES = WT / TPP;
  // passes one softmax update covers (PB x RB scores in registers)
  constexpr int PB = PASSES < 4 ? PASSES : 4;
  constexpr int KVT = TILE * slot_chunks(CPR);   // chunks of a K or V stage
  static_assert(CPR <= 32 || CPR % 32 == 0, "row of chunks over a warp");
  const Work w = work_of(p, RB);
  if (p.nsplit > 1 && w.ntok == 0) {             // no live position here
    write_empty<NT>(p, w, RB, D);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tsub = lane / LPR, ch0 = (lane % LPR) * CPL;
  const bool holds = ch0 < CPR;                  // lanes past the row idle
  const int nr = min(RB, p.rows - w.rb * RB);    // live rows of the block

  extern __shared__ uint4 smem4[];
  uint4* ring = smem4;
  int* pages_s = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                        ring_bytes<T, D, TILE>());
  stage_table<NT>(p, w, pages_s);

  // this lane's chunks of every row, pre-scaled into the log2 domain
  const T* q = static_cast<const T*>(p.q);
  float qr[RB][EPL], acc[RB][EPL], m[RB], l[RB];
  int lim[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int gr = w.rb * RB + r;
    lim[r] = min(row_limit(p, w.first, gr), w.s_end - 1);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[r][e] = gr < p.rows && holds
                     ? to_f(q[row_off(p, w.b, w.h, gr, D) + ch0 * EPC + e]) *
                           p.scale_log2
                     : 0.f;
      acc[r][e] = 0.f;
    }
  }
  __syncthreads();                               // table entries staged

  const int ntiles = (w.ntok + TILE - 1) / TILE;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_tile<T, D, NT, TILE>(p, w, pages_s, st,
                                               ring + st * 2 * KVT,
                                               ring + st * 2 * KVT + KVT);
    cp_async_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();                // tile j has landed
    __syncthreads();                             // ... for all; j-1 consumed
    {
      const int jn = j + kStages - 1;
      if (jn < ntiles) {
        uint4* st = ring + (jn % kStages) * 2 * KVT;
        load_tile<T, D, NT, TILE>(p, w, pages_s, jn, st, st + KVT);
      }
      cp_async_commit();
    }
    const int rel0 = j * TILE + warp * WT;     // this warp's tokens
    if (rel0 >= w.ntok) continue;              // warp-uniform
    const uint4* kt = ring + (j % kStages) * 2 * KVT;
    const uint4* vt = kt + KVT;
#pragma unroll
    for (int pb = 0; pb < PASSES; pb += PB) {
      // scores of this lane's token in PB passes, then one softmax update
      float sc[PB][RB];
#pragma unroll
      for (int ps = 0; ps < PB; ++ps) {
        const int trow = warp * WT + (pb + ps) * TPP + tsub;
        const bool any = rel0 + (pb + ps) * TPP < w.ntok;   // warp-uniform
        float kf[EPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float f[EPC];
#pragma unroll
          for (int e = 0; e < EPC; ++e) f[e] = 0.f;
          if (any && holds) unpack(kt[ring_at<CPR>(trow, ch0 + c)], f);
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[c * EPC + e] = f[e];
        }
        const int kpos = w.s0 + j * TILE + trow;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          sc[ps][r] = kNegInf;
          if (!any || r >= nr) continue;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qr[r][e], kf[e], s);
#pragma unroll
          for (int o = LPR / 2; o >= 1; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (kpos <= lim[r]) sc[ps][r] = s;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) continue;
        float mx = sc[0][r];
#pragma unroll
        for (int ps = 1; ps < PB; ++ps) mx = fmaxf(mx, sc[ps][r]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[r], mx);
        const float corr = exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int ps = 0; ps < PB; ++ps) {
        if (rel0 + (pb + ps) * TPP >= w.ntok) break;       // warp-uniform
        const int trow = warp * WT + (pb + ps) * TPP + tsub;
        float vf[EPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float f[EPC];
#pragma unroll
          for (int e = 0; e < EPC; ++e) f[e] = 0.f;
          if (holds) unpack(vt[ring_at<CPR>(trow, ch0 + c)], f);
#pragma unroll
          for (int e = 0; e < EPC; ++e) vf[c * EPC + e] = f[e];
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r >= nr) continue;
          const float pr = sc[ps][r] == kNegInf ? 0.f : exp2f(sc[ps][r] - m[r]);
          l[r] += pr;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
    }
  }

  // sum each row's sum and accumulator over the warp's token lanes
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free
  float* st_m = reinterpret_cast<float*>(ring);
  float* st_l = st_m + NW * RB;
  float* st_o = st_l + NW * RB;
  if (tsub == 0 && holds) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        st_o[(warp * RB + r) * D + ch0 * EPC + e] = acc[r][e];
      if (lane == 0) {
        st_m[warp * RB + r] = m[r];
        st_l[warp * RB + r] = l[r];
      }
    }
  }
  __syncthreads();
  combine_warps<T, D, RB, NW>(p, w, st_m, st_l, st_o);
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores: one m16 tile of rows a CTA
// ---------------------------------------------------------------------------
template <int D>
__device__ __forceinline__ void mma_body(const Params& p) {
  constexpr int CPR = D / 8;          // live 16-byte chunks a row
  constexpr int SC = slot_chunks(CPR);  // chunks of its shared slot
  constexpr int KVT = kTile * SC;
  constexpr int KD = D / 16;          // k steps of S = Q K^T
  constexpr int ND = D / 8;           // 8-wide output column tiles
  constexpr bool HQ = D <= 128;       // Q fragments held in registers
  using bf = __nv_bfloat16;
  const Work w = work_of(p, kMmaRows);
  if (p.nsplit > 1 && w.ntok == 0) {
    write_empty<kThreads>(p, w, kMmaRows, D);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ uint4 smem4[];
  uint4* ring = smem4;
  uint4* qs = smem4 + kStages * 2 * KVT;               // 16 slots
  int* pages_s = reinterpret_cast<int*>(qs + kMmaRows * SC);

  // the Q tile: rows of this block, zero past the kv head's rows
  const bf* q = static_cast<const bf*>(p.q);
  const int r0 = w.rb * kMmaRows;
  for (int i = tid; i < kMmaRows * CPR; i += kThreads) {
    const int row = i / CPR, ch = i % CPR;
    const bool ok = r0 + row < p.rows;
    const bf* src = ok ? q + row_off(p, w.b, w.h, r0 + row, D) + ch * 8 : q;
    cp_async16(smem_u32(qs + swz<SC>(row, ch)), src, ok ? 16 : 0);
  }
  stage_table<kThreads>(p, w, pages_s);
  const int lim0 = min(row_limit(p, w.first, r0 + g), w.s_end - 1);
  const int lim1 = min(row_limit(p, w.first, r0 + g + 8), w.s_end - 1);
  __syncthreads();                                     // table entries staged

  const int ntiles = (w.ntok + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_tile<bf, D, kThreads, kTile>(p, w, pages_s, st,
                                                ring + st * 2 * KVT,
                                                ring + st * 2 * KVT + KVT);
    cp_async_commit();                                 // (Q rides in group 0)
  }

  uint32_t qf[HQ ? KD : 1][4];                        // (HQ) Q fragments
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int jn = j + kStages - 1;
      if (jn < ntiles) {
        uint4* st = ring + (jn % kStages) * 2 * KVT;
        load_tile<bf, D, kThreads, kTile>(p, w, pages_s, jn, st, st + KVT);
      }
      cp_async_commit();
    }
    if constexpr (HQ) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_a<SC>(qs, 0, kk, lane, qf[kk]);
      }
    }
    const int rel0 = j * kTile + warp * kWarpTokens;   // this warp's 16 tokens
    if (rel0 >= w.ntok) continue;
    const uint4* kt = ring + (j % kStages) * 2 * KVT;
    const uint4* vt = kt + KVT;
    const int r_kv = warp * kWarpTokens;

    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], b0, b1, b2, b3;
      if constexpr (HQ) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_a<SC>(qs, 0, kk, lane, qa);
      }
      ldsm_x4(smem_u32(kt + swz<SC>(r_kv + (lane & 7) + (lane >> 4) * 8,
                                     kk * 2 + ((lane >> 3) & 1))),
              b0, b1, b2, b3);
      mma_bf16(sc[0], qa, b0, b1);
      mma_bf16(sc[1], qa, b2, b3);
    }

    // scale into the log2 domain; mask each row at its own causal bound
    const int kbase = w.s0 + rel0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + nt * 8 + 2 * t + (e & 1);
        const bool live = kpos <= ((e >> 1) ? lim1 : lim0);
        sc[nt][e] = live ? sc[nt][e] * p.scale_log2 : kNegInf;
      }
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
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = (e >> 1) ? mn1 : mn0;
        sc[nt][e] = sc[nt][e] == kNegInf ? 0.f : exp2f(sc[nt][e] - mn);
      }
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

    // O += P V: P from the score accumulators as bf16 hi + lo A fragments
    // (two products), V by ldmatrix.trans
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(smem_u32(vt + swz<SC>(r_kv + (lane & 7) +
                                               ((lane >> 3) & 1) * 8,
                                           dp * 2 + (lane >> 4))),
                    b0, b1, b2, b3);
      mma_bf16(o[2 * dp], ph, b0, b1);
      mma_bf16(o[2 * dp], pl, b0, b1);
      mma_bf16(o[2 * dp + 1], ph, b2, b3);
      mma_bf16(o[2 * dp + 1], pl, b2, b3);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  cp_async_wait<0>();
  __syncthreads();                                     // the ring is free
  float* st_m = reinterpret_cast<float*>(ring);
  float* st_l = st_m + kWarps * kMmaRows;
  float* st_o = st_l + kWarps * kMmaRows;
  const int ra = warp * kMmaRows + g, rb8 = ra + 8;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int col = i * 8 + 2 * t;
    st_o[ra * D + col] = o[i][0];
    st_o[ra * D + col + 1] = o[i][1];
    st_o[rb8 * D + col] = o[i][2];
    st_o[rb8 * D + col + 1] = o[i][3];
  }
  if (t == 0) {
    st_m[ra] = m0;
    st_m[rb8] = m1;
    st_l[ra] = l0;
    st_l[rb8] = l1;
  }
  __syncthreads();
  combine_warps<bf, D, kMmaRows, kWarps>(p, w, st_m, st_l, st_o);
}

// ---------------------------------------------------------------------------
// merge of the splits' partial states, in split order
// ---------------------------------------------------------------------------
template <typename T, int CHUNK>
__device__ __forceinline__ void merge_body(const Params& p, int d) {
  // one thread per output element; ceil(R * D / kThreads) CTAs a kv head
  const int per = (p.rows * d + kThreads - 1) / kThreads;
  const int i = (blockIdx.x % per) * kThreads + threadIdx.x;
  if (i >= p.rows * d) return;
  const int bh = blockIdx.x / per;
  const int r = i / d, c = i % d;
  const long long at = (long long)bh * p.nsplit * p.rows + r;
  const float* ml = p.part +
                    (long long)p.batch * p.hkv * p.nsplit * p.rows * d +
                    at * 2;                    // split s at ml[s * sm]
  const float* acc = p.part + at * d + c;      // split s at acc[s * sa]
  const long long sm = 2LL * p.rows, sa = (long long)p.rows * d;
  // Splits in order, CHUNK at a time: the CHUNK states are loaded at once,
  // then folded into the running (max, sum, accumulator). A split without a
  // live position of row r has m = -1e30, l = 0 and is skipped (its
  // accumulator may be unwritten).
  float mx = kNegInf, l = 0.f, o = 0.f;
  for (int s0 = 0; s0 < p.nsplit; s0 += CHUNK) {
    float mv[CHUNK], lv[CHUNK], av[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const bool in = s0 + k < p.nsplit;
      mv[k] = in ? ml[(s0 + k) * sm] : kNegInf;
      lv[k] = in ? ml[(s0 + k) * sm + 1] : 0.f;
      av[k] = in ? acc[(s0 + k) * sa] : 0.f;
    }
    float mn = mx;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) mn = fmaxf(mn, mv[k]);
    const float corr = exp2f(mx - mn);
    l *= corr;
    o *= corr;
    mx = mn;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (mv[k] > kNegInf) {
        const float a = exp2f(mv[k] - mx);
        l = fmaf(a, lv[k], l);
        o = fmaf(a, av[k], o);
      }
    }
  }
  const int b = bh / p.hkv, h = bh % p.hkv;
  static_cast<T*>(p.out)[row_off(p, b, h, r, d) + c] =
      from_f<T>(o / fmaxf(l, 1e-30f));
}

// One __global__ per entry point, so a profile tells decode from verify.
template <typename T, int D>
__global__ void __launch_bounds__(32 * cc_warps<T, D>())
    paged_decode_kernel(Params p) {
  cuda_core_body<T, D>(p);
}
template <typename T, int D>
__global__ void __launch_bounds__(32 * cc_warps<T, D>())
    paged_verify_kernel(Params p) {
  cuda_core_body<T, D>(p);
}
template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_mma_kernel(Params p) {
  mma_body<D>(p);
}
template <int D>
__global__ void __launch_bounds__(kThreads) paged_verify_mma_kernel(Params p) {
  mma_body<D>(p);
}
// CHUNK: splits whose states a merge thread loads at once (8, or 16 where
// there are more than 8 splits: one round of loads at the main decode shape)
template <typename T, int CHUNK>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(Params p, int d) {
  merge_body<T, CHUNK>(p, d);
}
template <typename T, int CHUNK>
__global__ void __launch_bounds__(kThreads)
    paged_verify_merge_kernel(Params p, int d) {
  merge_body<T, CHUNK>(p, d);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename K>
int launch_split(K kernel, const Params& p, int threads, size_t smem,
                 cudaStream_t st) {
  const long long grid = (long long)p.batch * p.hkv * p.nrb * p.nsplit;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(int path, bool verify, Params p, cudaStream_t st) {
  const size_t table = (size_t)p.pps * sizeof(int);
  constexpr int kCcThreads = 32 * cc_warps<T, D>();
  int err = -1;
  if constexpr (mma_dim(D)) {
    if (path == 1) {
      p.nrb = (p.rows + kMmaRows - 1) / kMmaRows;
      const size_t smem = ring_bytes<__nv_bfloat16, D, kTile>() +
                          kMmaRows * slot_chunks(D / 8) * 16 + table;
      err = launch_split(
          verify ? paged_verify_mma_kernel<D> : paged_decode_mma_kernel<D>, p,
          kThreads, smem, st);
    }
  }
  if (path != 1) {
    p.nrb = (p.rows + kCcRows - 1) / kCcRows;
    err = launch_split(
        verify ? paged_verify_kernel<T, D> : paged_decode_kernel<T, D>, p,
        kCcThreads, ring_bytes<T, D, cc_tile<T, D>()>() + table, st);
  }
  if (err || p.nsplit == 1) return err;
  const long long grid = (long long)p.batch * p.hkv *
                         ((p.rows * D + kThreads - 1) / kThreads);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool wide = p.nsplit > 8;
  auto merge = verify ? (wide ? paged_verify_merge_kernel<T, 16>
                              : paged_verify_merge_kernel<T, 8>)
                      : (wide ? paged_decode_merge_kernel<T, 16>
                              : paged_decode_merge_kernel<T, 8>);
  merge<<<(unsigned)grid, kThreads, 0, st>>>(p, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int path, bool verify, const Params& p, int d, cudaStream_t st) {
  if (d == 16) return launch_d<T, 16>(path, verify, p, st);
  if (d == 32) return launch_d<T, 32>(path, verify, p, st);
  if (d == 64) return launch_d<T, 64>(path, verify, p, st);
  if (d == 112) return launch_d<T, 112>(path, verify, p, st);
  if (d == 128) return launch_d<T, 128>(path, verify, p, st);
  if (d == 256) return launch_d<T, 256>(path, verify, p, st);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const void* q, const void* kp, const void* vp, const void* table,
             const void* idx, void* out, void* part, int b, int hkv, int g,
             int sq, int d, int page, int maxp, int nsplit, int pps,
             int dtype, bool verify, void* stream, int* path) {
  Params p;
  p.q = q;
  p.kp = kp;
  p.vp = vp;
  p.table = static_cast<const int*>(table);
  p.idx = static_cast<const int*>(idx);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.off = verify ? 0 : -1;
  p.batch = b;
  p.hkv = hkv;
  p.g = g;
  p.sq = sq;
  p.rows = sq * g;
  p.page = page;
  p.maxp = maxp;
  p.pps = pps;
  p.nsplit = nsplit;
  p.nrb = 1;
  p.vec = aligned16(kp) && aligned16(vp);
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)d);   // log2(e)/sqrt(D)
  *path = dtype == 1 && p.vec && aligned16(q) && aligned16(out) && mma_dim(d);
  if (b == 0 || p.rows == 0) return 0;
  if (nsplit < 1 || pps < 1 || page < 1 || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(*path, verify, p, d, st);
  return launch_t<__nv_bfloat16>(*path, verify, p, d, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, 64, 112, 128, 256}.
// nsplit and pages_per_split come from ops.py:split_rule; `partials` holds
// B * Hkv * nsplit * R * (D + 2) floats (R = G, or Sq * G) when nsplit > 1,
// else may be null. Writes the body it takes to *path: 1 ("mma") for bf16
// with 16-byte-aligned pointers, else 0 ("cuda_core"). Returns
// cudaGetLastError() after its launches.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lengths, void* out,
                                     void* partials, int b, int hkv, int g,
                                     int d, int page, int maxp, int nsplit,
                                     int pages_per_split, int dtype,
                                     void* stream, int* path) {
  return dispatch(q, k_pages, v_pages, table, lengths, out, partials, b, hkv,
                  g, 1, d, page, maxp, nsplit, pages_per_split, dtype, false,
                  stream, path);
}

extern "C" int repro_paged_attention_verify(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* pos, void* out, void* partials, int b,
    int hkv, int g, int sq, int d, int page, int maxp, int nsplit,
    int pages_per_split, int dtype, void* stream, int* path) {
  return dispatch(q, k_pages, v_pages, table, pos, out, partials, b, hkv, g,
                  sq, d, page, maxp, nsplit, pages_per_split, dtype, true,
                  stream, path);
}
