// One synchronous step of masked 4-neighbour max-diffusion on the
// blackboard (Hopper, sm_90a), for a stack of planes: labels, cond
// (L, H, W) int32 -> out (L, H, W) int32, every plane on its own,
//
//   out[p, r, c] = max over the four directions d of (labels[n_d] if the
//                  neighbour n_d lies inside plane p and cond[n_d] > 0,
//                  else 0), and labels[p, r, c]       where cond[p, r, c] > 0,
//   out[p, r, c] = labels[p, r, c]                    elsewhere.
//
// The edges are zero-padded (no wrap, nothing crosses a plane boundary): a
// neighbour outside the plane counts as 0. That is ref.py::grid_step_ref
// exactly, for any int32 input (negative labels, cond values outside
// {0, 1}, any L, H and W). A 2-D grid_step call is the L = 1 launch.
//
// Replaces: src/repro/kernels/grid_step/kernel.py:grid_step (Pallas body
// _kernel), and the batched variant its docstring names. The TPU kernel
// tiles rows into bands and fetches the halo rows through three BlockSpecs
// with clamped index maps; here a thread walks its own band of rows and
// reads the two halo rows itself.
//
// What bounds it on this card: bytes. A cell reads two int32 words and
// writes one (12 bytes), with about one integer operation a byte and no
// matrix product, so TMA, wgmma or the tensor cores would add nothing: the
// design is about loads. What it does about them:
// - A grid of (column strip, row band, plane), so no thread divides: each
//   thread owns V = 4 consecutive columns and walks down a band of rows.
// - Per row a thread issues one 16-byte load of labels, one of cond and one
//   16-byte store. It loads kChunk rows at once (independent loads in
//   flight), and keeps the row above and the current row in registers, so a
//   row is read once per band, plus the band's two halo rows.
// - The left and right neighbours of a thread's four columns come from the
//   adjacent lanes by __shfl_up_sync / __shfl_down_sync. Only a warp's two
//   edge lanes (lane 0 for the column left of the warp, lane 31 for the one
//   right of it) read a neighbour column from memory, in one scalar load
//   each of labels and cond a row.
// - Inputs that cannot take 16-byte accesses (W not a multiple of 4, a base
//   pointer not 16-byte aligned, which covers planes that start at odd word
//   offsets) take the same body with V = 1: one column a thread, 4-byte
//   accesses. The entry point picks the body from the shapes and pointers
//   and reports it.
// - A band is one chunk of kChunk = 4 rows (band_rows), so a thread's loads
//   are all in flight at once: the observer's 4 x 80 x 128 stack is 20 CTAs,
//   one wave. Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time,
//   16-byte body), bands of 4 beat bands of 8-128 at every size tried, from
//   that stack to 4 x 4096 x 4096: the halo rows a band re-reads were just
//   read by the band above and come from L2. Loading 2 or 8 rows at once
//   lost at 4096 x 4096. Only planes too tall for grid.y take longer bands.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // a CTA: TX column threads x TY bands
constexpr int kChunk = 4;       // rows a thread loads at once; band % kChunk == 0
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int conducting(int lab, int cnd) {
  return cnd > 0 ? lab : 0;     // what a cell gives its neighbours
}

template <int V>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_row(int* __restrict__ p,
                                          const int (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// blockDim (TX, TY): TX threads across a strip of TX * V columns (a multiple
// of 32, so a warp lies in one band), TY bands of `band` rows; grid (strips,
// band groups, planes).
template <int V>
__global__ void __launch_bounds__(kThreads)
grid_step_kernel(const int* __restrict__ labels, const int* __restrict__ cond,
                 int* __restrict__ out, int h, int w, int band) {
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r0 = (blockIdx.y * blockDim.y + threadIdx.y) * band;
  if (r0 >= h) return;                    // the whole warp (one band)
  const int r1 = min(r0 + band, h);       // rows [r0, r1) are written
  const bool live = c0 < w;               // lanes past W only pass zeros on
  const long long plane = static_cast<long long>(blockIdx.z) * h * w;
  const int* __restrict__ lab_p = labels + plane;
  const int* __restrict__ cond_p = cond + plane;
  int* __restrict__ out_p = out + plane;
  // the column an edge lane reads itself: left of the warp for lane 0,
  // right of it for lane 31; none where that column is outside the plane
  const int ec = lane == 0 ? c0 - 1 : c0 + V;
  const bool edge = (lane == 0 || lane == 31) && live && ec >= 0 && ec < w;
  auto at = [w](int r, int c) { return static_cast<long long>(r) * w + c; };

  // the row above the band (the upper halo; 0 above the plane) and row r0
  int up[V], lab[V], cnd[V];
  {
    int hl[V] = {}, hc[V] = {};
    if (live && r0 > 0) {
      load_row<V>(lab_p + at(r0 - 1, c0), hl);
      load_row<V>(cond_p + at(r0 - 1, c0), hc);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) up[j] = conducting(hl[j], hc[j]);
#pragma unroll
    for (int j = 0; j < V; ++j) lab[j] = cnd[j] = 0;
    if (live) {
      load_row<V>(lab_p + at(r0, c0), lab);
      load_row<V>(cond_p + at(r0, c0), cnd);
    }
  }
  int ecur = 0;                           // the edge column's value, row r0
  if (edge) ecur = conducting(__ldg(lab_p + at(r0, ec)),
                              __ldg(cond_p + at(r0, ec)));

  for (int o = r0; o < r1; o += kChunk) {
    // rows o + 1 .. o + kChunk: the rows below this chunk's output rows,
    // the last one the band's lower halo; 0 below the plane
    int nl[kChunk][V], nc[kChunk][V], el[kChunk], en[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int r = o + 1 + k;
      const bool in = r <= r1 && r < h;
#pragma unroll
      for (int j = 0; j < V; ++j) nl[k][j] = nc[k][j] = 0;
      el[k] = en[k] = 0;
      if (live && in) {
        load_row<V>(lab_p + at(r, c0), nl[k]);
        load_row<V>(cond_p + at(r, c0), nc[k]);
      }
      if (edge && in) {
        el[k] = __ldg(lab_p + at(r, ec));
        en[k] = __ldg(cond_p + at(r, ec));
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int r = o + k;
      if (r >= r1) break;                 // the ragged last band (whole warp)
      int cur[V];
#pragma unroll
      for (int j = 0; j < V; ++j) cur[j] = conducting(lab[j], cnd[j]);
      int left = __shfl_up_sync(kFull, cur[V - 1], 1);
      int right = __shfl_down_sync(kFull, cur[0], 1);
      if (lane == 0) left = ecur;
      if (lane == 31) right = ecur;
      int res[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int lv = j == 0 ? left : cur[j - 1];
        const int rv = j == V - 1 ? right : cur[j + 1];
        const int dn = conducting(nl[k][j], nc[k][j]);
        const int m = max(max(lab[j], up[j]), max(dn, max(lv, rv)));
        res[j] = cnd[j] > 0 ? m : lab[j];
      }
      if (live) store_row<V>(out_p + at(r, c0), res);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        up[j] = cur[j];
        lab[j] = nl[k][j];
        cnd[j] = nc[k][j];
      }
      ecur = conducting(el[k], en[k]);
    }
  }
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// Rows a band: one chunk, or as many as keep the band groups within
// grid.y's 65535.
int band_rows(int h, int ty) {
  return kChunk * ceil_div(ceil_div(h, 65535LL * ty), kChunk);
}

template <int V>
int launch(const int* labels, const int* cond, int* out, int planes, int h,
           int w, cudaStream_t stream) {
  const int cols = ceil_div(w, V);                       // column threads
  const int tx = cols >= kThreads ? kThreads : 32 * ceil_div(cols, 32);
  const int ty = kThreads / tx;
  const int band = band_rows(h, ty);
  const dim3 grid(ceil_div(cols, tx), ceil_div(ceil_div(h, band), ty),
                  planes);
  grid_step_kernel<V><<<grid, dim3(tx, ty), 0, stream>>>(labels, cond, out,
                                                          h, w, band);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The body taken is written to *path: 1 for the 16-byte body (W a multiple
// of 4 and all three pointers 16-byte aligned), 0 for the 4-byte one.
extern "C" int repro_grid_step(const void* labels, const void* cond, void* out,
                               int planes, int h, int w, void* stream,
                               int* path) {
  const bool vec = w % 4 == 0 && aligned16(labels) && aligned16(cond) &&
                   aligned16(out);
  *path = vec ? 1 : 0;
  if (planes == 0 || h == 0 || w == 0) return 0;
  if (planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const int*>(labels);
  const auto* c = static_cast<const int*>(cond);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<4>(l, c, o, planes, h, w, s)
             : launch<1>(l, c, o, planes, h, w, s);
}
