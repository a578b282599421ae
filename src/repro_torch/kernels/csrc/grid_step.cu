// One synchronous step of masked 4-neighbour max-diffusion on the
// blackboard (Hopper, sm_90a): labels, cond (H, W) int32 -> out (H, W) int32,
//
//   out[r, c] = max over the four directions d of (labels[n_d] if the
//               neighbour n_d lies inside the grid and cond[n_d] > 0,
//               else 0), and labels[r, c]       where cond[r, c] > 0,
//   out[r, c] = labels[r, c]                    elsewhere.
//
// The edges are zero-padded (no wrap): a neighbour outside the grid counts
// as 0. That is ref.py::grid_step_ref exactly, for any int32 input
// (negative labels, cond values outside {0, 1}, any H and W).
//
// Replaces: src/repro/kernels/grid_step/kernel.py:grid_step (Pallas body
// _kernel). The TPU kernel tiles rows into bands and fetches the halo rows
// through three BlockSpecs with clamped index maps; a CUDA thread can read
// its neighbours directly, so none of that carries over.
//
// What bounds it on this card: bytes. A cell reads two int32 words of its
// own and up to eight of its neighbours' (which the neighbouring threads of
// the warp and the rows above and below load too, so they come from L1/L2),
// and writes one: 12 bytes per cell from device memory, about one integer
// comparison per byte. At the extractor's 80 x 128 planes a call moves
// 123 KB, so launch latency, not the kernel, sets its time. What the design
// does about it: one thread per cell, threads of a warp on consecutive
// columns so every load and the store coalesce along W; a grid-stride loop
// over the flattened plane, so any H and W (H = 1, W = 1, H = 33) need no
// tiling and no edge cases beyond the four bounds tests. No shared-memory
// tile: the neighbour reads hit L1, and a halo tile would only pay at sizes
// the extractor never runs.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // 16 blocks per SM of an H100

__global__ void __launch_bounds__(kThreads)
grid_step_kernel(const int* __restrict__ labels, const int* __restrict__ cond,
                 int* __restrict__ out, int h, int w) {
  const long long n = static_cast<long long>(h) * w;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int lab = labels[i];
    if (cond[i] <= 0) {
      out[i] = lab;
      continue;
    }
    const int r = static_cast<int>(i / w);
    const int c = static_cast<int>(i - static_cast<long long>(r) * w);
    // each direction adds its neighbour's label where that neighbour lies
    // inside the grid and conducts, and 0 otherwise (the reference's
    // where(..., 0)), so a negative label rises to 0 unless all four
    // neighbours conduct
    int m = lab;
    m = max(m, (r + 1 < h && cond[i + w] > 0) ? labels[i + w] : 0);
    m = max(m, (r > 0 && cond[i - w] > 0) ? labels[i - w] : 0);
    m = max(m, (c + 1 < w && cond[i + 1] > 0) ? labels[i + 1] : 0);
    m = max(m, (c > 0 && cond[i - 1] > 0) ? labels[i - 1] : 0);
    out[i] = m;
  }
}

}  // namespace

extern "C" int repro_grid_step(const void* labels, const void* cond, void* out,
                               int h, int w, void* stream) {
  const long long n = static_cast<long long>(h) * w;
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  grid_step_kernel<<<static_cast<int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), static_cast<const int*>(cond),
      static_cast<int*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
