// Building blocks of the tensor-core bodies (flash_attention.cu, moe_gmm.cu)
// on Hopper (sm_90a): 16-byte cp.async copies into XOR-swizzled shared
// tiles, ldmatrix fragment loads and mma.sync m16n8k16 bf16 x bf16 -> fp32.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16", g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                           a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n)       b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32)        c0, c1 = C[g][2t..2t+1]  c2, c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_tc {

// Index, in 16-byte units, of chunk `ch` of row `row` in a shared tile whose
// rows hold CPR chunks (8 bf16 each). The chunk is XOR-ed with a function of
// the row so that the eight row addresses of one ldmatrix 8x8 matrix (eight
// consecutive rows, one chunk) land in eight different 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int kRowsPerLine = CPR >= 8 ? 1 : 8 / CPR;  // rows in 128 bytes
  constexpr int kMask = (CPR >= 8 ? 8 : CPR) - 1;
  return row * CPR + (ch ^ ((row / kRowsPerLine) & kMask));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` = 0 reads nothing and
// fills the 16 bytes with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// A fragments of the 16 x 16 block at rows row0 .. row0 + 15 and k step kk
// (columns 16 kk ..) of a swizzled row-major tile of CPR chunks a row.
template <int CPR>
__device__ __forceinline__ void ldsm_a(const uint4* tile, int row0, int kk,
                                       int lane, uint32_t (&a)[4]) {
  ldsm_x4(smem_u32(tile + swz<CPR>(row0 + (lane & 15), kk * 2 + (lane >> 4))),
          a[0], a[1], a[2], a[3]);
}

// c += a * b on one 16 x 8 x 16 tile, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte chunks of the shared row (the "slot") that holds a row of `chunks`
// live chunks: the row itself where swz keeps every chunk in its row (a
// multiple of 8 chunks, or 1, 2, 4), else the next multiple of 8. D = 112 in
// bf16 has 14 chunks a row: swz<14> would XOR chunks 8-13 into slots 14-15,
// past the row's end, so each row takes a 16-chunk slot whose last two
// chunks are never copied, read or written (the D = 128 tile, 14% of it
// padding) and swz<16> keeps the ldmatrix rows free of bank conflicts.
__host__ __device__ constexpr int slot_chunks(int chunks) {
  return chunks % 8 == 0 || 8 % chunks == 0 ? chunks : (chunks + 7) / 8 * 8;
}

// The head dims of the tensor-core bodies of paged_attention.cu and
// flash_attention.cu (kernels/_build.py:MMA_HEAD_DIMS). At 256 both bodies
// re-read the Q fragments from shared memory at every k step (held, they
// would take 64 registers beside the 128 of the output accumulator), and
// flash takes 32-row K / V tiles so that its ring fits in shared memory. At
// 112 (kimi-k2) the rows lie in 16-chunk slots (slot_chunks) and the loops
// run its 7 k steps of QK^T and 14 n8 tiles of PV.
__host__ __device__ constexpr bool mma_dim(int d) {
  return d == 16 || d == 32 || d == 64 || d == 112 || d == 128 || d == 256;
}

}  // namespace repro_tc
