// Tensor-core helpers for the bf16 bodies of rbgp4mm_rhs.cu,
// rbgp4_sddmm_rhs.cu, chainmm_rhs.cu and chain_sddmm_rhs.cu (sm_90a):
// 16-byte cp.async into shared memory, ldmatrix (plain and .trans),
// mma.sync m16n8k16 with f32 sums, bf16x2 packing, the XOR swizzle that
// keeps ldmatrix free of bank conflicts, and the launchers' 16-byte
// alignment check.
//
// A shared-memory tile here is rows of W 16-byte chunks (8 bf16 each).
// ldmatrix reads eight rows of one chunk column at a time; the eight
// 16-byte reads are conflict-free when they land in the eight distinct
// 16-byte bank groups of a 128-byte line.  Row r's chunk j is stored at
// chunk j ^ f(r), with f chosen per row width W so that the eight rows of
// any 8-row phase cover all eight groups:
//   W >= 8: f(r) = r & 7           (a row spans whole lines)
//   W == 4: f(r) = (r >> 1) & 3    (two rows a line)
//   W == 2: f(r) = (r >> 2) & 1    (four rows a line)
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma_bf16 {

// host: whether an operand can be read 16 bytes at a time
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with valid false the 16
// bytes are zero-filled and nothing is read (src must still be a mapped
// address of the same allocation).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, lo in the low half (the lower
// address once stored)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// element offset of chunk j of row r in a swizzled tile of W chunks a row
template <int W>
__device__ __forceinline__ int swz(int r, int j) {
  static_assert(W == 2 || W == 4 || W % 8 == 0, "row width in chunks");
  int f;
  if constexpr (W >= 8)
    f = r & 7;
  else if constexpr (W == 4)
    f = (r >> 1) & 3;
  else
    f = (r >> 2) & 1;
  return (r * W + (j ^ f)) * 8;
}

}  // namespace mma_bf16
