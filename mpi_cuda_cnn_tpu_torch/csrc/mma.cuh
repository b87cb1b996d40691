// Device helpers for kernels that feed Hopper's tensor cores through
// `mma.sync` (conv_direct.cu, flash_fwd.cu): 16-byte `cp.async` copies
// into shared memory (zero-filled where the source is out of bounds),
// `ldmatrix` of four 8 x 8 bf16 matrices (plain and transposed), the
// m16n8k16 bf16 product with float32 accumulators, and bf16x2 packing.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = threadIdx.x % 32, g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)                    [row, k]
//   B (16 x 8, col):  b0 (2t..2t+1, g), b1 (2t+8.., g)     [k, n]
//   C (16 x 8):       c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// so C's (c0 c1 | c2 c3 of n-tile 2j, of n-tile 2j+1) are, rounded to
// bf16 and packed, exactly A's (a0 | a1 | a2 | a3) for k-chunk j: the
// flash forward's p goes from accumulator to operand in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst` (both 16-byte aligned),
// asynchronously; with `valid` false nothing is read and dst is zeroed
// (a source size of 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `N` committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 matrices of 16-bit elements; lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes), and receives element
// (l / 4, 2 (l % 4) .. +1) of each matrix in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane l receives elements
// (2 (l % 4) .. +1, l / 4) of the stored rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) and packed, lo in the low
// half: the layout of an A or B register pair.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mma
