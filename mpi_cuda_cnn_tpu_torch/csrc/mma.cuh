// Device helpers for kernels that feed Hopper's tensor cores through
// `mma.sync`: 16-byte `cp.async` copies into shared memory (zero-filled
// where the source is out of bounds), `ldmatrix` of four 8 x 8 bf16
// matrices (plain and transposed), the m16n8k16 bf16 product with float32
// accumulators, and bf16x2 packing; for float32 operands the m16n8k8 tf32
// product and "3xTF32" (below).
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
//
// mma.m16n8k8 with tf32 operands (one 32-bit register an element):
//   A (16 x 8, row):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):   b0 (t, g), b1 (t+4, g)                [k, n]
//   C (16 x 8):       as above, c0 c1 (g, 2t..2t+1), c2 c3 (g+8, ..)
// Here a lane's accumulator columns (2t, 2t+1) are not its A columns
// (t, t+4). An accumulator tile is still the A operand of k-chunk j, in
// registers, if the product's k index is permuted inside the chunk: A
// slot t <-> column 2t, slot t+4 <-> column 2t+1, i.e. (a0, a1, a2, a3) =
// (c0, c2, c1, c3) of n-tile j (`acc_to_a`), with B's row t read from row
// 2t of the chunk and row t+4 from row 2t+1. A sum over k does not care
// about the order (tests/test_torch_flash_tf32x3.py).
//
// 3xTF32: tf32 keeps 10 of float32's 23 mantissa bits, so a float32 x
// is split into hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest with ties away (`cvt.rna`'s rounding; x - hi is exact;
// hi + lo is within 2^-22 of x), and a b as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, each product of tf32 values exact, summed in the float32
// accumulator, the small terms first. The dropped lo_a lo_b is below
// 2^-22 of the product: float32 accuracy at three tf32 products (495
// TFLOP/s dense on the H100, 165 effective, against 67 for float32 FMA).

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

// x rounded to tf32, to nearest with ties away from zero, as the .b32
// operand of a tf32 mma (its 13 low bits zero): the bits of
// `cvt.rna.tf32.f32` for every finite x, in two integer operations (half
// of the dropped 13 bits added to the sign-magnitude pattern, then
// truncated). On sm_90 `cvt.rna.tf32.f32` itself compiles to about four
// (a guard for NaN and infinity around the same rounding), and the
// float32 flash backward splits about 480 operands a lane per tile, all
// finite.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (within 2^-22 of x), both tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// A slot e of k-chunk j is accumulator element acc_to_a(e) of n-tile j:
// (0, 1, 2, 3) <- (0, 2, 1, 3).
__host__ __device__ constexpr int acc_to_a(int e) {
  return e == 1 ? 2 : e == 2 ? 1 : e;
}

// d += a (16 x 8 tf32) @ b (8 x 8 tf32), float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a @ b in float32 accuracy from split operands (3xTF32): lo.hi,
// hi.lo, then hi.hi.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

}  // namespace mma
