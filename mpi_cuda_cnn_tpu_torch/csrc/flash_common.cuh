// Pieces shared by the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// The float32 kernels (`flash_fwd_kernel`, `flash_bwd_dq_kernel`,
// `flash_bwd_dkv_kernel`) work on 64 x 64 tiles with 256 threads laid out
// as a 16 x 16 grid: thread (ty, tx) owns tile rows ty + 16 i (i < 4) and,
// of a 64-wide logit tile, columns tx + 16 j (j < 4); of a (64, D) output
// tile, columns tx + 16 j (j < D / 16). The 16 threads of one row group
// are the 16 low lanes or the 16 high lanes of one warp, so a row
// reduction is four xor-shuffles. Tiles are staged in shared memory as
// float32 and every product is a float32 FMA (TF32 is off, so float32
// cannot use the tensor cores).
//
// The bf16 kernels (`flash_fwd_bf16_kernel`, `flash_bwd_dq_bf16_kernel`,
// `flash_bwd_dkv_bf16_kernel`) keep the 64-row tiles but run 128 threads,
// 4 warps of 16 rows, on `mma.sync` (mma.cuh): tiles stay bf16 in shared
// memory and the logits live in the products' accumulator fragments.
//
// Tensors are (B, S, NH, D) and contiguous; lse and dvec are (B * H, S)
// float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace flash {

constexpr int kTile = 64;      // query rows of a q tile, keys of a k/v tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // tile rows per thread
constexpr int kCols = 4;       // logit columns per thread
constexpr int kMmaThreads = 128;  // the bf16 kernels: 4 warps x 16 rows
// Row stride of a (64, 64) logit tile in shared memory: the two row groups
// of a warp (rows r and r + 1) then sit 16 banks apart, so neither the
// stores of a tile nor the broadcast reads of a row conflict.
constexpr int kLdp = kTile + 16;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Stage rows [row0, row0 + 64) of head `head` of a (B, S, NH, D) tensor as
// float32 into dst, with a row stride of `ld` floats. Neighbouring threads
// read neighbouring elements of a row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int row0, int head, int S, int NH) {
  const T* base = src + ((static_cast<size_t>(b) * S + row0) * NH + head) * D;
  const size_t row_stride = static_cast<size_t>(NH) * D;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * ld + d] = to_f32(base[r * row_stride + d]);
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The launch geometry the wrapper planned (`flash_bwd_plan` in
// ops/flash_attention.py); the backward launch functions refuse a plan
// that is not their kernel's own.
struct Plan {
  int grid_x, grid_y, threads, smem;
  bool is(int gx, int gy, int th, size_t bytes) const {
    return grid_x == gx && grid_y == gy && threads == th &&
           static_cast<size_t>(smem) == bytes;
  }
};

// The scale of the TPU kernels, 1 / sqrt(D) taken in double and rounded
// once, as Python's 1.0 / d ** 0.5 times a float32 array.
inline float softmax_scale(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

}  // namespace flash
