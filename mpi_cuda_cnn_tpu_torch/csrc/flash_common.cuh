// Pieces shared by the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// All of them (`flash_fwd_*_kernel`, `flash_bwd_dq_*_kernel`,
// `flash_bwd_dkv_*_kernel`, in bf16 and float32) work on 64-row tiles with
// 128 threads, 4 warps of 16 rows, on `mma.sync` (mma.cuh): tiles stay in
// their input type in shared memory (float32 ones split into tf32 pairs,
// 3xTF32) and the logits live in the products' accumulator fragments.
//
// Tensors are (B, S, NH, D) and contiguous; lse and dvec are (B * H, S)
// float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace flash {

constexpr int kTile = 64;      // query rows of a q tile, keys of a k/v tile
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 256;   // the largest instance

// The head dims the three kernels are built for (`HEAD_DIMS` in
// ops/flash_attention.py, which pads any other D <= 256 with zeros to
// the next of them): f(std::integral_constant<int, D>{}) for D among
// them, cudaErrorInvalidValue for any other. 80, 96 and 256 are the
// published head dims of Phi-2, Phi-3-mini and Gemma-7B.
template <typename F>
cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// Rows of a streamed tile: the keys of a K7 or K8 k/v tile, the queries
// of a K9 q/dO tile. 64, but beyond D 128 narrower, so that the tiles fit
// in a block's 227 KB and the logit fragments beside the (16, D) float32
// accumulators stay small: 32 keys in K7 (float32) and K8, 16 queries in
// K9 (float32). A streamed tile that meets the causal diagonal is masked
// element by element (key <= query).
template <int D>
constexpr int kStreamRowsF32Fwd = D > 128 ? 32 : kTile;
template <int D>
constexpr int kStreamRowsDq = D > 128 ? 32 : kTile;
template <int D>
constexpr int kStreamRowsF32Dkv = D > 128 ? 16 : kTile;

// K9's output columns a block owns: all D, but beyond D 128 half of them,
// each (batch, query head, key tile) taken by two blocks that both
// rebuild p^T and ds^T over the full D, so that the (16, D / 2) float32
// dk and dv accumulators fit in the registers (two of (16, 256) would
// need 256 a thread).
template <int D>
constexpr int kDkvSplit = D > 128 ? 2 : 1;

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The float32 flash kernels (flash_fwd.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu) run m16n8k8 tf32 as 3xTF32 (mma.cuh). Their tiles are
// float32 in shared memory, (64, D) with rows of D + 4 floats (16 bytes of
// padding), read with plain 32- and 64-bit loads (`ldmatrix` moves 16-bit
// elements and has no tf32 form); an operand is split into (hi, lo) as it
// is read, or once into hi and lo tiles of the same layout.
//
// First products (s = q k^T, dp = dO v^T and their transposes) sum over
// d, whose order inside a k-chunk of 8 is free: A slot t and B row t take
// d 2t, slot t + 4 and row t + 4 take d 2t + 1, so a lane's two A
// elements of a row, and its two B elements, are one float2 each (row g
// of a 16-row A block or of an 8-row B block, columns 2t and 2t + 1: the
// 8-byte word 2g + t of the row pair, mod 16, two lanes on each bank pair,
// so a warp's 64-bit load takes the two passes any 256 bytes take).
template <int D>
constexpr int kLdF32 = D + 4;

// A fragment (hi, lo) from `p` = &tile[row0 + g][kc * 8 + 2t]: rows g and
// g + 8, d 2t (slots t) and 2t + 1 (slots t + 4).
template <int LD>
__device__ __forceinline__ void frag_a_tf32(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const float* p) {
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * LD);
  mma::split_tf32(r0.x, hi[0], lo[0]);
  mma::split_tf32(r1.x, hi[1], lo[1]);
  mma::split_tf32(r0.y, hi[2], lo[2]);
  mma::split_tf32(r1.y, hi[3], lo[3]);
}

// B fragment (hi, lo) of a first product from `p` = &tile[n0 + g][kc * 8 +
// 2t]: the [n][d] tile as the col-major B, d 2t (row t) and 2t + 1 (row
// t + 4).
__device__ __forceinline__ void frag_b_tf32(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2],
                                            const float* p) {
  const float2 r = *reinterpret_cast<const float2*>(p);
  mma::split_tf32(r.x, hi[0], lo[0]);
  mma::split_tf32(r.y, hi[1], lo[1]);
}

// First products (s = q k^T, dp = dO v^T and their transposes) sum over
// D / 8 k-chunks of 8. At D 256 one chain of 32 chunks (96 tensor-core
// sums, which may truncate) measured up to 1e-5 of max|.| off its plain
// version on an H100; so the chunks are summed in chains of at most
// kFirstChain (D 128's 16) from zero, each chain added in float32.
constexpr int kFirstChain = 16;

// Second products (o += p v, dq += ds k, dv += p^T dO, dk += ds^T q):
// acc[dn] += x y[:, dn * 8 .. +8] over NJ k-chunks of 8 (dn < ND; the
// last group may be short, as at D 80), where x (16 x
// 8 NJ) is held in its accumulator fragments (n-tile j = k-chunk j) and y
// is a row-major [k][d] tile from `y` = &tile[k0 + 2t][g]. x is split and
// permuted into A fragments (mma.cuh: slot t <-> column 2t, t + 4 <-> 2t
// + 1), so B row t is read from k row 2t and row t + 4 from 2t + 1, column
// g: bank 8t + g under the D + 4 stride, all 32. Up to kMaxGroup column
// tiles are summed at once, each in its own accumulator that starts from
// zero (independent chains of 3 NJ tensor-core sums), then added to acc in
// float32: a tensor core may truncate its float32 sums, and a bias carried
// over a whole row of tiles (768 sums at S 2048) would reach 1e-5, where
// over one tile's 3 NJ it stays near float32 rounding
// (tests/test_torch_flash_tf32x3.py).
template <int NJ, int ND, int LD, int kMaxGroup>
__device__ __forceinline__ void permuted_product_tf32x3(
    float (&acc)[ND][4], const float (&x)[NJ][4], const float* y) {
  constexpr int kGroup = ND < kMaxGroup ? ND : kMaxGroup;
  uint32_t xh[NJ][4], xl[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mma::split_tf32(x[j][mma::acc_to_a(e)], xh[j][e], xl[j][e]);
#pragma unroll
  for (int d0 = 0; d0 < ND; d0 += kGroup) {
    float part[kGroup][4];
#pragma unroll
    for (int dn = 0; dn < kGroup; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[dn][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int dn = 0; dn < kGroup; ++dn) {
        if (d0 + dn < ND) {
          const float* p = y + 8 * j * LD + (d0 + dn) * 8;
          uint32_t bh[2], bl[2];
          mma::split_tf32(p[0], bh[0], bl[0]);
          mma::split_tf32(p[LD], bh[1], bl[1]);
          mma::mma_tf32x3(part[dn], xh[j], xl[j], bh, bl);
        }
      }
#pragma unroll
    for (int dn = 0; dn < kGroup; ++dn)
      if (d0 + dn < ND)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d0 + dn][e] += part[dn][e];
  }
}

// The launch geometry the wrapper planned (`flash_fwd_plan` and
// `flash_bwd_plan` in ops/flash_attention.py); the launch functions refuse
// a plan that is not their kernel's own.
struct Plan {
  int grid_x, grid_y, threads, smem;
  bool is(int gx, int gy, int th, size_t bytes) const {
    return grid_x == gx && grid_y == gy && threads == th &&
           static_cast<size_t>(smem) == bytes;
  }
};

}  // namespace flash
