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

// ---------------------------------------------------------------------------
// Head dims above kMaxHeadDim: the wide kernels (`flash_fwd_wide_kernel`,
// `flash_bwd_dq_wide_kernel`, `flash_bwd_dkv_wide_kernel`), for any D that
// is a multiple of kWideCols (the wrapper zero-pads any other D above 256
// to the next one). A simple design, on the CUDA cores in float32 for both
// input types:
//   - a block owns one 64-row tile of its outputs (K7's o and K8's dq:
//     query rows; K9's dk and dv: keys) and kWideCols of their columns, so
//     its accumulators are 4 x 4 floats a thread whatever D is; the
//     column chunks of one tile are blocks of their own, and each computes
//     the tile's logits (and K8's and K9's dO v^T) over the whole D again;
//   - the first products (q k^T, dO v^T) stream D in chunks of kWideCols
//     columns through two (64, 64) float32 tiles in shared memory, each
//     chunk summed from zero and added in float32, so shared memory no
//     longer bounds D;
//   - the second products (p v, ds k, ds^T q, p^T dO) take the (64, 64)
//     p or ds tile, rounded to the input type as the mma kernels round it,
//     and the chunk's columns of the other operand through the same two
//     tiles;
//   - 256 threads, 16 x 16, thread (ty, tx) holding rows 4 ty .. 4 ty + 3
//     and columns 4 tx .. 4 tx + 3 of each 64 x 64 tile; a row's max and
//     sum run over its 16 threads (one half-warp) by xor-shuffles;
//   - K9 sums the GQA group inside the block (the group's query heads one
//     after another), so it needs no second kernel and no scratch.
constexpr int kWideThreads = 256;
constexpr int kWideCols = 64;
constexpr int kWideLd = kTile + 4;  // a staged row: 64 floats + 16 bytes
constexpr size_t kWideSmem = 2 * kTile * kWideLd * sizeof(float);

inline bool wide_head_dim(int D) {
  return D > kMaxHeadDim && D % kWideCols == 0;
}

using WideTile = float (*)[kWideLd];

// The (64, 64) block of rows r0 .. r0 + 63 and columns c0 .. c0 + 63 of a
// row-major tensor whose rows are `stride` elements apart, from `base` =
// the offset of (r0, c0), as float32 into `dst`: dst[r][c], or
// transposed dst[c][r].
template <typename T>
__device__ __forceinline__ void wide_load(WideTile dst, const T* src,
                                          size_t base, size_t stride,
                                          bool transpose) {
  for (int e = threadIdx.x; e < kTile * kWideCols; e += kWideThreads) {
    const int r = e / kWideCols, c = e - r * kWideCols;
    const float x = to_f32(src[base + static_cast<size_t>(r) * stride + c]);
    if (transpose)
      dst[c][r] = x;
    else
      dst[r][c] = x;
  }
}

// part[i][j] = sum over k < 64 of x[k][4 ty + i] * y[k][4 tx + j], from
// zero, k in order.
__device__ __forceinline__ void wide_product(float (&part)[4][4], WideTile x,
                                             WideTile y, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < kTile; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&x[k][4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&y[k][4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
  }
}

// s[i][j] = sum over d < D of a[4 ty + i][d] * b[4 tx + j][d], for the
// 64-row blocks of a and b at `a_base` and `b_base` (rows `a_stride` and
// `b_stride` elements apart), D streamed in chunks of kWideCols through
// the tiles xa and xb (transposed), each chunk summed from zero and added.
// Starts and ends with the block in step (the tiles are free after it
// once every thread has passed a __syncthreads).
template <typename T>
__device__ __forceinline__ void wide_first(float (&s)[4][4], const T* a,
                                           size_t a_base, size_t a_stride,
                                           const T* b, size_t b_base,
                                           size_t b_stride, int D,
                                           WideTile xa, WideTile xb, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kWideCols) {
    __syncthreads();  // the tiles' last readers are done
    wide_load(xa, a, a_base + d0, a_stride, true);
    wide_load(xb, b, b_base + d0, b_stride, true);
    __syncthreads();
    float part[4][4];
    wide_product(part, xa, xb, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += part[i][j];
  }
}

// Max and sum over the 16 threads of a row (lanes that differ in bits
// 0-3 of their index).
__device__ __forceinline__ float wide_row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float wide_row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Four neighbouring output columns of a row, as float32 or rounded to T.
template <typename T>
__device__ __forceinline__ void wide_store4(void* out, size_t at, bool f32,
                                            const float (&x)[4]) {
  if (f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
        make_float4(x[0], x[1], x[2], x[3]);
  } else {
    T* o = static_cast<T*>(out) + at;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = from_f32<T>(x[j]);
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
