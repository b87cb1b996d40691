// Stride-1 implicit-GEMM convolution for Hopper (sm_90a), NHWC activations
// and HWIO weights, float32 or bfloat16 (dtype 0 or 1; x, w and y of one
// type):
//
//   y (M, O) = P (M, K) @ W_flat (K, O),   M = N*OH*OW,  K = KH*KW*C,
//   P[m, (ky*KW + kx)*C + c] = x[n, oy + ky - pad, ox + kx - pad, c]
//
// where m = (n, oy, ox), x reads as 0 outside its extent, and W_flat is w
// (KH, KW, C, O) read in place as the (K, O) matrix it already is.
//
// Replaces the TPU kernel `_conv1_gemm_kernel` / `_conv1_gemm` of
// mpi_cuda_cnn_tpu/ops/pallas_conv_gemm.py:47-135 (pallas_call at :123)
// behind `conv2d_pallas_gemm` (:160-173). What carries over is the point
// of that design: the patch tile P exists only on chip, so neither P nor
// a padded copy of x is ever written to device memory. What does not: the
// VMEM batch-tile budget (`_pick_gemm_batch_tile`, :89-111), which has no
// counterpart on this card, and the wrapper's `jnp.pad` and slice
// (:156-157): reads are bounds-checked instead.
//
// What bounds it, at the conv bench's stride-1 shapes (k3 s1 p1; x read
// once, w once, y written once; 2*M*K*O operations; 67 TFLOP/s float32
// without tensor cores, 989 TFLOP/s bf16, 3.35 TB/s):
//
//   N x H x W x C -> O          GFLOP   float32 bound    bf16 bound
//   128 x 32 x 32 x 3 -> 64      0.453  0.0105 ms bytes  0.0052 ms bytes
//   128 x 32 x 32 x 64 -> 64     9.664  0.1442 ms ops    0.0100 ms bytes
//   128 x 16 x 16 x 64 -> 128    4.832  0.0721 ms ops    0.0049 ms ops
//   128 x 8 x 8 x 128 -> 256     4.832  0.0721 ms ops    0.0049 ms ops
//
// In float32 the deep shapes are bound by the FMA rate, so the design
// keeps the FMA units fed: one block of 256 threads per 64-pixel x
// 64-channel output tile, each thread holding a 4 x 4 register tile; K
// walked in slices of 16; each slice's A columns gathered from x into
// shared memory with (ky, kx, c) decoded from the column index (16
// neighbouring threads read 16 neighbouring columns of one pixel, which
// are neighbouring channels, or for C < 16 neighbouring pixels of one
// image row: contiguous in NHWC either way), the B slice read from W_flat
// with neighbouring threads on neighbouring output channels; the next
// slice's loads are issued into registers before the current slice's
// 256 FMAs a thread, so their latency hides behind the arithmetic. A
// ragged K (27 at C = 3) and a ragged M or O are masked on load and
// store. Products accumulate in float32 FMA for either type, along K in
// order, and the sum is rounded to the element type once at the store (the
// TPU kernel's `preferred_element_type=float32` and `astype(o_ref.dtype)`).
// bf16 tiles are staged as float32, which is exact. The bf16 bounds are
// those of tensor cores, which this kernel does not use: mma.sync / wgmma
// with TMA loads is later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "elem.cuh"

namespace {

constexpr int kBM = 64;       // output pixels of a tile
constexpr int kBN = 64;       // output channels of a tile
constexpr int kBK = 16;       // K slice
constexpr int kThreads = 256; // 16 x 16, each 4 x 4 outputs
constexpr int kLdA = kBM + 4; // As row stride: 16-byte rows, 2-way stores
constexpr int kFar = -(1 << 28);  // row offset of a pixel past M: never in bounds

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int N, int H, int W, int C, int O, int KH,
                 int KW, int OH, int OW, int pad) {
  __shared__ __align__(16) float As[kBK][kLdA];  // As[k][m]
  __shared__ __align__(16) float Bs[kBK][kBN];   // Bs[k][n]
  const int tid = threadIdx.x;
  const int M = N * OH * OW;
  const int K = KH * KW * C;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // The four pixels whose A elements this thread gathers: rows
  // tid / 16 + 16 i of the tile, column tid % 16 of every K slice.
  const int a_col = tid & 15;
  size_t a_img[4];
  int a_y[4], a_x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 4) + 16 * i;
    a_img[i] = 0;
    a_y[i] = kFar;
    a_x[i] = kFar;
    if (m < M) {
      const int n = m / (OH * OW);
      const int r = m - n * (OH * OW);
      const int oy = r / OW;
      a_img[i] = static_cast<size_t>(n) * H * W * C;
      a_y[i] = oy - pad;
      a_x[i] = r - oy * OW - pad;
    }
  }
  // The B elements: column tid % 64 of the tile, rows tid / 64 + 4 i.
  const int b_col = n0 + (tid & 63);

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int kk = k0 + a_col;
    int c = 0, kx = 0, ky = kFar;
    if (kk < K) {
      c = kk % C;
      const int t = kk / C;
      kx = t % KW;
      ky = t / KW;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_y[i] + ky;
      const int ix = a_x[i] + kx;
      ra[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? to_f32(__ldg(x + a_img[i] +
                                 (static_cast<size_t>(iy) * W + ix) * C + c))
                  : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + (tid >> 6) + 4 * i;
      rb[i] = (k < K && b_col < O)
                  ? to_f32(__ldg(w + static_cast<size_t>(k) * O + b_col))
                  : 0.f;
    }
  };

  const int tx = tid & 15;   // output columns tx * 4 + j
  const int ty = tid >> 4;   // output rows ty * 4 + i
  float acc[4][4] = {};
  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[a_col][(tid >> 4) + 16 * i] = ra[i];
      Bs[(tid >> 6) + 4 * i][tid & 63] = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < O) y[static_cast<size_t>(m) * O + co] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int N, int H, int W, int C,
            int O, int KH, int KW, int OH, int OW, int pad, cudaStream_t s) {
  const long long M = static_cast<long long>(N) * OH * OW;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (O + kBN - 1) / kBN);
  conv_gemm_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      N, H, W, C, O, KH, KW, OH, OW, pad);
}

}  // namespace

// y (N, OH, OW, O) with OH = H + 2 pad - KH + 1, OW = W + 2 pad - KW + 1.
// Returns cudaGetLastError() after the launch.
extern "C" int conv_gemm_launch(const void* x, const void* w, void* y, int N,
                                int H, int W, int C, int O, int KH, int KW,
                                int pad, int dtype, void* stream) {
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      pad < 0 || OH < 1 || OW < 1 ||
      static_cast<long long>(N) * OH * OW >= (1LL << 31) ||
      static_cast<long long>(KH) * KW * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      launch<float>(x, w, y, N, H, W, C, O, KH, KW, OH, OW, pad, s);
      break;
    case kDtypeBF16:
      launch<__nv_bfloat16>(x, w, y, N, H, W, C, O, KH, KW, OH, OW, pad, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
