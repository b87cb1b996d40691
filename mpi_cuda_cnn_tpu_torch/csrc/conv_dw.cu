// Convolution weight gradient for Hopper (sm_90a), NHWC / HWIO, float32
// or bfloat16 (dtype 0 or 1: x, g and dw of one type):
//
//   dw[ky, kx, c, o] = sum over pixels p = (n, oy, ox) of
//                      x[n, oy*stride + ky - pad, ox*stride + kx - pad, c]
//                      * g[n, oy, ox, o]
//
// with x (N, H, W, C) read as 0 outside its extent, the cotangent g
// (N, OH, OW, O) and dw (KH, KW, C, O).
//
// Replaces the TPU kernel `_conv1_dw_kernel` / `_conv1_dw` of
// mpi_cuda_cnn_tpu/ops/pallas_ops.py:264-319 with its wrapper `_conv_dw`
// (:322-341): there each (ky, kx) is a window^T @ g contraction
// accumulated across batch tiles in the output block, which the TPU's
// sequential grid allows, and a strided conv runs one such kernel per
// phase over padded, phase-sliced copies. Here the stride and padding are
// arguments and the pixel sum is split across blocks: pass 1 gives each
// block a chunk of `chunk` pixels and a tile of 256 outputs and writes its
// partial sums to `part` (nchunks, KH*KW*C*O); pass 2 sums the chunks of
// each output in chunk order. No atomics: dw is the same run to run. The
// partial sums are float32 for either type; pass 2 rounds dw to the
// element type once, the twin of `dw.astype(x.dtype)` (:341).
//
// What bounds it: at reference_cnn's batch-32 shapes the sum runs over
// 6,272 (conv1) or 1,568 (conv2) pixels into 144 or 4,608 outputs, at
// most 14.5 MFLOP and 0.4 MB (well under 1 us of either bound), so the
// kernel is bound by latency and launch. The design spreads the long
// reduction over enough blocks (98 and 450 here) to keep the chains
// short; a warp covers neighbouring output channels, so its reads of g
// are coalesced and its reads of x are broadcasts.

#include <cuda_runtime.h>
#include <stddef.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ part, int N, int H, int W, int C,
                       int O, int KH, int KW, int OH, int OW, int stride,
                       int pad, int chunk) {
  const int nout = KH * KW * C * O;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= nout) return;
  const int o = e % O;
  int t = e / O;
  const int c = t % C;
  t /= C;
  const int kx = t % KW;
  const int ky = t / KW;

  const long long P = static_cast<long long>(N) * OH * OW;
  const long long p0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long p1 = p0 + chunk < P ? p0 + chunk : P;
  float acc = 0.f;
  for (long long p = p0; p < p1; ++p) {
    const int ox = static_cast<int>(p % OW);
    const long long q = p / OW;
    const int oy = static_cast<int>(q % OH);
    const int n = static_cast<int>(q / OH);
    const int iy = oy * stride + ky - pad;
    const int ix = ox * stride + kx - pad;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
    acc = fmaf(to_f32(__ldg(x + ((static_cast<size_t>(n) * H + iy) * W + ix) * C + c)),
               to_f32(__ldg(g + static_cast<size_t>(p) * O + o)), acc);
  }
  part[static_cast<size_t>(blockIdx.x) * nout + e] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                      int nout, int nchunks) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= nout) return;
  float s = 0.f;
  for (int b = 0; b < nchunks; ++b) s += part[static_cast<size_t>(b) * nout + e];
  dw[e] = from_f32<T>(s);
}

template <typename T>
void launch(const void* x, const void* g, void* part, void* dw, int N, int H,
            int W, int C, int O, int KH, int KW, int OH, int OW, int stride,
            int pad, int chunk, cudaStream_t s) {
  const long long P = static_cast<long long>(N) * OH * OW;
  const int nchunks = static_cast<int>((P + chunk - 1) / chunk);
  const int nout = KH * KW * C * O;
  const dim3 grid1(nchunks, (nout + kThreads - 1) / kThreads);
  conv_dw_partial_kernel<T><<<grid1, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part), N, H, W, C, O, KH, KW, OH, OW, stride, pad,
      chunk);
  conv_dw_reduce_kernel<T><<<(nout + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(dw), nout, nchunks);
}

}  // namespace

// `part` holds nchunks * KH*KW*C*O float32 values, nchunks =
// ceil(N*OH*OW / chunk), whatever the element type. Returns
// cudaGetLastError() after both passes.
extern "C" int conv_dw_launch(const void* x, const void* g, void* part, void* dw,
                              int N, int H, int W, int C, int O, int KH, int KW,
                              int OH, int OW, int stride, int pad, int chunk,
                              int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      OH < 1 || OW < 1 || stride < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      launch<float>(x, g, part, dw, N, H, W, C, O, KH, KW, OH, OW, stride, pad,
                    chunk, s);
      break;
    case kDtypeBF16:
      launch<__nv_bfloat16>(x, g, part, dw, N, H, W, C, O, KH, KW, OH, OW,
                            stride, pad, chunk, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
