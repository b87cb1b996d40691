// Direct 2-D convolution for Hopper (sm_90a), NHWC activations and HWIO
// weights, float32 or bfloat16 (dtype 0 or 1, x, w and y of one type):
//
//   y[n, oy, ox, o] = sum over (ky, kx, c) of
//                     xv[n, oy*stride + ky - pt, ox*stride + kx - pl, c]
//                     * wl[ky, kx, c, o]
//
// where xv is x (N, H, W, C) dilated by `dil` (dil - 1 zeros between
// neighbouring pixels, the transposed conv's lhs dilation) and read as 0
// outside it (padding by bounds check, never materialised), and wl is w
// (KH, KW, C, O), or with `flip` the spatially flipped, in/out-swapped
// weights of the forward conv whose input gradient this is:
// wl[ky, kx, c, o] = w[KH-1-ky, KW-1-kx, o, c] with w stored (KH, KW, O, C).
// The caller gives the output extent (OH, OW), which with the far-side
// padding fixes the geometry.
//
// Replaces the TPU kernel `_conv1_kernel` / `_conv1` of
// mpi_cuda_cnn_tpu/ops/pallas_ops.py:136-226, with the wrappers around it:
// `_phases` / `_conv_forward` (:229-261) for the forward of
// `conv2d_pallas` (:344) and the transposed conv of `_conv_bwd`
// (:355-387). The TPU version runs a stride-s conv as s*s stride-1 phase
// convs over padded, phase-sliced copies (a Mosaic workaround, :15-19) and
// the input gradient over an explicitly dilated and padded cotangent. Here
// stride, per-side padding, input dilation and the weight flip are
// arguments of one kernel, so a stride-2 forward is one launch, and the
// input gradient is one launch over the undilated cotangent that skips
// the taps falling on dilation holes.
//
// What bounds it: at reference_cnn's batch-32 shapes a call reads at most
// 100 KB of activations and 18 KB of weights and does at most 14.5 MFLOP
// (under 0.25 us of either bound), so it is bound by latency and launch.
// The simple design: one thread per output element, the output channel
// fastest, so a warp shares one pixel (its input reads are broadcasts)
// and reads neighbouring weights (HWIO keeps o contiguous); weights come
// through the read-only cache (the largest here, 18 KB, stays resident).
// Products accumulate in float32 FMA for either type, in the same order,
// and the sum is rounded to the element type once at the store (the TPU
// kernel's float32 accumulator and `astype(o_ref.dtype)`). Shared-memory
// tiling of input windows and tensor cores are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int N, int H, int W, int C, int O,
                   int KH, int KW, int OH, int OW, int stride, int pt, int pl,
                   int dil, int flip) {
  const size_t total = static_cast<size_t>(N) * OH * OW * O;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % O);
  size_t t = idx / O;
  const int ox = static_cast<int>(t % OW);
  t /= OW;
  const int oy = static_cast<int>(t % OH);
  const int n = static_cast<int>(t / OH);

  float acc = 0.f;
  for (int ky = 0; ky < KH; ++ky) {
    const int vy = oy * stride + ky - pt;
    if (vy < 0 || vy % dil != 0) continue;
    const int iy = vy / dil;
    if (iy >= H) continue;
    for (int kx = 0; kx < KW; ++kx) {
      const int vx = ox * stride + kx - pl;
      if (vx < 0 || vx % dil != 0) continue;
      const int ix = vx / dil;
      if (ix >= W) continue;
      const T* xp = x + ((static_cast<size_t>(n) * H + iy) * W + ix) * C;
      if (flip) {
        const T* wp = w + (static_cast<size_t>(KH - 1 - ky) * KW + (KW - 1 - kx)) * O * C
                            + static_cast<size_t>(o) * C;
        for (int c = 0; c < C; ++c)
          acc = fmaf(to_f32(__ldg(xp + c)), to_f32(__ldg(wp + c)), acc);
      } else {
        const T* wp = w + (static_cast<size_t>(ky) * KW + kx) * C * O + o;
        for (int c = 0; c < C; ++c)
          acc = fmaf(to_f32(__ldg(xp + c)),
                     to_f32(__ldg(wp + static_cast<size_t>(c) * O)), acc);
      }
    }
  }
  y[idx] = from_f32<T>(acc);
}

template <typename T>
void launch(const void* x, const void* w, void* y, int N, int H, int W, int C,
            int O, int KH, int KW, int OH, int OW, int stride, int pt, int pl,
            int dil, int flip, cudaStream_t s) {
  const size_t total = static_cast<size_t>(N) * OH * OW * O;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  conv_direct_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      N, H, W, C, O, KH, KW, OH, OW, stride, pt, pl, dil, flip);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int conv_direct_launch(const void* x, const void* w, void* y, int N,
                                  int H, int W, int C, int O, int KH, int KW,
                                  int OH, int OW, int stride, int pt, int pl,
                                  int dil, int flip, int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      OH < 1 || OW < 1 || stride < 1 || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      launch<float>(x, w, y, N, H, W, C, O, KH, KW, OH, OW, stride, pt, pl,
                    dil, flip, s);
      break;
    case kDtypeBF16:
      launch<__nv_bfloat16>(x, w, y, N, H, W, C, O, KH, KW, OH, OW, stride,
                            pt, pl, dil, flip, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
