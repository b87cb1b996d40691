// int8-weight matmul for Hopper (sm_90a): y = (x @ q) * s with x (N, din)
// float32, q (din, dout) int8, s (1, dout) float32 per-output-channel
// scales, y (N, dout) float32. N is the decode batch (slots) at a decode
// tick and the chunk width at a prefill chunk.
//
// Replaces the TPU kernel `_gemv_kernel` / `_run_gemv` / `int8_gemv` of
// mpi_cuda_cnn_tpu/ops/pallas_gemv.py: the int8 weight is widened to
// float32 on load, products accumulate in float32, and the scale row
// multiplies the output once at the end (it is constant along the
// contracted din, so it never enters the sum).
//
// What bounds it: at the serving shapes (N = 8 or 32, din x dout up to
// 512 x 8192) the weight bytes dominate what must move, and at N = 32 the
// float32 multiply-adds (2*N*din*dout at the card's 67 TFLOP/s non-tensor
// rate) take longer than those bytes at 3.35 TB/s. Either way a launch
// moves at most a few megabytes, so at this model size it is launch-bound.
// The simple design: a block owns a tile of 128 output columns and up to 8
// rows of x; x is staged through shared memory 64 values of din at a time;
// each lane owns 4 adjacent columns and reads them as one 32-bit load of
// four int8 weights (a warp reads 128 consecutive bytes of a weight row);
// the 8 warps split din between them and their partial sums meet in shared
// memory at the end. Tensor cores (wgmma) and split-K for the narrow
// shapes, which leave most SMs idle here, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;  // output columns per block (4 per lane)
constexpr int kRows = 8;     // rows of x per block
constexpr int kDepth = 64;   // din values staged per step
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
int8_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, float* __restrict__ y, int N,
                 int din, int dout) {
  __shared__ float xs[kRows][kDepth];
  __shared__ float red[kWarps][kRows][kTileN];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kTileN + 4 * lane;
  const int row0 = blockIdx.y * kRows;
  const bool vec4 = (dout % 4 == 0) && (col0 + 3 < dout);

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;

  for (int k0 = 0; k0 < din; k0 += kDepth) {
    for (int e = threadIdx.x; e < kRows * kDepth; e += blockDim.x) {
      const int r = e / kDepth;
      const int kk = e - r * kDepth;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      xs[r][kk] = (gr < N && gk < din) ? x[static_cast<size_t>(gr) * din + gk] : 0.f;
    }
    __syncthreads();
    const int kend = min(kDepth, din - k0);
    for (int kk = warp; kk < kend; kk += kWarps) {
      const int8_t* qrow = q + static_cast<size_t>(k0 + kk) * dout;
      float w[4];
      if (vec4) {
        const char4 c = *reinterpret_cast<const char4*>(qrow + col0);
        w[0] = c.x;
        w[1] = c.y;
        w[2] = c.z;
        w[3] = c.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          w[t] = (col0 + t < dout) ? static_cast<float>(qrow[col0 + t]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[r][t] += xv * w[t];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) red[warp][r][4 * lane + t] = acc[r][t];
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kTileN; e += blockDim.x) {
    const int r = e / kTileN;
    const int c = e - r * kTileN;
    const int gr = row0 + r;
    const int gc = blockIdx.x * kTileN + c;
    if (gr < N && gc < dout) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][c];
      y[static_cast<size_t>(gr) * dout + gc] = sum * s[gc];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int int8_gemm_launch(const void* x, const void* q, const void* s,
                                void* y, int N, int din, int dout,
                                void* stream) {
  if (N < 1 || din < 1 || dout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((dout + kTileN - 1) / kTileN, (N + kRows - 1) / kRows);
  int8_gemm_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(y), N, din, dout);
  return static_cast<int>(cudaGetLastError());
}
