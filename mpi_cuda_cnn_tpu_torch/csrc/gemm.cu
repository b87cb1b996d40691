// GEMM for Hopper (sm_90a), float32 or bfloat16: C (M, N) = op(A) @ op(B)
// [+ bias], where op(A) is A (M, K) or, with ta, the transpose of a stored
// (K, M) matrix, and op(B) is B (K, N) or, with tb, the transpose of a
// stored (N, K) matrix. All row-major and contiguous, all of one element
// type (dtype 0 = float32, 1 = bfloat16); bias (N,) may be null.
//
// Replaces the TPU kernel `_matmul_kernel` / `_matmul` of
// mpi_cuda_cnn_tpu/ops/pallas_ops.py:59-90, the one contraction behind
// `dense_pallas` (:93-116): the FC forward x @ W and both halves of its
// backward, g @ W^T and x^T @ g. Here the transposes are read in place
// (ta/tb change only the load addressing), so the backward makes no
// transposed copy, and the ragged M, N and K edges are masked on load
// instead of padded to 128 (the Pallas pad is a TPU tiling artefact).
// Products accumulate in float32 FMA only, for either type: the TPU path
// accumulates in float32 (`preferred_element_type`) and TF32 tensor cores
// would break float32 parity. The result is rounded to the element type
// once; with a bias it is rounded, the bias added in float32, and rounded
// again, as the JAX package's `_matmul(x, w) + b` rounds the product to
// x.dtype before the add (both roundings are exact for float32).
//
// What bounds it: at reference_cnn's training shapes (batch 32; K up to
// 1,568, N up to 1,568) a call moves at most 1.3 MB and does at most
// 20 MFLOP, i.e. under 0.4 us at 3.35 TB/s and 67 TFLOP/s float32, so
// every call is bound by latency and launch, not by bytes or operations.
// The simple design: 32 x 32 output tiles, 256 threads each holding 2 x 2
// outputs, 32-deep K slices staged as float32 through padded shared memory
// (no bank conflicts on the transposing store). A tile grid that would
// leave most SMs idle while walking a long K (the forward of fc1, K =
// 1,568, only 7 tiles) is split over K into `splits` slices of `kchunk`:
// each slice writes its float32 partial tile to `work` (splits, M, N), and
// a second kernel sums the slices in a fixed order, so the result is the
// same run to run (no atomics). Tensor cores (wgmma) and TMA are later
// work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "elem.cuh"

namespace {

constexpr int kTile = 32;     // BM = BN
constexpr int kDepth = 32;    // BK
constexpr int kThreads = 256;

// The stored value of one output: the float32 sum rounded to T, plus the
// bias rounded again (see the header).
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, int gn) {
  if (bias == nullptr) return from_f32<T>(acc);
  return from_f32<T>(round_to<T>(acc) + to_f32(bias[gn]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ bias, T* __restrict__ C,
            float* __restrict__ work, int M, int N, int K, int ta, int tb,
            int kchunk) {
  __shared__ float As[kDepth][kTile + 1];  // As[k][m]
  __shared__ float Bs[kDepth][kTile + 1];  // Bs[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = kbeg; k0 < kend; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      int m, k;
      if (ta) {  // stored (K, M): neighbouring threads read neighbouring m
        k = e / kTile;
        m = e % kTile;
      } else {   // stored (M, K): neighbouring threads read neighbouring k
        m = e / kDepth;
        k = e % kDepth;
      }
      const int gm = m0 + m;
      const int gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < kend)
        v = to_f32(ta ? A[static_cast<size_t>(gk) * M + gm]
                      : A[static_cast<size_t>(gm) * K + gk]);
      As[k][m] = v;
    }
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      int n, k;
      if (tb) {  // stored (N, K)
        n = e / kDepth;
        k = e % kDepth;
      } else {   // stored (K, N)
        k = e / kTile;
        n = e % kTile;
      }
      const int gn = n0 + n;
      const int gk = k0 + k;
      float v = 0.f;
      if (gn < N && gk < kend)
        v = to_f32(tb ? B[static_cast<size_t>(gn) * K + gk]
                      : B[static_cast<size_t>(gk) * N + gn]);
      Bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float a0 = As[k][ty];
      const float a1 = As[k][ty + 16];
      const float b0 = Bs[k][tx];
      const float b1 = Bs[k][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gm = m0 + ty + 16 * i;
      const int gn = n0 + tx + 16 * j;
      if (gm >= M || gn >= N) continue;
      const size_t at = static_cast<size_t>(gm) * N + gn;
      if (work != nullptr)
        work[static_cast<size_t>(blockIdx.z) * M * N + at] = acc[i][j];
      else
        C[at] = epilogue(acc[i][j], bias, gn);
    }
  }
}

// Second pass of a split-K product: C = sum over the slices in slice
// order, then the epilogue.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_reduce_kernel(const float* __restrict__ work, const T* __restrict__ bias,
                   T* __restrict__ C, int M, int N, int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t at = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += work[static_cast<size_t>(z) * total + at];
  C[at] = epilogue(s, bias, static_cast<int>(at % N));
}

template <typename T>
void launch(const void* a, const void* b, const void* bias, void* c,
            void* work, int M, int N, int K, int ta, int tb, int kchunk,
            int splits, cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  float* partial = splits > 1 ? static_cast<float*>(work) : nullptr;
  gemm_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(c), partial, M, N, K, ta,
      tb, kchunk);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    gemm_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
        partial, static_cast<const T*>(bias), static_cast<T*>(c), M, N, splits);
  }
}

}  // namespace

// One product, split over K into `splits` slices of `kchunk` (a multiple
// of 32). splits == 1 writes C directly and needs no `work`; splits > 1
// needs `work` of splits * M * N float32 values (whatever the element
// type) and launches the reduction too. Returns cudaGetLastError() after
// the launches.
extern "C" int gemm_launch(const void* a, const void* b, const void* bias,
                           void* c, void* work, int M, int N, int K, int ta,
                           int tb, int kchunk, int splits, int dtype,
                           void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || kchunk < 1 ||
      kchunk % kDepth != 0 || static_cast<long long>(kchunk) * splits < K ||
      (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      launch<float>(a, b, bias, c, work, M, N, K, ta, tb, kchunk, splits, s);
      break;
    case kDtypeBF16:
      launch<__nv_bfloat16>(a, b, bias, c, work, M, N, K, ta, tb, kchunk,
                            splits, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
