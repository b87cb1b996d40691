// Flash-attention backward, query gradient, for Hopper (sm_90a):
//   p  = exp(q k^T * scale - lse)          (rebuilt from the forward's lse)
//   ds = p * (dO v^T - dvec) * scale,      dvec = rowsum(dO * o)
//   dq = ds k
//
// Replaces the TPU kernel `_bwd_dq_kernel` of
// mpi_cuda_cnn_tpu/ops/pallas_attention.py (pallas_call at :434). There
// the (b*h, q-block, k-block) grid streams k-blocks sequentially and
// carries dq in VMEM scratch; here one block owns one (batch*head, 64-row
// q tile), walks the k/v tiles in a loop and keeps its dq rows in
// registers, in float32. dvec is computed outside, in float32, as the TPU
// path does.
//
// What bounds it: operations (three S^2 * D products per (batch, head),
// causal halves them), in float32 FMA at this stage: 67 TFLOP/s.
//
// Design: the layout of flash_fwd.cu (grid (B * H, S / 64), heaviest
// causal tiles first, 256 threads, 4 x 4 logits a thread): q and dO tiles
// staged once; per k tile, k and v staged, s = q k^T and dp = dO v^T in
// registers, ds written to shared memory rounded to the input type (the
// TPU kernel's ds.astype before the product), then dq += ds k. Causal
// tiles above the diagonal are skipped; masked logits are NEG_INF so p is
// exactly 0. GQA reads kv head h / (H / Hkv) in place.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, T* __restrict__ dq,
                        int S, int H, int Hkv, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDc = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                // (64, D + 1)
  float* do_s = q_s + kTile * kLd;  // (64, D + 1)
  float* k_s = do_s + kTile * kLd;  // (64, D + 1)
  float* v_s = k_s + kTile * kLd;   // (64, D + 1)
  float* ds_s = v_s + kTile * kLd;  // (64, kLdp)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;

  load_tile<T, D>(q_s, kLd, q, b, q0, h, S, H);
  load_tile<T, D>(do_s, kLd, dout, b, q0, h, S, H);
  float lse_r[kRows], dvec_r[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t row = static_cast<size_t>(bh) * S + q0 + ty + 16 * i;
    lse_r[i] = lse[row];
    dvec_r[i] = dvec[row];
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }

  const int nk = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, D>(k_s, kLd, k, b, kt * kTile, kvh, S, Hkv);
    load_tile<T, D>(v_s, kLd, v, b, kt * kTile, kvh, S, Hkv);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], g[kRows], kc[kCols], vc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = q_s[(ty + 16 * i) * kLd + d];
        g[i] = do_s[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kc[j] = k_s[(tx + 16 * j) * kLd + d];
        vc[j] = v_s[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }

    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float sv = (!diag || c <= r) ? s[i][j] * scale : kNegInf;
        const float p = expf(sv - lse_r[i]);
        const float ds = p * (dp[i][j] - dvec_r[i]) * scale;
        ds_s[r * kLdp + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[kRows], kv[kDc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = ds_s[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < kDc; ++j) kv[j] = k_s[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDc; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
  T* base = dq + ((static_cast<size_t>(b) * S + q0) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j)
      base[(ty + 16 * i) * row_stride + tx + 16 * j] = from_f32<T>(acc[i][j]);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dvec,
                   void* dq, int B, int S, int H, int Hkv, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdp);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / kTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), S, H, Hkv, causal, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dvec,
                     void* dq, int B, int S, int H, int Hkv, int D,
                     int causal, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, causal,
                           s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, causal,
                           s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv,
                            causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (B, S, H, D); k, v (B, S, Hkv, D); one type for all of them:
// dtype 0 = float32, 1 = bfloat16. lse, dvec (B * H, S) float32. S a
// multiple of 64, H a multiple of Hkv, D in {32, 64, 128}. Returns
// cudaGetLastError().
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dvec,
                                   void* dq, int B, int S, int H, int Hkv,
                                   int D, int causal, int dtype,
                                   void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, D,
                            causal, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv,
                                    D, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
