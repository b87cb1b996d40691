// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// with an online softmax, and the per-row logsumexp the backward rebuilds
// the probabilities from.
//
// Replaces the TPU kernel `_flash_kernel` / `_flash_forward` of
// mpi_cuda_cnn_tpu/ops/pallas_attention.py (pallas_call at :249). That
// kernel runs a (batch*head, q-block, k-block) grid whose k-block axis is
// sequential on the TPU, carrying (acc, m, l) across grid steps in VMEM,
// with 512-1024-row blocks. Hopper's blocks run in parallel and in no
// order, and a block has 227 KB of shared memory, so here one block owns
// one (batch*head, 64-row q tile) and walks the k/v tiles in a loop inside
// the block; the online-softmax state (m, l, acc) of each query row stays
// in the registers of the 16 threads that own the row, in float32.
//
// What bounds it: operations. Causal attention at the training shapes
// (S = 2048, D = 64) does 2 * 2 * S^2 * D / 2 flops per (batch, head)
// against 4 * S * D elements read and written: hundreds of flops a byte,
// far above the card's balance point. This first version computes in
// float32 FMA (no tensor cores, no TMA, no wgmma), so its bound is the
// float32 rate, 67 TFLOP/s; the next step is wgmma on bf16 tiles.
//
// The design, and what it keeps from the TPU kernel:
//   - grid (B * H, S / 64), the heaviest causal q tiles first; 256 threads;
//   - q, then each k and v tile, staged in shared memory as float32 (rows
//     padded by one float so 16 threads reading 16 keys at one d hit 16
//     banks); the 64 x 64 logit tile lives in registers, 4 x 4 a thread;
//   - causal tiles above the diagonal are skipped (the TPU kernel's
//     pl.when); on the diagonal tile masked logits are NEG_INF and their
//     probabilities exactly 0;
//   - p is rounded to the input type before the PV product (exact for
//     float32, bf16 for bf16 inputs), while l sums the unrounded p, as the
//     TPU kernel does;
//   - GQA: query head h reads kv head h / (H / Hkv) in place, no repeat;
//   - outputs: o in the input type, lse = m + log(max(l, 1e-30)) as a
//     plain (B * H, S) float32 array (the TPU's 8-wide replica is a Mosaic
//     layout detail).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDc = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // (64, D + 1)
  float* k_s = q_s + kTile * kLd;  // (64, D + 1)
  float* v_s = k_s + kTile * kLd;  // (64, D)
  float* p_s = v_s + kTile * D;    // (64, kLdp)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;

  load_tile<T, D>(q_s, kLd, q, b, q0, h, S, H);

  float m[kRows], l[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }

  const int nk = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, kLd, k, b, kt * kTile, kvh, S, Hkv);
    load_tile<T, D>(v_s, D, v, b, kt * kTile, kvh, S, Hkv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = q_s[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = k_s[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      bool keep[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        keep[j] = !diag || tx + 16 * j <= r;
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        p_s[r * kLdp + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDc; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[kRows], vv[kDc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = p_s[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < kDc; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDc; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
  T* obase = o + ((static_cast<size_t>(b) * S + q0) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDc; ++j)
      obase[r * row_stride + tx + 16 * j] = from_f32<T>(acc[i][j] / lc);
    if (tx == 0) lse[static_cast<size_t>(bh) * S + q0 + r] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int Hkv, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTile * (D + 1) + kTile * D + kTile * kLdp);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / kTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, Hkv, causal, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int H, int Hkv, int D,
                     int causal, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, S, H, Hkv, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, S, H, Hkv, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, S, H, Hkv, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k/v (B, S, Hkv, D), o (B, S, H, D), all contiguous and of
// one type: dtype 0 = float32, 1 = bfloat16. lse (B * H, S) float32.
// S a multiple of 64, H a multiple of Hkv, D in {32, 64, 128}.
// Returns cudaGetLastError().
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int H,
                                int Hkv, int D, int causal, int dtype,
                                void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(q, k, v, o, lse, B, S, H, Hkv, D, causal, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, Hkv, D, causal,
                                    s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
