// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// with an online softmax, and the per-row logsumexp the backward rebuilds
// the probabilities from.
//
// Replaces the TPU kernel `_flash_kernel` / `_flash_forward` of
// mpi_cuda_cnn_tpu/ops/pallas_attention.py (pallas_call at :249). That
// kernel runs a (batch*head, q-block, k-block) grid whose k-block axis is
// sequential on the TPU, carrying (acc, m, l) across grid steps in VMEM,
// with 512-1024-row blocks, and feeds bf16 q/k/v straight to the MXU with
// float32 accumulators (:221-225). Hopper's blocks run in parallel and in
// no order, and a block has 227 KB of shared memory, so here one block
// owns one (batch*head, 64-row q tile) and walks the k/v tiles in a loop
// inside the block, the online-softmax state (m, l, acc) of each query
// row in registers, in float32.
//
// What bounds it: operations. Causal attention at the training shapes
// (S = 2048, D = 64) does 2 * 2 * S^2 * D / 2 flops per (batch, head)
// against 4 * S * D elements read and written: hundreds of flops a byte,
// far above the card's balance point. So the bf16 path is built on the
// tensor cores and the float32 path on the FMA pipe (TF32 off: 67 TF/s).
//
// bf16 (`flash_fwd_bf16_kernel`, FlashAttention-2's forward): 4 warps, each
// owning 16 query rows, whose q fragments are loaded once with `ldmatrix`;
// k and v tiles of 64 keys stay bf16 in shared memory (rows padded by 16
// bytes, so `ldmatrix` is conflict-free), double-buffered with `cp.async`
// so tile j+1 loads while tile j is multiplied. S = q k^T and o += p v are
// `mma.sync` m16n8k16 with float32 accumulators (mma.cuh). The online
// softmax runs in float32 on the accumulator fragments: s * scale, the
// causal mask on the diagonal tile only, row max and sum over the 4 lanes
// of a quad, exp(s - m). p is rounded to bf16 in registers and used as the
// A operand of p v directly (the accumulator and A fragments coincide),
// v read through `ldmatrix.trans`; l sums the unrounded p.
//
// float32 (`flash_fwd_kernel`, FMA only): 256 threads, q and each k
// and v tile staged in shared memory (rows padded by one float so 16
// threads reading 16 keys at one d hit 16 banks); the 64 x 64 logit tile
// in registers, 4 x 4 a thread, p through shared memory.
//
// Both keep from the TPU kernel:
//   - grid (B * H, S / 64), the heaviest causal q tiles first;
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
#include "mma.cuh"

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


constexpr int kTcThreads = 128;  // 4 warps x 16 query rows

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int Hkv,
                          int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;        // row stride, 16 bytes of padding
  constexpr int kTileElems = kTile * kLd;
  constexpr int kChunks = D / 8;    // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (64, kLd)
  bf16* k_s = q_s + kTileElems;                   // 2 x (64, kLd)
  bf16* v_s = k_s + 2 * kTileElems;               // 2 x (64, kLd)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const size_t q_rs = static_cast<size_t>(H) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;

  const bf16* qb = q + ((static_cast<size_t>(b) * S + q0) * H + h) * D;
  for (int e = tid; e < kTile * kChunks; e += kTcThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    mma::cp_async16(q_s + r * kLd + c, qb + r * q_rs + c, true);
  }
  auto load_kv = [&](int kt, int st) {
    const size_t off = ((static_cast<size_t>(b) * S + kt * kTile) * Hkv + kvh) * D;
    for (int e = tid; e < kTile * kChunks; e += kTcThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      mma::cp_async16(k_s + st * kTileElems + r * kLd + c, k + off + r * kv_rs + c,
                      true);
      mma::cp_async16(v_s + st * kTileElems + r * kLd + c, v + off + r * kv_rs + c,
                      true);
    }
  };
  load_kv(0, 0);
  mma::cp_async_commit();

  // This lane's rows of the warp's 16: g and g + 8 (half 0 and 1).
  const int g = lane >> 2, t4 = lane & 3;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[D / 16][4];

  const int nk = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; stage (kt+1)&1 is free again
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma::ldmatrix_x4(qf[kc], q_s + (16 * warp + (lane & 15)) * kLd +
                                     kc * 16 + (lane >> 4) * 8);
    }
    if (kt + 1 < nk) {
      load_kv(kt + 1, (kt + 1) & 1);
      mma::cp_async_commit();
    }
    const bf16* ks = k_s + (kt & 1) * kTileElems;
    const bf16* vs = v_s + (kt & 1) * kTileElems;

    // s = q k^T: k's rows [key][d] are the col-major B operand as stored.
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bb[4];
        mma::ldmatrix_x4(bb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                                 kc * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qf[kc], bb[0], bb[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kc], bb[2], bb[3]);
      }

    const bool diag = causal && kt == qt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;  // within the q tile
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep = !diag || j * 8 + 2 * t4 + e <= row;
          float& x = s[j][2 * half + e];
          x = keep ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float alpha = expf(m[half] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep = !diag || j * 8 + 2 * t4 + e <= row;
          float& x = s[j][2 * half + e];
          x = keep ? expf(x - m_new) : 0.f;
          psum += x;
        }
      psum += __shfl_xor_sync(kFull, psum, 1);
      psum += __shfl_xor_sync(kFull, psum, 2);
      l[half] = l[half] * alpha + psum;
      m[half] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * half] *= alpha;
        acc[j][2 * half + 1] *= alpha;
      }
    }

    // o += p v: p's accumulator fragments, rounded to bf16, are the A
    // fragments of key chunk kc; v's rows [key][d] go through .trans.
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      const uint32_t a[4] = {mma::pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             mma::pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             mma::pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             mma::pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        mma::ldmatrix_x4_trans(bb, vs + (kc * 16 + (lane & 15)) * kLd + dp * 16 +
                                       (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    const float lc = fmaxf(l[half], 1e-30f);
    bf16* orow = o + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t pair =
          mma::pack_bf16x2(acc[j][2 * half] / lc, acc[j][2 * half + 1] / lc);
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t4) = pair;
    }
    if (t4 == 0) lse[static_cast<size_t>(bh) * S + row] = m[half] + logf(lc);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int S, int H, int Hkv, int causal,
                        cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 5 * kTile * (D + 8);
  auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / kTile);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, H, Hkv, causal, softmax_scale(D));
  return cudaGetLastError();
}

cudaError_t launch_bf16_d(const void* q, const void* k, const void* v, void* o,
                          void* lse, int B, int S, int H, int Hkv, int D,
                          int causal, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_bf16<32>(q, k, v, o, lse, B, S, H, Hkv, causal, s);
    case 64:
      return launch_bf16<64>(q, k, v, o, lse, B, S, H, Hkv, causal, s);
    case 128:
      return launch_bf16<128>(q, k, v, o, lse, B, S, H, Hkv, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k/v (B, S, Hkv, D), o (B, S, H, D), all contiguous and of
// one type: dtype 0 = float32 (`flash_fwd_kernel`), 1 = bfloat16
// (`flash_fwd_bf16_kernel`). lse (B * H, S) float32.
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
      err = launch_bf16_d(q, k, v, o, lse, B, S, H, Hkv, D, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
