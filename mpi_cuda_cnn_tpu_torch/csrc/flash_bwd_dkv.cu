// Flash-attention backward, key and value gradients, for Hopper (sm_90a):
//   p^T  = exp(k q^T * scale - lse)        (rebuilt from the forward's lse)
//   dv   = sum over query heads of the group of  p^T dO
//   ds^T = p^T * (v dO^T - dvec) * scale,  dk = sum over the group of ds^T q
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of
// mpi_cuda_cnn_tpu/ops/pallas_attention.py (pallas_call at :460). That
// kernel streams q-blocks sequentially over a grid that stays per QUERY
// head, writes (B * H, S, D) partial dk/dv, and under GQA sums each kv
// group's partials afterwards (:479-493). Here one block owns one
// (batch*kv head, 64-key tile): it loops over the group's H / Hkv query
// heads itself, in a fixed order, and over their q tiles, keeping dk and
// dv in registers in float32. That is deterministic, needs no atomics and
// no (B * H, S, D) scratch, and writes each gradient once in the input
// type.
//
// What bounds it: operations (four S^2 * D products per (batch, query
// head), causal halves them), in float32 FMA at this stage: 67 TFLOP/s.
//
// Design: k and v tiles staged once; per (query head, q tile) the q and
// dO tiles and their lse and dvec are staged, the transposed logits
// s^T = k q^T and dp^T = v dO^T are formed 4 x 4 a thread (rows = this
// block's keys), p^T and ds^T are written to shared memory rounded to the
// input type (the TPU kernel's astype before each product), then
// dv += p^T dO and dk += ds^T q. Causal: q tiles before this key tile are
// skipped; on the diagonal tile masked logits are NEG_INF, p exactly 0.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int Hkv,
                         int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDc = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                   // (64, D + 1)
  float* v_s = k_s + kTile * kLd;      // (64, D + 1)
  float* q_s = v_s + kTile * kLd;      // (64, D + 1)
  float* do_s = q_s + kTile * kLd;     // (64, D + 1)
  float* p_s = do_s + kTile * kLd;     // (64 keys, kLdp)
  float* ds_s = p_s + kTile * kLdp;    // (64 keys, kLdp)
  float* lse_s = ds_s + kTile * kLdp;  // (64,)
  float* dvec_s = lse_s + kTile;       // (64,)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int group = H / Hkv;
  const int kt = blockIdx.y;  // causal: the low key tiles see the most queries
  const int k0 = kt * kTile;
  const int nq = S / kTile;

  load_tile<T, D>(k_s, kLd, k, b, k0, kvh, S, Hkv);
  load_tile<T, D>(v_s, kLd, v, b, k0, kvh, S, Hkv);

  float dk_acc[kRows][kDc], dv_acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(q_s, kLd, q, b, q0, h, S, H);
      load_tile<T, D>(do_s, kLd, dout, b, q0, h, S, H);
      if (threadIdx.x < kTile) {
        lse_s[threadIdx.x] = lse[lrow + q0 + threadIdx.x];
        dvec_s[threadIdx.x] = dvec[lrow + q0 + threadIdx.x];
      }
      __syncthreads();

      float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[kRows], vr[kRows], qc[kCols], gc[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kr[i] = k_s[(ty + 16 * i) * kLd + d];
          vr[i] = v_s[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qc[j] = q_s[(tx + 16 * j) * kLd + d];
          gc[j] = do_s[(tx + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            st[i][j] = fmaf(kr[i], qc[j], st[i][j]);
            dpt[i][j] = fmaf(vr[i], gc[j], dpt[i][j]);
          }
      }

      const bool diag = causal && qt == kt;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int key = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j;  // query row of the tile
          const float sv = (!diag || key <= col) ? st[i][j] * scale : kNegInf;
          const float p = expf(sv - lse_s[col]);
          const float ds = p * (dpt[i][j] - dvec_s[col]) * scale;
          p_s[key * kLdp + col] = round_to<T>(p);
          ds_s[key * kLdp + col] = round_to<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[kRows], dsv[kRows], gd[kDc], qd[kDc];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = p_s[(ty + 16 * i) * kLdp + r];
          dsv[i] = ds_s[(ty + 16 * i) * kLdp + r];
        }
#pragma unroll
        for (int j = 0; j < kDc; ++j) {
          gd[j] = do_s[r * kLd + tx + 16 * j];
          qd[j] = q_s[r * kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kDc; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gd[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qd[j], dk_acc[i][j]);
          }
      }
    }
  }

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const size_t off = ((static_cast<size_t>(b) * S + k0) * Hkv + kvh) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      const size_t e = off + (ty + 16 * i) * row_stride + tx + 16 * j;
      dk[e] = from_f32<T>(dk_acc[i][j]);
      dv[e] = from_f32<T>(dv_acc[i][j]);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dvec,
                   void* dk, void* dv, int B, int S, int H, int Hkv,
                   int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      (4 * kTile * (D + 1) + 2 * kTile * kLdp + 2 * kTile);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hkv, S / kTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, causal,
      softmax_scale(D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dvec,
                     void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                     int causal, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, dvec, dk, dv, B, S, H, Hkv,
                           causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, dvec, dk, dv, B, S, H, Hkv,
                           causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, dvec, dk, dv, B, S, H, Hkv,
                            causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout (B, S, H, D); k, v, dk, dv (B, S, Hkv, D); one type for all of
// them: dtype 0 = float32, 1 = bfloat16. lse, dvec (B * H, S) float32. S a
// multiple of 64, H a multiple of Hkv, D in {32, 64, 128}. Returns
// cudaGetLastError().
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dvec,
                                    void* dk, void* dv, int B, int S, int H,
                                    int Hkv, int D, int causal, int dtype,
                                    void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(q, k, v, dout, lse, dvec, dk, dv, B, S, H, Hkv, D,
                            causal, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(q, k, v, dout, lse, dvec, dk, dv, B, S, H,
                                    Hkv, D, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
