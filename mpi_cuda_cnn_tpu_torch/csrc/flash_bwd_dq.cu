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
// causal halves them): the bf16 path on the tensor cores, the float32 path
// on the FMA pipe (TF32 off: 67 TFLOP/s).
//
// Both paths: grid (B * H, S / 64), the heaviest causal q tiles first;
// causal tiles above the diagonal are skipped, masked logits on the
// diagonal are NEG_INF so p is exactly 0; ds is rounded to the input type
// before the ds k product (the TPU kernel's ds.astype); GQA reads kv head
// h / (H / Hkv) in place; dq is rounded once at the store.
//
// bf16 (`flash_bwd_dq_bf16_kernel`, FlashAttention-2's dq pass): 4 warps,
// each owning 16 query rows. The q and dO tiles come in once by
// `cp.async` and, for D <= 64, are `ldmatrix`'d into A fragments that
// stay in registers (at D 128 they are re-read per k tile, to keep the
// registers under the spill line); the lane's lse and dvec (rows g and
// g + 8) stay in registers. The k/v tiles are double-buffered by
// `cp.async`, as flash_fwd.cu's. Per k tile: s = q k^T and dp = dO v^T on
// `mma.sync` (k and v as the col-major B through plain `ldmatrix`); p and
// ds in float32 on the accumulator fragments, in the plain version's order
// of operations; ds packed to bf16 as the A fragments of key chunk j from
// n-tiles 2j and 2j + 1 (mma.cuh); dq += ds k with k as a row-major B
// through `ldmatrix.trans`. Nothing of p or ds goes to shared memory.
//
// float32 (`flash_bwd_dq_kernel`, FMA only): 256 threads, 4 x 4 logits a
// thread (flash_common.cuh); q and dO staged once, k and v per tile, ds
// through shared memory.

#include <type_traits>

#include "flash_common.cuh"
#include "mma.cuh"

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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             __nv_bfloat16* __restrict__ dq, int S, int H,
                             int Hkv, int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;  // row stride, 16 bytes of padding
  constexpr int kTileElems = kTile * kLd;
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  constexpr int kKc = D / 16;     // k-chunks of the q k^T product
  constexpr bool kHold = D <= 64;  // q/dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (64, kLd)
  bf16* do_s = q_s + kTileElems;                  // (64, kLd)
  bf16* k_s = do_s + kTileElems;                  // 2 x (64, kLd)
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

  const size_t q_off = ((static_cast<size_t>(b) * S + q0) * H + h) * D;
  for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    mma::cp_async16(q_s + r * kLd + c, q + q_off + r * q_rs + c, true);
    mma::cp_async16(do_s + r * kLd + c, dout + q_off + r * q_rs + c, true);
  }
  auto load_kv = [&](int kt, int st) {
    const size_t off =
        ((static_cast<size_t>(b) * S + kt * kTile) * Hkv + kvh) * D;
    for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      mma::cp_async16(k_s + st * kTileElems + r * kLd + c,
                      k + off + r * kv_rs + c, true);
      mma::cp_async16(v_s + st * kTileElems + r * kLd + c,
                      v + off + r * kv_rs + c, true);
    }
  };
  load_kv(0, 0);
  mma::cp_async_commit();

  // This lane's rows of the warp's 16: g and g + 8 (half 0 and 1).
  const int g = lane >> 2, t4 = lane & 3;
  float lse_r[2], dvec_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = static_cast<size_t>(bh) * S + q0 + 16 * warp + g + 8 * half;
    lse_r[half] = lse[row];
    dvec_r[half] = dvec[row];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[kHold ? kKc : 1][4], dof[kHold ? kKc : 1][4];
  // A fragment of k-chunk kc of this warp's 16 rows of a (64, kLd) tile.
  auto frag_a = [&](uint32_t(&r)[4], const bf16* tile, int kc) {
    mma::ldmatrix_x4(r, tile + (16 * warp + (lane & 15)) * kLd + kc * 16 +
                            (lane >> 4) * 8);
  };

  const int nk = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; stage (kt+1)&1 is free again
    if constexpr (kHold) {
      if (kt == 0) {
#pragma unroll
        for (int kc = 0; kc < kKc; ++kc) {
          frag_a(qf[kc], q_s, kc);
          frag_a(dof[kc], do_s, kc);
        }
      }
    }
    if (kt + 1 < nk) {
      load_kv(kt + 1, (kt + 1) & 1);
      mma::cp_async_commit();
    }
    const bf16* ks = k_s + (kt & 1) * kTileElems;
    const bf16* vs = v_s + (kt & 1) * kTileElems;

    // s = q k^T and dp = dO v^T: k's and v's rows [key][d] are the
    // col-major B operand as stored.
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc) {
      uint32_t aq[4], ag[4];
      if constexpr (kHold) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kc][e];
          ag[e] = dof[kc][e];
        }
      } else {
        frag_a(aq, q_s, kc);
        frag_a(ag, do_s, kc);
      }
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        const int at = (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kc * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t bb[4];
        mma::ldmatrix_x4(bb, ks + at);
        mma::mma_bf16(s[2 * np], aq, bb[0], bb[1]);
        mma::mma_bf16(s[2 * np + 1], aq, bb[2], bb[3]);
        mma::ldmatrix_x4(bb, vs + at);
        mma::mma_bf16(dp[2 * np], ag, bb[0], bb[1]);
        mma::mma_bf16(dp[2 * np + 1], ag, bb[2], bb[3]);
      }
    }

    // p = exp(s * scale - lse), ds = p * (dp - dvec) * scale, into s.
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep =
              !diag || j * 8 + 2 * t4 + e <= 16 * warp + g + 8 * half;
          const int i = 2 * half + e;
          const float sv = keep ? s[j][i] * scale : kNegInf;
          const float p = expf(sv - lse_r[half]);
          s[j][i] = p * (dp[j][i] - dvec_r[half]) * scale;
        }

    // dq += ds k: ds's accumulator fragments, rounded to bf16, are the A
    // fragments of key chunk kc; k's rows [key][d] go through .trans.
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      const uint32_t a[4] = {mma::pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             mma::pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             mma::pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             mma::pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bb[4];
        mma::ldmatrix_x4_trans(bb, ks + (kc * 16 + (lane & 15)) * kLd + dn * 16 +
                                       (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dn], a, bb[0], bb[1]);
        mma::mma_bf16(acc[2 * dn + 1], a, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    bf16* out = dq + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t4) =
          mma::pack_bf16x2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// One launch of `kern` (float32 or bf16) on the wrapper's plan, which must
// be the kernel's own: grid (B * H, S / 64), its threads, its dynamic
// shared memory.
template <typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kern, int threads, size_t smem, const void* q,
                          const void* k, const void* v, const void* dout,
                          const void* lse, const void* dvec, void* dq, int B,
                          int S, int H, int Hkv, int D, int causal,
                          const Plan& plan, cudaStream_t stream) {
  if (!plan.is(B * H, S / kTile, threads, smem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(plan.grid_x, plan.grid_y), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), S, H, Hkv, causal, softmax_scale(D));
  return cudaGetLastError();
}

// float32: q, dO, k, v tiles as float32 and the ds tile; bf16: the q and
// dO tiles and two stages of k and v, as bf16.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dvec,
                   void* dq, int B, int S, int H, int Hkv, int causal,
                   const Plan& plan, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_kernel<float>(
        flash_bwd_dq_kernel<float, D>, kThreads,
        sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdp), q, k, v, dout,
        lse, dvec, dq, B, S, H, Hkv, D, causal, plan, stream);
  } else {
    return launch_kernel<__nv_bfloat16>(
        flash_bwd_dq_bf16_kernel<D>, kMmaThreads,
        sizeof(__nv_bfloat16) * 6 * kTile * (D + 8), q, k, v, dout, lse, dvec,
        dq, B, S, H, Hkv, D, causal, plan, stream);
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dvec,
                     void* dq, int B, int S, int H, int Hkv, int D,
                     int causal, const Plan& plan, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, causal,
                           plan, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, causal,
                           plan, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv,
                            causal, plan, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (B, S, H, D); k, v (B, S, Hkv, D); one type for all of them:
// dtype 0 = float32 (`flash_bwd_dq_kernel`), 1 = bfloat16
// (`flash_bwd_dq_bf16_kernel`). lse, dvec (B * H, S) float32. S a
// multiple of 64, H a multiple of Hkv, D in {32, 64, 128}. The plan
// (grid_x, grid_y, threads, smem) is the wrapper's `flash_bwd_plan`: grid
// (B * H, S / 64), 256 threads for float32 and 128 for bf16, and the
// kernel's dynamic shared memory; any other plan is refused. Returns
// cudaGetLastError().
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dvec,
                                   void* dq, int B, int S, int H, int Hkv,
                                   int D, int causal, int dtype, int grid_x,
                                   int grid_y, int threads, int smem,
                                   void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan{grid_x, grid_y, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kDtypeF32:
      err = launch_d<float>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, D,
                            causal, plan, s);
      break;
    case kDtypeBF16:
      err = launch_d<__nv_bfloat16>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv,
                                    D, causal, plan, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
