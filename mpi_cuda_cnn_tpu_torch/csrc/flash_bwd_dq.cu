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
// causal halves them), on the tensor cores in both types: bf16 at 989
// TFLOP/s; float32 as 3xTF32 (mma.cuh), three tf32 products at 495
// TFLOP/s, 165 effective (TF32 stays off everywhere else).
//
// Both paths (FlashAttention-2's dq pass): grid (B * H, S / 64), the
// heaviest causal q tiles first; 4 warps, each owning 16 query rows.
// Causal tiles above the diagonal are skipped, masked logits on the
// diagonal are NEG_INF so p is exactly 0; GQA reads kv head h / (H / Hkv)
// in place. The q and dO tiles come in once by `cp.async`, the k/v tiles
// per k tile (bf16 double-buffered, as flash_fwd.cu's; float32 in one
// stage, below); the lane's lse and dvec (rows g and g + 8) stay in
// registers. Per k tile: s = q k^T and
// dp = dO v^T on `mma.sync`; p and ds in float32 on the accumulator
// fragments, in the plain version's order of operations; dq += ds k with
// ds taken straight from the accumulators as the A operand. Nothing of p
// or ds goes to shared memory. dq is rounded once at the store.
//
// bf16 (`flash_bwd_dq_bf16_kernel`): m16n8k16. For D <= 64 the q/dO A
// fragments are `ldmatrix`'d once and stay in registers (at D 128 they are
// re-read per k tile, to keep the registers under the spill line); k and
// v are the col-major B through plain `ldmatrix`; ds is rounded to bf16
// (the TPU kernel's ds.astype) and packed as the A fragments of key chunk
// j from n-tiles 2j and 2j + 1 (mma.cuh); dq += ds k with k as a row-major
// B through `ldmatrix.trans`.
//
// float32 (`flash_bwd_dq_f32_kernel`): m16n8k8 tf32, 3xTF32, on the
// float32 tile pieces of flash_common.cuh: rows of D + 4 floats; q/dO (A)
// and k/v (B) of s and dp read as float2 with the d index permuted inside
// each k-chunk; ds split and permuted from its accumulators into the A
// operand of dq += ds k, k's rows read in the same permuted order (no ds
// round trip); every operand split into (hi, lo) as it is read. The
// splits, 480 a lane per k tile at D 64, are most of the kernel's
// instructions, hence mma.cuh's two-operation rounding, and the kernel
// lives on warps to switch between more than on overlap inside a block:
// k and v take one stage, not two, so shared memory is four tiles (70 KB
// at D 64) and three blocks fit on an SM beside their registers (168 a
// thread) where two did with six tiles; each block's load of the next
// tile waits behind a barrier while the others compute (on an H100 SXM
// at 700 W, at the LM flagship 1.22 -> 0.96 ms; at D 32, where the
// registers allow three blocks either way, 0.063 -> 0.068). Each tile's
// ds k product is summed from zero, 8 d-columns at once, and added to dq
// in float32, so no truncation bias of the tensor core's sums builds up
// over the row.
//
// With `out_f32` the bf16 kernel stores dq in float32, unrounded (the TPU
// wrapper's grads_f32, which the ring-flash backward of parallel/sp.py
// accumulates its hops in), a branch of the epilogue. Head dims:
// `with_head_dim`'s instances (flash_fwd.cu's notes on D 16 and on the
// zero padding hold here). Beyond D 128 (D 256), where the (16, D) float32
// dq takes 128 registers, both types stream k and v in tiles of 32 keys
// (kStreamRowsDq, flash_common.cuh: a k tile meets the causal diagonal in
// two halves, masked key by key), which also keeps float32's four tiles
// within 227 KB (192 rows, 199,680 bytes at D 256), and float32 sums ds k
// 4 column tiles at a time.

#include <type_traits>

#include "flash_common.cuh"
#include "mma.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            float* __restrict__ dq, int S, int H, int Hkv,
                            int causal, float scale, int /*out_f32*/) {
  constexpr int kLd = kLdF32<D>;  // D + 4: row stride in floats
  constexpr int kN = kStreamRowsDq<D>;  // keys of a k/v tile
  constexpr int kTileElems = kTile * kLd;
  constexpr int kChunks = D / 4;  // 16-byte copies per row
  constexpr int kKc = D / 8;      // k-chunks of the q k^T product
  // Column tiles of ds k summed at once (fewer beyond D 128, where the
  // (16, D) dq takes 128 registers).
  constexpr int kGroup = D > 128 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (64, kLd)
  float* do_s = q_s + kTileElems;                   // (64, kLd)
  float* k_s = do_s + kTileElems;                   // (kN, kLd)
  float* v_s = k_s + kN * kLd;                      // (kN, kLd)

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
    const int r = e / kChunks, c = (e - r * kChunks) * 4;
    mma::cp_async16(q_s + r * kLd + c, q + q_off + r * q_rs + c, true);
    mma::cp_async16(do_s + r * kLd + c, dout + q_off + r * q_rs + c, true);
  }
  auto load_kv = [&](int kt) {
    const size_t off =
        ((static_cast<size_t>(b) * S + kt * kN) * Hkv + kvh) * D;
    for (int e = tid; e < kN * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 4;
      mma::cp_async16(k_s + r * kLd + c, k + off + r * kv_rs + c, true);
      mma::cp_async16(v_s + r * kLd + c, v + off + r * kv_rs + c, true);
    }
  };
  load_kv(0);
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
  // This warp's 16 rows of the q and dO tiles at column 2t (frag_a_tf32).
  const float* qa = q_s + (16 * warp + g) * kLd + 2 * t4;
  const float* ga = do_s + (16 * warp + g) * kLd + 2 * t4;

  const int nk = causal ? (q0 + kTile) / kN : S / kN;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt > 0) {
      __syncthreads();  // every warp is done with tile kt - 1
      load_kv(kt);
      mma::cp_async_commit();
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed
    const float* ks = k_s;
    const float* vs = v_s;

    // s = q k^T and dp = dO v^T: k's and v's rows [key][d] are the
    // col-major B (key 8j + g; d 2t and 2t + 1 of chunk kc, flash_common.cuh).
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // In chains of kFirstChain k-chunks (flash_common.cuh).
#pragma unroll
    for (int c0 = 0; c0 < kKc; c0 += kFirstChain) {
      float ps[kN / 8][4], pd[kN / 8][4];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[j][e] = pd[j][e] = 0.f;
#pragma unroll
      for (int kc = c0; kc < c0 + kFirstChain && kc < kKc; ++kc) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        frag_a_tf32<kLd>(qh, ql, qa + kc * 8);
        frag_a_tf32<kLd>(gh, gl, ga + kc * 8);
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int at = (8 * j + g) * kLd + kc * 8 + 2 * t4;
          uint32_t bh[2], bl[2];
          frag_b_tf32(bh, bl, ks + at);
          mma::mma_tf32x3(ps[j], qh, ql, bh, bl);
          frag_b_tf32(bh, bl, vs + at);
          mma::mma_tf32x3(pd[j], gh, gl, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += ps[j][e], dp[j][e] += pd[j][e];
    }

    // p = exp(s * scale - lse), ds = p * (dp - dvec) * scale, into s.
    // (flash_fwd.cu's mask: a k tile past the q tile's first row meets
    // the diagonal; koff is its first key relative to the q tile.)
    const bool diag = causal && (kt + 1) * kN > q0;
    const int koff = kt * kN - q0;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep = !diag || koff + j * 8 + 2 * t4 + e <=
                                         16 * warp + g + 8 * half;
          const int i = 2 * half + e;
          const float sv = keep ? s[j][i] * scale : kNegInf;
          const float p = expf(sv - lse_r[half]);
          s[j][i] = p * (dp[j][i] - dvec_r[half]) * scale;
        }

    // dq += ds k: ds's accumulators of key n-tile j, split and permuted,
    // are the A fragment of key chunk j; k's rows [key][d] are the
    // row-major B with its rows in the same order (flash_common.cuh).
    permuted_product_tf32x3<kN / 8, D / 8, kLd, kGroup>(
        acc, s, ks + 2 * t4 * kLd + g);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    float* out = dq + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + j * 8 + 2 * t4) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             void* __restrict__ dq, int S, int H, int Hkv,
                             int causal, float scale, int out_f32) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;  // row stride, 16 bytes of padding
  constexpr int kN = kStreamRowsDq<D>;  // keys of a k/v tile
  constexpr int kTileElems = kTile * kLd;
  constexpr int kKvElems = kN * kLd;
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  constexpr int kKc = D / 16;     // k-chunks of the q k^T product
  constexpr bool kHold = D <= 64;  // q/dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (64, kLd)
  bf16* do_s = q_s + kTileElems;                  // (64, kLd)
  bf16* k_s = do_s + kTileElems;                  // 2 x (kN, kLd)
  bf16* v_s = k_s + 2 * kKvElems;                 // 2 x (kN, kLd)

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
        ((static_cast<size_t>(b) * S + kt * kN) * Hkv + kvh) * D;
    for (int e = tid; e < kN * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      mma::cp_async16(k_s + st * kKvElems + r * kLd + c,
                      k + off + r * kv_rs + c, true);
      mma::cp_async16(v_s + st * kKvElems + r * kLd + c,
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

  const int nk = causal ? (q0 + kTile) / kN : S / kN;
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
    const bf16* ks = k_s + (kt & 1) * kKvElems;
    const bf16* vs = v_s + (kt & 1) * kKvElems;

    // s = q k^T and dp = dO v^T: k's and v's rows [key][d] are the
    // col-major B operand as stored.
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
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
      for (int np = 0; np < kN / 16; ++np) {
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
    // (flash_fwd.cu's mask: a k tile past the q tile's first row meets
    // the diagonal; koff is its first key relative to the q tile.)
    const bool diag = causal && (kt + 1) * kN > q0;
    const int koff = kt * kN - q0;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep = !diag || koff + j * 8 + 2 * t4 + e <=
                                         16 * warp + g + 8 * half;
          const int i = 2 * half + e;
          const float sv = keep ? s[j][i] * scale : kNegInf;
          const float p = expf(sv - lse_r[half]);
          s[j][i] = p * (dp[j][i] - dvec_r[half]) * scale;
        }

    // dq += ds k: ds's accumulator fragments, rounded to bf16, are the A
    // fragments of key chunk kc; k's rows [key][d] go through .trans.
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc) {
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
    const size_t at = ((static_cast<size_t>(b) * S + row) * H + h) * D;
    if (out_f32) {
      float* out = static_cast<float*>(dq) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + j * 8 + 2 * t4) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    } else {
      bf16* out = static_cast<bf16*>(dq) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t4) =
            mma::pack_bf16x2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// One launch of `kern` (float32 or bf16) on the wrapper's plan, which must
// be the kernel's own: grid (B * H, S / 64), 128 threads, its dynamic
// shared memory.
template <typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kern, size_t smem, const void* q,
                          const void* k, const void* v, const void* dout,
                          const void* lse, const void* dvec, void* dq, int B,
                          int S, int H, int Hkv, int causal, float scale,
                          int out_f32, const Plan& plan, cudaStream_t stream) {
  if (!plan.is(B * H, S / kTile, kMmaThreads, smem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(plan.grid_x, plan.grid_y), kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), S, H, Hkv, causal, scale, out_f32);
  return cudaGetLastError();
}

// The q and dO tiles (64 rows), and k and v tiles of kStreamRowsDq<D> keys
// in two stages (bf16) or one (float32), rows padded by 16 bytes.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dvec,
                   void* dq, int B, int S, int H, int Hkv, int causal,
                   float scale, int out_f32, const Plan& plan,
                   cudaStream_t stream) {
  constexpr int kStages = std::is_same<T, float>::value ? 1 : 2;
  constexpr size_t smem = (2 * kTile + 2 * kStages * kStreamRowsDq<D>) *
                          (sizeof(T) * D + 16);
  if constexpr (std::is_same<T, float>::value) {
    return launch_kernel<float>(flash_bwd_dq_f32_kernel<D>, smem, q, k, v,
                                dout, lse, dvec, dq, B, S, H, Hkv, causal,
                                scale, out_f32, plan, stream);
  } else {
    return launch_kernel<__nv_bfloat16>(flash_bwd_dq_bf16_kernel<D>, smem, q,
                                        k, v, dout, lse, dvec, dq, B, S, H,
                                        Hkv, causal, scale, out_f32, plan,
                                        stream);
  }
}

// Head dims above 256 (flash_common.cuh's wide kernels): block (x, y)
// owns query tile y / (D / 64) of (batch, query head) x and dq's columns
// 64 (y % (D / 64)) .. + 63. Per k tile: s = q k^T and dp = dO v^T over
// the whole D (`wide_first`), p = exp(s scale - lse), ds = p (dp - dvec)
// scale rounded to T into xa (transposed) beside the chunk's k columns in
// xb, and dq += ds k from zero.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             void* __restrict__ dq, int S, int H, int Hkv,
                             int D, int causal, float scale, int out_f32) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideTile xa = reinterpret_cast<WideTile>(smem_raw);
  const WideTile xb = xa + kTile;
  const int nchunk = D / kWideCols;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int nq = S / kTile;
  const int qt = nq - 1 - static_cast<int>(blockIdx.y) / nchunk;
  const int c0 = (static_cast<int>(blockIdx.y) % nchunk) * kWideCols;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t qbase = (static_cast<size_t>(b) * S + q0) * qs + static_cast<size_t>(h) * D;
  float lr[4], dr[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = lse[static_cast<size_t>(bh) * S + q0 + 4 * ty + i];
    dr[i] = dvec[static_cast<size_t>(bh) * S + q0 + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int kt_end = causal ? qt : nq - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    const size_t kbase = (static_cast<size_t>(b) * S + k0) * ks + static_cast<size_t>(hk) * D;
    float sc[4][4], dp[4][4];
    wide_first(sc, q, qbase, qs, k, kbase, ks, D, xa, xb, ty, tx);
    wide_first(dp, dout, qbase, qs, v, kbase, ks, D, xa, xb, ty, tx);
    __syncthreads();  // dp's last chunk is read
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = causal && k0 + 4 * tx + j > q0 + 4 * ty + i;
        const float p = masked ? 0.f : expf(sc[i][j] * scale - lr[i]);
        xa[4 * tx + j][4 * ty + i] = round_to<T>(p * (dp[i][j] - dr[i]) * scale);
      }
    wide_load(xb, k, kbase + c0, ks, false);
    __syncthreads();
    float part[4][4];
    wide_product(part, xa, xb, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wide_store4<T>(dq, (static_cast<size_t>(b) * S + q0 + 4 * ty + i) * qs +
                           static_cast<size_t>(h) * D + c0 + 4 * tx,
                   out_f32 != 0 || std::is_same<T, float>::value, acc[i]);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dvec,
                     void* dq, int B, int S, int H, int Hkv, int D,
                     int causal, float scale, int out_f32, const Plan& plan,
                     cudaStream_t s) {
  if (wide_head_dim(D)) {  // grid (B * H, S / 64 * D / 64)
    if (!plan.is(B * H, S / kTile * (D / kWideCols), kWideThreads, kWideSmem))
      return cudaErrorInvalidValue;
    flash_bwd_dq_wide_kernel<T><<<dim3(plan.grid_x, plan.grid_y), kWideThreads,
                                  kWideSmem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dvec), dq, S,
        H, Hkv, D, causal, scale, out_f32);
    return cudaGetLastError();
  }
  return with_head_dim(D, [&](auto d) {
    return launch<T, decltype(d)::value>(q, k, v, dout, lse, dvec, dq, B, S,
                                         H, Hkv, causal, scale, out_f32,
                                         plan, s);
  });
}

}  // namespace

// q, dout, dq (B, S, H, D); k, v (B, S, Hkv, D); one type for all of them:
// dtype 0 = float32 (`flash_bwd_dq_f32_kernel`), 1 = bfloat16
// (`flash_bwd_dq_bf16_kernel`); grads_f32 1 makes dq float32 (for bf16
// inputs; float32 ones have a float32 dq either way). lse, dvec (B * H, S)
// float32. S a multiple of 64, H a multiple of Hkv, D one of
// `with_head_dim`'s instances (flash_common.cuh) or above 256 a multiple
// of 64 (`flash_bwd_dq_wide_kernel`: grid (B * H, S / 64 * D / 64), 256
// threads, kWideSmem bytes); `scale` multiplies the
// logits (the wrapper's 1 / sqrt of the head dim before its zero
// padding); every pointer 16-byte aligned. The plan (grid_x, grid_y, threads, smem) is the
// wrapper's `flash_bwd_plan`: grid (B * H, S / 64), 128 threads, and the
// kernel's dynamic shared memory; any other plan is refused. Returns
// cudaGetLastError().
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dvec,
                                   void* dq, int B, int S, int H, int Hkv,
                                   int D, int causal, float scale,
                                   int dtype, int grads_f32, int grid_x,
                                   int grid_y, int threads, int smem,
                                   void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0 ||
      (grads_f32 != 0 && grads_f32 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan{grid_x, grid_y, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kDtypeF32:
      err = launch_d<float>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, D,
                            causal, scale, grads_f32, plan, s);
      break;
    case kDtypeBF16:
      err = launch_d<__nv_bfloat16>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv,
                                    D, causal, scale, grads_f32, plan, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
