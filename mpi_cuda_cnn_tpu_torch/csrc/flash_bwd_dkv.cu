// Flash-attention backward, key and value gradients, for Hopper (sm_90a):
//   p^T  = exp(k q^T * scale - lse)        (rebuilt from the forward's lse)
//   dv   = sum over query heads of the group of  p^T dO
//   ds^T = p^T * (v dO^T - dvec) * scale,  dk = sum over the group of ds^T q
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of
// mpi_cuda_cnn_tpu/ops/pallas_attention.py (pallas_call at :460). That
// kernel streams q-blocks sequentially over a grid that stays per QUERY
// head, writes (B * H, S, D) partial dk/dv, and under GQA sums each kv
// group's partials afterwards (:479-493).
//
// What bounds it: operations (four S^2 * D products per (batch, query
// head), causal halves them), on the tensor cores in both types: bf16 at
// 989 TFLOP/s; float32 as 3xTF32 (mma.cuh), three tf32 products at 495
// TFLOP/s, 165 effective (TF32 stays off everywhere else).
//
// Both paths (FlashAttention-2's dk/dv pass): one block owns 64 keys of
// ONE query head, grid (B * H, S / 64) with the heaviest causal key tiles
// (the lowest) first, so GQA has as many blocks as MHA. 4 warps own 16
// keys each. q/dO tiles and their 64 lse/dvec values are double-buffered
// by `cp.async`. Per q tile: s^T = k q^T and dp^T = v dO^T on `mma.sync`
// (q and dO as the col-major B); p^T and ds^T in float32 on the
// accumulator fragments, the lane's query columns 2t, 2t + 1 reading
// lse/dvec from shared memory; dv += p^T dO and dk += ds^T q with p^T and
// ds^T taken straight from the accumulators as the A operands. Nothing of
// p or ds goes to shared memory. Causal q tiles before a key tile are
// skipped; on the diagonal tile masked logits are NEG_INF and p exactly 0.
// dk and dv accumulate in float32 and are rounded once. Under MHA
// (H == Hkv) the block writes dk/dv. Under GQA it writes float32 partials
// to a (2, G, B, S, Hkv, D) scratch, G = H / Hkv, and a second kernel of
// the same launch function (`flash_bwd_dkv_group_sum_kernel<T>`) sums the
// G slices in the fixed order g = 0..G-1 and stores once: the reference's
// partials-then-group-sum, deterministic, no atomics.
//
// bf16 (`flash_bwd_dkv_bf16_kernel`): m16n8k16. The k and v tiles are
// `ldmatrix`'d into A fragments once (for D <= 64; at D 128 they are
// re-read from shared memory and each q tile is taken as two halves of 32
// queries, to stay under the spill line); q and dO go through plain
// `ldmatrix` as the col-major B and through `ldmatrix.trans` as the
// row-major B; p^T and ds^T are rounded to bf16 (the TPU kernel's astype)
// and packed as A fragments (mma.cuh's n-tile 2j/2j+1 -> k-chunk j map).
//
// float32 (`flash_bwd_dkv_f32_kernel`): m16n8k8 tf32, 3xTF32, with
// flash_bwd_dq.cu's float32 design (flash_common.cuh): k/v (A) and q/dO
// (B) of s^T and dp^T read as float2 with d permuted; p^T and ds^T split
// and permuted from their accumulators into the A operands of dv += p^T
// dO and dk += ds^T q, dO's and q's rows read in the same order; each q
// tile's products summed from zero, 4 d-columns at once (235 registers at
// D 64; a trial with 8 and 32-query halves spilled), and added to dv and
// dk in float32.
// At D 128 a q tile is taken as two halves of 32 queries, as in bf16.
//
// With `out_f32` the bf16 path stores dk and dv in float32, unrounded (the
// TPU wrapper's grads_f32, which the ring-flash backward of parallel/sp.py
// accumulates its hops in): a branch of the MHA epilogue, and the group
// sum's float instance under GQA. Head dims: `with_head_dim`'s instances
// (flash_fwd.cu's notes on D 16 and on the zero padding hold here).
// Beyond D 128 (D 256) two (16, D) float32 accumulators would take 256
// registers a thread: each (batch, query head, key tile) is taken by two
// blocks (grid y S / 64 * 2, kDkvSplit), each rebuilding p^T and ds^T over
// the full D and keeping dk and dv for its half of the columns (the
// first products done twice: 1.5x the operations of one block); float32
// streams q and dO in tiles of 16 queries there, so that its tiles fit in
// 227 KB (192 rows, 199,936 bytes at D 256), masked query by query where
// they meet the causal diagonal.

#include <type_traits>

#include "flash_common.cuh"
#include "mma.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ part, int S, int H, int Hkv,
                             int causal, float scale, int /*out_f32*/) {
  constexpr int kLd = kLdF32<D>;  // D + 4: row stride in floats
  constexpr int kN = kStreamRowsF32Dkv<D>;  // queries of a q/dO tile
  constexpr int kTileElems = kTile * kLd;
  constexpr int kQElems = kN * kLd;
  constexpr int kChunks = D / 4;  // 16-byte copies per row
  constexpr int kKc = D / 8;      // k-chunks of the k q^T product
  // Query sub-tiles a q tile is taken in: two of 32 at D in (64, 128], so
  // the logit fragments and their (hi, lo) split fit in the registers
  // beside the (16, D) dk and dv accumulators (beyond D 128 the tile is
  // 16 queries and the block's dk and dv are D / 2 columns wide).
  constexpr int kSplit = D > 64 && D <= 128 ? 2 : 1;
  constexpr int kQn = kN / kSplit;
  constexpr int kDo = D / kDkvSplit<D>;  // output columns of this block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // (64, kLd)
  float* v_s = k_s + kTileElems;                    // (64, kLd)
  float* q_s = v_s + kTileElems;                    // 2 x (kN, kLd)
  float* do_s = q_s + 2 * kQElems;                  // 2 x (kN, kLd)
  float* lse_s = do_s + 2 * kQElems;                // 2 x kN
  float* dvec_s = lse_s + 2 * kN;                   // 2 x kN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int group = H / Hkv;
  const int kvh = h / group;
  // causal: the low key tiles see the most queries; dh: the half of the
  // output columns beyond D 128
  const int kt = blockIdx.y / kDkvSplit<D>;
  const int dh = blockIdx.y - kt * kDkvSplit<D>;
  const int k0 = kt * kTile;
  const size_t q_rs = static_cast<size_t>(H) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;

  const size_t kv_off = ((static_cast<size_t>(b) * S + k0) * Hkv + kvh) * D;
  for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 4;
    mma::cp_async16(k_s + r * kLd + c, k + kv_off + r * kv_rs + c, true);
    mma::cp_async16(v_s + r * kLd + c, v + kv_off + r * kv_rs + c, true);
  }
  auto load_q = [&](int qt, int st) {
    const size_t off = ((static_cast<size_t>(b) * S + qt * kN) * H + h) * D;
    for (int e = tid; e < kN * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 4;
      mma::cp_async16(q_s + st * kQElems + r * kLd + c,
                      q + off + r * q_rs + c, true);
      mma::cp_async16(do_s + st * kQElems + r * kLd + c,
                      dout + off + r * q_rs + c, true);
    }
    // kN floats each of lse and dvec: kN / 4 copies of 16 bytes each.
    if (tid < kN / 2) {
      const int c = tid % (kN / 4);
      const size_t row = static_cast<size_t>(bh) * S + qt * kN + c * 4;
      if (tid < kN / 4)
        mma::cp_async16(lse_s + st * kN + c * 4, lse + row, true);
      else
        mma::cp_async16(dvec_s + st * kN + c * 4, dvec + row, true);
    }
  };
  const int nq = S / kN;
  const int qt0 = causal ? k0 / kN : 0;
  load_q(qt0, 0);
  mma::cp_async_commit();

  // This lane's keys of the warp's 16: g and g + 8 (half 0 and 1).
  const int g = lane >> 2, t4 = lane & 3;
  float dk_acc[kDo / 8][4], dv_acc[kDo / 8][4];
#pragma unroll
  for (int j = 0; j < kDo / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  // This warp's 16 keys of the k and v tiles at column 2t (frag_a_tf32).
  const float* ka = k_s + (16 * warp + g) * kLd + 2 * t4;
  const float* va = v_s + (16 * warp + g) * kLd + 2 * t4;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile qt landed; stage st ^ 1 is free again
    if (qt + 1 < nq) {
      load_q(qt + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const float* qs = q_s + st * kQElems;
    const float* dos = do_s + st * kQElems;
    const float* ls = lse_s + st * kN;
    const float* dvs = dvec_s + st * kN;

#pragma unroll 1
    for (int qh = 0; qh < kSplit; ++qh) {
      const int qc0 = qh * kQn;  // the sub-tile's first query of the tile

      // s^T = k q^T and dp^T = v dO^T: q's and dO's rows [query][d] are
      // the col-major B (query qc0 + 8j + g; d 2t and 2t + 1 of chunk kc,
      // flash_common.cuh).
      float s[kQn / 8][4], dp[kQn / 8][4];
#pragma unroll
      for (int j = 0; j < kQn / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // In chains of kFirstChain k-chunks (flash_common.cuh).
#pragma unroll
      for (int c0 = 0; c0 < kKc; c0 += kFirstChain) {
        float ps[kQn / 8][4], pd[kQn / 8][4];
#pragma unroll
        for (int j = 0; j < kQn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[j][e] = pd[j][e] = 0.f;
#pragma unroll
        for (int kc = c0; kc < c0 + kFirstChain && kc < kKc; ++kc) {
          uint32_t kh[4], kl[4], vh[4], vl[4];
          frag_a_tf32<kLd>(kh, kl, ka + kc * 8);
          frag_a_tf32<kLd>(vh, vl, va + kc * 8);
#pragma unroll
          for (int j = 0; j < kQn / 8; ++j) {
            const int at = (qc0 + 8 * j + g) * kLd + kc * 8 + 2 * t4;
            uint32_t bh[2], bl[2];
            frag_b_tf32(bh, bl, qs + at);
            mma::mma_tf32x3(ps[j], kh, kl, bh, bl);
            frag_b_tf32(bh, bl, dos + at);
            mma::mma_tf32x3(pd[j], vh, vl, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < kQn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] += ps[j][e], dp[j][e] += pd[j][e];
      }

      // p^T = exp(s^T * scale - lse[query]) into s, ds^T into dp; the
      // lane's query columns are qc0 + j * 8 + 2 t4 + e.
      // A q tile that starts before the key tile's last key meets the
      // diagonal: its queries before a key are masked (qoff is the q
      // tile's first query relative to the key tile).
      const bool diag = causal && qt * kN < k0 + kTile;
      const int qoff = qt * kN - k0;
#pragma unroll
      for (int j = 0; j < kQn / 8; ++j) {
        const int col = qc0 + j * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dvs + col);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool keep =
                !diag || 16 * warp + g + 8 * half <= qoff + col + e;
            const int i = 2 * half + e;
            const float sv = keep ? s[j][i] * scale : kNegInf;
            const float p = expf(sv - (e ? l2.y : l2.x));
            s[j][i] = p;
            dp[j][i] = p * (dp[j][i] - (e ? d2.y : d2.x)) * scale;
          }
      }

      // dv += p^T dO, then dk += ds^T q: p^T's and ds^T's accumulators,
      // split and permuted, are the A fragments of query chunk j; dO's and
      // q's rows [query][d] the row-major B with its rows in the same order
      // (flash_common.cuh).
      const int at = (qc0 + 2 * t4) * kLd + g + dh * kDo;
      permuted_product_tf32x3<kQn / 8, kDo / 8, kLd, 4>(dv_acc, s, dos + at);
      permuted_product_tf32x3<kQn / 8, kDo / 8, kLd, 4>(dk_acc, dp, qs + at);
    }
  }

  // MHA: dk/dv as they are. GQA: partials into slice h % group of the
  // (2, group, B, S, Hkv, D) scratch, at the offset of the output element.
  const size_t n = static_cast<size_t>(gridDim.x / H) * S * Hkv * D;
  const int gi = h - kvh * group;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + 16 * warp + g + 8 * half;
    const size_t off = ((static_cast<size_t>(b) * S + key) * Hkv + kvh) * D;
#pragma unroll
    for (int j = 0; j < kDo / 8; ++j) {
      const size_t e = off + dh * kDo + j * 8 + 2 * t4;
      const float2 kk = make_float2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
      const float2 vv = make_float2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      if (part == nullptr) {
        *reinterpret_cast<float2*>(dk + e) = kk;
        *reinterpret_cast<float2*>(dv + e) = vv;
      } else {
        *reinterpret_cast<float2*>(part + gi * n + e) = kk;
        *reinterpret_cast<float2*>(part + (group + gi) * n + e) = vv;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dvec,
                              void* __restrict__ dk, void* __restrict__ dv,
                              float* __restrict__ part, int S, int H, int Hkv,
                              int causal, float scale, int out_f32) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;  // row stride, 16 bytes of padding
  constexpr int kTileElems = kTile * kLd;
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  constexpr int kKc = D / 16;     // k-chunks of the k q^T product
  constexpr bool kHold = D <= 64;  // k/v fragments held in registers
  // Query sub-tiles a q tile is taken in: two of 32 at D 128, so the
  // logit fragments beside the (16, 128) dk and dv accumulators fit in
  // the registers.
  constexpr int kSplit = D > 64 ? 2 : 1;
  constexpr int kQn = kTile / kSplit;
  constexpr int kDo = D / kDkvSplit<D>;  // output columns of this block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // (64, kLd)
  bf16* v_s = k_s + kTileElems;                   // (64, kLd)
  bf16* q_s = v_s + kTileElems;                   // 2 x (64, kLd)
  bf16* do_s = q_s + 2 * kTileElems;              // 2 x (64, kLd)
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // 2 x 64
  float* dvec_s = lse_s + 2 * kTile;                               // 2 x 64

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int group = H / Hkv;
  const int kvh = h / group;
  // causal: the low key tiles see the most queries; dh: the half of the
  // output columns beyond D 128
  const int kt = blockIdx.y / kDkvSplit<D>;
  const int dh = blockIdx.y - kt * kDkvSplit<D>;
  const int k0 = kt * kTile;
  const size_t q_rs = static_cast<size_t>(H) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;

  const size_t kv_off = ((static_cast<size_t>(b) * S + k0) * Hkv + kvh) * D;
  for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    mma::cp_async16(k_s + r * kLd + c, k + kv_off + r * kv_rs + c, true);
    mma::cp_async16(v_s + r * kLd + c, v + kv_off + r * kv_rs + c, true);
  }
  auto load_q = [&](int qt, int st) {
    const size_t off = ((static_cast<size_t>(b) * S + qt * kTile) * H + h) * D;
    for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      mma::cp_async16(q_s + st * kTileElems + r * kLd + c,
                      q + off + r * q_rs + c, true);
      mma::cp_async16(do_s + st * kTileElems + r * kLd + c,
                      dout + off + r * q_rs + c, true);
    }
    // 64 floats each of lse and dvec: 16 copies of 16 bytes each.
    if (tid < 32) {
      const size_t row = static_cast<size_t>(bh) * S + qt * kTile + (tid & 15) * 4;
      if (tid < 16)
        mma::cp_async16(lse_s + st * kTile + tid * 4, lse + row, true);
      else
        mma::cp_async16(dvec_s + st * kTile + (tid - 16) * 4, dvec + row, true);
    }
  };
  const int nq = S / kTile;
  const int qt0 = causal ? kt : 0;
  load_q(qt0, 0);
  mma::cp_async_commit();

  // This lane's keys of the warp's 16: g and g + 8 (half 0 and 1).
  const int g = lane >> 2, t4 = lane & 3;
  float dk_acc[kDo / 8][4], dv_acc[kDo / 8][4];
#pragma unroll
  for (int j = 0; j < kDo / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  uint32_t kf[kHold ? kKc : 1][4], vf[kHold ? kKc : 1][4];
  // A fragment of k-chunk kc of this warp's 16 keys.
  auto frag_a = [&](uint32_t(&r)[4], const bf16* tile, int kc) {
    mma::ldmatrix_x4(r, tile + (16 * warp + (lane & 15)) * kLd + kc * 16 +
                            (lane >> 4) * 8);
  };

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // tile qt landed; stage st ^ 1 is free again
    if constexpr (kHold) {
      if (qt == qt0) {
#pragma unroll
        for (int kc = 0; kc < kKc; ++kc) {
          frag_a(kf[kc], k_s, kc);
          frag_a(vf[kc], v_s, kc);
        }
      }
    }
    if (qt + 1 < nq) {
      load_q(qt + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const bf16* qs = q_s + st * kTileElems;
    const bf16* dos = do_s + st * kTileElems;
    const float* ls = lse_s + st * kTile;
    const float* dvs = dvec_s + st * kTile;

#pragma unroll
    for (int qh = 0; qh < kSplit; ++qh) {
      const int qc0 = qh * kQn;  // the sub-tile's first query of the tile

      // s^T = k q^T and dp^T = v dO^T: q's and dO's rows [query][d] are
      // the col-major B operand as stored.
      float s[kQn / 8][4], dp[kQn / 8][4];
#pragma unroll
      for (int j = 0; j < kQn / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
        uint32_t ak[4], av[4];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kf[kc][e];
            av[e] = vf[kc][e];
          }
        } else {
          frag_a(ak, k_s, kc);
          frag_a(av, v_s, kc);
        }
#pragma unroll
        for (int np = 0; np < kQn / 16; ++np) {
          const int at = (qc0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                         kc * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bb[4];
          mma::ldmatrix_x4(bb, qs + at);
          mma::mma_bf16(s[2 * np], ak, bb[0], bb[1]);
          mma::mma_bf16(s[2 * np + 1], ak, bb[2], bb[3]);
          mma::ldmatrix_x4(bb, dos + at);
          mma::mma_bf16(dp[2 * np], av, bb[0], bb[1]);
          mma::mma_bf16(dp[2 * np + 1], av, bb[2], bb[3]);
        }
      }

      // p^T = exp(s^T * scale - lse[query]) into s, ds^T into dp; the
      // lane's query columns are qc0 + j * 8 + 2 t4 + e.
      // A q tile that starts before the key tile's last key meets the
      // diagonal: its queries before a key are masked (qoff is the q
      // tile's first query relative to the key tile).
      const bool diag = causal && qt * kTile < k0 + kTile;
      const int qoff = qt * kTile - k0;
#pragma unroll
      for (int j = 0; j < kQn / 8; ++j) {
        const int col = qc0 + j * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dvs + col);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool keep =
                !diag || 16 * warp + g + 8 * half <= qoff + col + e;
            const int i = 2 * half + e;
            const float sv = keep ? s[j][i] * scale : kNegInf;
            const float p = expf(sv - (e ? l2.y : l2.x));
            s[j][i] = p;
            dp[j][i] = p * (dp[j][i] - (e ? d2.y : d2.x)) * scale;
          }
      }

      // dv += p^T dO, dk += ds^T q: the accumulator fragments of query
      // n-tiles 2 kc and 2 kc + 1, rounded to bf16, are the A fragments of
      // query chunk kc; dO's and q's rows [query][d] go through .trans.
#pragma unroll
      for (int kc = 0; kc < kQn / 16; ++kc) {
        const uint32_t ap[4] = {
            mma::pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
            mma::pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
            mma::pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            mma::pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
        const uint32_t ad[4] = {
            mma::pack_bf16x2(dp[2 * kc][0], dp[2 * kc][1]),
            mma::pack_bf16x2(dp[2 * kc][2], dp[2 * kc][3]),
            mma::pack_bf16x2(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
            mma::pack_bf16x2(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
        for (int dn = 0; dn < kDo / 16; ++dn) {
          const int at = (qc0 + kc * 16 + (lane & 15)) * kLd + dh * kDo +
                         dn * 16 + (lane >> 4) * 8;
          uint32_t bb[4];
          mma::ldmatrix_x4_trans(bb, dos + at);
          mma::mma_bf16(dv_acc[2 * dn], ap, bb[0], bb[1]);
          mma::mma_bf16(dv_acc[2 * dn + 1], ap, bb[2], bb[3]);
          mma::ldmatrix_x4_trans(bb, qs + at);
          mma::mma_bf16(dk_acc[2 * dn], ad, bb[0], bb[1]);
          mma::mma_bf16(dk_acc[2 * dn + 1], ad, bb[2], bb[3]);
        }
      }
    }
  }

  // MHA: dk/dv in bf16. GQA: float32 partials into slice h % group of the
  // (2, group, B, S, Hkv, D) scratch, at the offset of the output element.
  const size_t n = static_cast<size_t>(gridDim.x / H) * S * Hkv * D;
  const int gi = h - kvh * group;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + 16 * warp + g + 8 * half;
    const size_t off = ((static_cast<size_t>(b) * S + key) * Hkv + kvh) * D;
#pragma unroll
    for (int j = 0; j < kDo / 8; ++j) {
      const size_t e = off + dh * kDo + j * 8 + 2 * t4;
      if (part == nullptr && out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + e) =
            make_float2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + e) =
            make_float2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      } else if (part == nullptr) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dk) + e) =
            mma::pack_bf16x2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dv) + e) =
            mma::pack_bf16x2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      } else {
        *reinterpret_cast<float2*>(part + gi * n + e) =
            make_float2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
        *reinterpret_cast<float2*>(part + (group + gi) * n + e) =
            make_float2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      }
    }
  }
}

constexpr int kSumThreads = 256;
constexpr int kSumVec = 4;  // floats a thread sums per slice (one float4)

// Four summed floats stored as the output type: float32 as they are,
// bf16 rounded once.
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(mma::pack_bf16x2(v.x, v.y), mma::pack_bf16x2(v.z, v.w));
}

// dk and dv from the GQA scratch: element e of each is the sum of its
// group slices g = 0..G-1 in that order, in float32, stored once as T.
// Thread i takes 4 elements: dk's for i < n4, dv's after.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    flash_bwd_dkv_group_sum_kernel(const float* __restrict__ part,
                                   T* __restrict__ dk, T* __restrict__ dv,
                                   long long n4, int group) {
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4;  // 0 = dk, 1 = dv
  const long long e = i - which * n4;
  const float4* src = reinterpret_cast<const float4*>(part) + which * group * n4 + e;
  float4 acc = src[0];
  for (int g = 1; g < group; ++g) {
    const float4 x = src[g * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4((which ? dv : dk) + kSumVec * e, acc);
}

// The group sum into outputs of type TO.
template <typename TO>
cudaError_t group_sum(const void* part, void* dk, void* dv, long long n4,
                      int group, int sum_blocks, cudaStream_t stream) {
  flash_bwd_dkv_group_sum_kernel<TO><<<sum_blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TO*>(dk),
      static_cast<TO*>(dv), n4, group);
  return cudaGetLastError();
}

// One launch of the main kernel `kern` (float32 or bf16) on the wrapper's
// plan, which must be its own (grid (B * H, S / 64 * kDkvSplit<D>), 128
// threads, its dynamic shared memory), then under GQA the group sum over
// `sum_blocks` blocks, into T or, with out_f32, float32.
template <typename T, int D, typename Kernel>
cudaError_t launch_kernel(Kernel kern, size_t smem, const void* q,
                          const void* k, const void* v, const void* dout,
                          const void* lse, const void* dvec, void* dk,
                          void* dv, void* part, int B, int S, int H, int Hkv,
                          int causal, float scale, int out_f32,
                          const Plan& plan, int sum_blocks,
                          cudaStream_t stream) {
  if (!plan.is(B * H, S / kTile * kDkvSplit<D>, kMmaThreads, smem))
    return cudaErrorInvalidValue;
  const long long n4 = static_cast<long long>(B) * S * Hkv * D / kSumVec;
  const bool sum = H > Hkv;
  if ((part != nullptr) != sum ||
      sum_blocks != (sum ? (2 * n4 + kSumThreads - 1) / kSumThreads : 0))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(plan.grid_x, plan.grid_y), kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(part), S,
      H, Hkv, causal, scale, out_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || !sum) return err;
  return out_f32 ? group_sum<float>(part, dk, dv, n4, H / Hkv, sum_blocks,
                                    stream)
                 : group_sum<T>(part, dk, dv, n4, H / Hkv, sum_blocks, stream);
}

// Both types stage the k and v tiles (64 rows) and two stages of q and
// dO tiles of kN queries (64; float32 beyond D 128: 16), rows padded by
// 16 bytes, and two stages of kN lse and kN dvec values.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dvec,
                   void* dk, void* dv, void* part, int B, int S, int H,
                   int Hkv, int causal, float scale, int out_f32,
                   const Plan& plan, int sum_blocks, cudaStream_t stream) {
  constexpr int kN =
      std::is_same<T, float>::value ? kStreamRowsF32Dkv<D> : kTile;
  constexpr size_t smem = (2 * kTile + 4 * kN) * (sizeof(T) * D + 16) +
                          sizeof(float) * 4 * kN;
  if constexpr (std::is_same<T, float>::value) {
    return launch_kernel<float, D>(flash_bwd_dkv_f32_kernel<D>, smem, q, k,
                                   v, dout, lse, dvec, dk, dv, part, B, S, H,
                                   Hkv, causal, scale, out_f32, plan,
                                   sum_blocks, stream);
  } else {
    return launch_kernel<__nv_bfloat16, D>(
        flash_bwd_dkv_bf16_kernel<D>, smem, q, k, v, dout, lse, dvec, dk, dv,
        part, B, S, H, Hkv, causal, scale, out_f32, plan, sum_blocks, stream);
  }
}

// Head dims above 256 (flash_common.cuh's wide kernels): block (x, y)
// owns key tile y / (D / 64) of (batch, kv head) x and dk's and dv's
// columns 64 (y % (D / 64)) .. + 63, and sums its kv head's query group
// itself, the group's heads in order. Per (query head, q tile): s and dp
// over the whole D (`wide_first`, rows the queries), p and ds rounded to
// T into xa beside the chunk's q columns in xb, dk += ds^T q from zero;
// then p beside dO's columns, dv += p^T dO from zero.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dvec,
                              void* __restrict__ dk, void* __restrict__ dv,
                              int S, int H, int Hkv, int D, int causal,
                              float scale, int out_f32) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideTile xa = reinterpret_cast<WideTile>(smem_raw);
  const WideTile xb = xa + kTile;
  const int nchunk = D / kWideCols;
  const int bk = blockIdx.x, b = bk / Hkv, hk = bk - b * Hkv;
  const int group = H / Hkv;
  const int nq = S / kTile;
  const int kt = static_cast<int>(blockIdx.y) / nchunk;  // longest first
  const int c0 = (static_cast<int>(blockIdx.y) % nchunk) * kWideCols;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * kTile;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t kbase = (static_cast<size_t>(b) * S + k0) * ks + static_cast<size_t>(hk) * D;
  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      const size_t qbase = (static_cast<size_t>(b) * S + q0) * qs + static_cast<size_t>(h) * D;
      float sc[4][4], dp[4][4];
      wide_first(sc, q, qbase, qs, k, kbase, ks, D, xa, xb, ty, tx);
      wide_first(dp, dout, qbase, qs, v, kbase, ks, D, xa, xb, ty, tx);
      // rows 4 ty + i are queries, columns 4 tx + j keys
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lr = lse[bh * S + q0 + 4 * ty + i];
        const float dr = dvec[bh * S + q0 + 4 * ty + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool masked = causal && k0 + 4 * tx + j > q0 + 4 * ty + i;
          const float p = masked ? 0.f : expf(sc[i][j] * scale - lr);
          sc[i][j] = round_to<T>(p);
          dp[i][j] = round_to<T>(p * (dp[i][j] - dr) * scale);
        }
      }
      float part[4][4];
      __syncthreads();  // dp's last chunk is read
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xa[4 * ty + i][4 * tx + j] = dp[i][j];
      wide_load(xb, q, qbase + c0, qs, false);
      __syncthreads();
      wide_product(part, xa, xb, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_k[i][j] += part[i][j];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xa[4 * ty + i][4 * tx + j] = sc[i][j];
      wide_load(xb, dout, qbase + c0, qs, false);
      __syncthreads();
      wide_product(part, xa, xb, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_v[i][j] += part[i][j];
    }
  }
  const bool f32 = out_f32 != 0 || std::is_same<T, float>::value;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t at = (static_cast<size_t>(b) * S + k0 + 4 * ty + i) * ks +
                      static_cast<size_t>(hk) * D + c0 + 4 * tx;
    wide_store4<T>(dk, at, f32, acc_k[i]);
    wide_store4<T>(dv, at, f32, acc_v[i]);
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dvec,
                     void* dk, void* dv, void* part, int B, int S, int H,
                     int Hkv, int D, int causal, float scale, int out_f32,
                     const Plan& plan, int sum_blocks, cudaStream_t s) {
  if (wide_head_dim(D)) {  // grid (B * Hkv, S / 64 * D / 64), no scratch
    if (!plan.is(B * Hkv, S / kTile * (D / kWideCols), kWideThreads,
                 kWideSmem) || part != nullptr || sum_blocks != 0)
      return cudaErrorInvalidValue;
    flash_bwd_dkv_wide_kernel<T><<<dim3(plan.grid_x, plan.grid_y),
                                   kWideThreads, kWideSmem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dvec), dk,
        dv, S, H, Hkv, D, causal, scale, out_f32);
    return cudaGetLastError();
  }
  return with_head_dim(D, [&](auto d) {
    return launch<T, decltype(d)::value>(q, k, v, dout, lse, dvec, dk, dv,
                                         part, B, S, H, Hkv, causal, scale,
                                         out_f32, plan, sum_blocks, s);
  });
}

}  // namespace

// q, dout (B, S, H, D); k, v, dk, dv (B, S, Hkv, D); one type for all of
// them: dtype 0 = float32 (`flash_bwd_dkv_f32_kernel`), 1 = bfloat16
// (`flash_bwd_dkv_bf16_kernel`); grads_f32 1 makes dk and dv float32 (for
// bf16 inputs; float32 ones have float32 gradients either way). lse, dvec
// (B * H, S) float32. S a multiple of 64, H a multiple of Hkv, D one of
// `with_head_dim`'s instances (flash_common.cuh) or above 256 a multiple
// of 64 (`flash_bwd_dkv_wide_kernel`: grid (B * Hkv, S / 64 * D / 64),
// 256 threads, kWideSmem bytes, the group summed in the block: part null
// and sum_blocks 0); `scale` multiplies the
// logits (the wrapper's 1 / sqrt of the head dim before its zero
// padding); every pointer 16-byte aligned. The plan is the wrapper's
// `flash_bwd_plan`: grid (grid_x, grid_y) = (B * H, S / 64 *
// kDkvSplit<D>), 128 threads, the kernel's dynamic
// shared memory, and with H > Hkv a float32 scratch `part` of
// 2 * (H / Hkv) * B * S * Hkv * D elements and
// `sum_blocks` = ceil(2 * B * S * Hkv * D / 4 / 256) blocks of the group
// sum (else part null and sum_blocks 0); any other plan is refused.
// Returns cudaGetLastError().
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dvec,
                                    void* dk, void* dv, void* part, int B,
                                    int S, int H, int Hkv, int D, int causal,
                                    float scale, int dtype, int grads_f32,
                                    int grid_x,
                                    int grid_y, int threads, int smem,
                                    int sum_blocks, void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0 ||
      (grads_f32 != 0 && grads_f32 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan{grid_x, grid_y, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kDtypeF32:
      err = launch_d<float>(q, k, v, dout, lse, dvec, dk, dv, part, B, S, H,
                            Hkv, D, causal, scale, grads_f32, plan,
                            sum_blocks, s);
      break;
    case kDtypeBF16:
      err = launch_d<__nv_bfloat16>(q, k, v, dout, lse, dvec, dk, dv, part, B,
                                    S, H, Hkv, D, causal, scale, grads_f32,
                                    plan, sum_blocks, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
