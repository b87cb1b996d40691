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
// far above the card's balance point. Both types run on the tensor cores:
// bf16 at 989 TFLOP/s, float32 as 3xTF32 (mma.cuh), three tf32 products at
// 495 TFLOP/s (TF32 stays off everywhere else).
//
// Both paths are FlashAttention-2's forward: 128 threads, 4 warps each
// owning 16 query rows; s = q k^T and o += p v on `mma.sync`; the online
// softmax in float32 on the accumulator fragments (s * scale, the causal
// mask on the diagonal tile only, row max and sum over the 4 lanes of a
// quad, exp(s - m)); p used as the A operand of p v straight from its
// accumulators; l sums the unrounded p.
//
// bf16 (`flash_fwd_bf16_kernel`): m16n8k16. The q fragments are loaded
// once with `ldmatrix`; k and v tiles of 64 keys stay bf16 in shared
// memory (rows padded by 16 bytes, so `ldmatrix` is conflict-free),
// double-buffered with `cp.async` so tile j+1 loads while tile j is
// multiplied; p is rounded to bf16 in registers and packed as the A
// operand (the accumulator and A fragments coincide), v read through
// `ldmatrix.trans`.
//
// float32 (`flash_fwd_f32_kernel`): m16n8k8 tf32 as 3xTF32 on the float32
// tile pieces of flash_common.cuh (the design of the float32 backward,
// flash_bwd_dq.cu): tiles of D + 4 floats a row copied by 16-byte
// `cp.async`, s = q k^T with d permuted inside each k-chunk (float2
// reads), p split and permuted from its accumulators into the A operand
// of p v, v's rows read in the same order. The splits, not the products,
// set the pace of the float32 backward, so q, the A operand of every k
// tile, is split once: its (hi, lo) fragments stay in registers at D <= 64
// (64 registers at D 64), and at D 128 the q tile is split in place into
// hi and lo tiles in shared memory. k and v are split as each warp reads
// them, double-buffered by `cp.async` (q staged in the second stage),
// 218 registers at D 64 and two blocks an SM. Splitting each k/v tile
// once per block into hi and lo tiles instead (one stage, two more
// barriers a tile, twice the shared-memory reads) measured slower at
// every head dim on an H100 SXM at 700 W (0.863 against 0.714 ms at the
// LM flagship), so it is not kept. Each tile's p v is summed from zero
// and added to the alpha-rescaled o in float32: the tensor core's float32
// sums behave as truncating, and a bias carried over a row of 32 tiles
// would exceed 1e-5 (tests/test_torch_flash_tf32x3.py).
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
//     layout detail); with `out_f32` the bf16 kernel stores o in float32,
//     unrounded (the TPU wrapper's out_f32, which the ring-flash fold of
//     parallel/sp.py merges its partials in), a branch of the epilogue.
//
// Head dims: `with_head_dim`'s instances (16, 32, 64, 80, 96, 128, 256;
// the wrapper pads any other D <= 256 with zeros to the next and passes
// the real D's scale). At D 16 a bf16 q k^T is one m16n8k16 k-step and
// p v two n8 tiles; a float32 one two m16n8k8 k-steps. Rows of D * 2 or
// D * 4 bytes (D a multiple of 16) plus the 16-byte pad keep every
// `cp.async` and `ldmatrix` row address 16-byte aligned. Beyond D 128
// (D 256) the (16, D) float32 o takes 128 registers a thread: the bf16
// kernel re-reads q's fragments per k tile instead of holding them, and
// the float32 one streams k and v in tiles of 32 keys (a k tile then
// meets the causal diagonal in two halves, masked key by key), stages q
// as a float32 tile split as it is read, and sums p v 4 column tiles at
// a time.

#include "flash_common.cuh"
#include "mma.cuh"

namespace {

using namespace flash;

// A fragment (hi, lo) of k-chunk kc from tiles already split: `ph` =
// &hi[row0 + g][kc * 8 + 2t], `pl` the same place of lo (frag_a_tf32's
// order: rows g and g + 8, d 2t and 2t + 1).
template <int LD>
__device__ __forceinline__ void frag_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const uint32_t* ph,
                                             const uint32_t* pl) {
  const uint2 h0 = *reinterpret_cast<const uint2*>(ph);
  const uint2 h1 = *reinterpret_cast<const uint2*>(ph + 8 * LD);
  const uint2 l0 = *reinterpret_cast<const uint2*>(pl);
  const uint2 l1 = *reinterpret_cast<const uint2*>(pl + 8 * LD);
  hi[0] = h0.x, hi[1] = h1.x, hi[2] = h0.y, hi[3] = h1.y;
  lo[0] = l0.x, lo[1] = l1.x, lo[2] = l0.y, lo[3] = l1.y;
}

// Split the staged (64, D) float32 q tile in place: its elements become
// their tf32 hi bits and `lo` (the same layout) receives tf32(x - hi). A
// row's 16-byte words are padded to whole quarter warps (8 lanes; at D 80
// 20 words take 24 lanes, 4 idle), so that no quarter warp's 128-bit
// access crosses into the next row's banks.
template <int D, int LD>
__device__ __forceinline__ void split_tile(float* t, float* lo) {
  constexpr int kWords = (D / 4 + 7) / 8 * 8;
  for (int e = threadIdx.x; e < kTile * kWords; e += kMmaThreads) {
    const int r = e / kWords, c = (e - r * kWords) * 4;
    if (c >= D) continue;
    float4* px = reinterpret_cast<float4*>(t + r * LD + c);
    const float4 x = *px;
    uint4 h, l;
    mma::split_tf32(x.x, h.x, l.x);
    mma::split_tf32(x.y, h.y, l.y);
    mma::split_tf32(x.z, h.z, l.z);
    mma::split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(px) = h;
    *reinterpret_cast<uint4*>(lo + r * LD + c) = l;
  }
}

// Shared-memory rows of the float32 kernel, D + 4 floats each: k and v in
// two stages of kStreamRowsF32Fwd<D> keys, and at D in (64, 128] q's hi
// and lo tiles, beyond D 128 q's float32 tile (two stages of 32 keys and
// q: 192 rows, 199,680 bytes at D 256, where six 64-row tiles would need
// 399,360). Its plan (`flash_fwd_plan`) counts them.
template <int D>
constexpr int kF32Rows =
    D <= 64 ? 4 * kTile
            : (D <= 128 ? 6 * kTile : 4 * kStreamRowsF32Fwd<D> + kTile);

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int Hkv,
                         int causal, float scale, int /*out_f32*/) {
  constexpr int kLd = kLdF32<D>;  // D + 4: row stride in floats
  constexpr int kN = kStreamRowsF32Fwd<D>;  // keys of a k/v tile
  constexpr int kTileElems = kN * kLd;
  constexpr int kChunks = D / 4;  // 16-byte copies per row
  constexpr int kKc = D / 8;      // k-chunks of the q k^T product
  constexpr bool kHoldQ = D <= 64;  // q's (hi, lo) fragments in registers
  constexpr bool kSplitQ = D > 64 && D <= 128;  // q's hi and lo tiles
  // Column tiles of p v summed at once (fewer beyond D 128, where the
  // (16, D) o takes 128 registers).
  constexpr int kGroup = D > 128 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);
  // Tiles 0-3 (kN rows each): k, v of stage 0 and of stage 1. Tiles 4, 5
  // at D in (64, 128]: q's hi and lo. q is staged in tile 2 (stage 1's k,
  // D <= 64) or from tile 4 on (64 rows).
  auto tile = [&](int i) { return tiles + i * kTileElems; };
  auto bits = [&](int i) {
    return reinterpret_cast<const uint32_t*>(tiles + i * kTileElems);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const size_t q_rs = static_cast<size_t>(H) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;

  float* q_stage = tile(kHoldQ ? 2 : 4);
  const float* qb = q + ((static_cast<size_t>(b) * S + q0) * H + h) * D;
  for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 4;
    mma::cp_async16(q_stage + r * kLd + c, qb + r * q_rs + c, true);
  }
  auto load_kv = [&](int kt, int st) {
    const size_t off =
        ((static_cast<size_t>(b) * S + kt * kN) * Hkv + kvh) * D;
    float* ks = tile(2 * st);
    float* vs = tile(2 * st + 1);
    for (int e = tid; e < kN * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 4;
      mma::cp_async16(ks + r * kLd + c, k + off + r * kv_rs + c, true);
      mma::cp_async16(vs + r * kLd + c, v + off + r * kv_rs + c, true);
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
  uint32_t qh[kHoldQ ? kKc : 1][4], ql[kHoldQ ? kKc : 1][4];
  const int arow = (16 * warp + g) * kLd + 2 * t4;  // frag_a_tf32's place

  const int nk = causal ? (q0 + kTile) / kN : S / kN;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; stage (kt+1)&1 is free again
    if (kt == 0 && (kHoldQ || kSplitQ)) {
      // q split once: into registers, or in place into tiles 4 (hi) and 5.
      if constexpr (kHoldQ) {
#pragma unroll
        for (int kc = 0; kc < kKc; ++kc)
          frag_a_tf32<kLd>(qh[kc], ql[kc], q_stage + arow + kc * 8);
      } else {
        split_tile<D, kLd>(tile(4), tile(5));
      }
      __syncthreads();  // q read (its staging tile is free) or split
    }
    if (kt + 1 < nk) {
      load_kv(kt + 1, (kt + 1) & 1);
      mma::cp_async_commit();
    }
    const float* ks = tile(2 * (kt & 1));
    const float* vs = ks + kTileElems;

    // s = q k^T: k's rows [key][d] are the col-major B (key 8j + g; d 2t
    // and 2t + 1 of chunk kc, flash_common.cuh).
    // In chains of kFirstChain k-chunks (flash_common.cuh).
    float s[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kKc; c0 += kFirstChain) {
      float ps[kN / 8][4];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[j][e] = 0.f;
#pragma unroll
      for (int kc = c0; kc < c0 + kFirstChain && kc < kKc; ++kc) {
        uint32_t ah[4], al[4];
        if constexpr (kHoldQ) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[e] = qh[kc][e], al[e] = ql[kc][e];
        } else if constexpr (kSplitQ) {
          frag_a_split<kLd>(ah, al, bits(4) + arow + kc * 8,
                            bits(5) + arow + kc * 8);
        } else {
          frag_a_tf32<kLd>(ah, al, q_stage + arow + kc * 8);
        }
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int at = (8 * j + g) * kLd + kc * 8 + 2 * t4;
          uint32_t bh[2], bl[2];
          frag_b_tf32(bh, bl, ks + at);
          mma::mma_tf32x3(ps[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += ps[j][e];
    }

    // A k tile that reaches past the q tile's first row meets the
    // diagonal: its keys after a row's own are masked (kt * kN - q0 is
    // the tile's first key relative to the q tile).
    const bool diag = causal && (kt + 1) * kN > q0;
    const int koff = kt * kN - q0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;  // within the q tile
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep = !diag || koff + j * 8 + 2 * t4 + e <= row;
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
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool keep = !diag || koff + j * 8 + 2 * t4 + e <= row;
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

    // o += p v: p's accumulators of key n-tile j, split and permuted, are
    // the A fragment of key chunk j; v's rows [key][d] are the row-major B
    // with its rows in the same order (flash_common.cuh). Summed from zero
    // per tile, then added to the rescaled o.
    permuted_product_tf32x3<kN / 8, D / 8, kLd, kGroup>(
        acc, s, vs + 2 * t4 * kLd + g);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    const float lc = fmaxf(l[half], 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8 + 2 * t4) =
          make_float2(acc[j][2 * half] / lc, acc[j][2 * half + 1] / lc);
    if (t4 == 0) lse[static_cast<size_t>(bh) * S + row] = m[half] + logf(lc);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          void* __restrict__ o, float* __restrict__ lse,
                          int S, int H, int Hkv, int causal, float scale,
                          int out_f32) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;        // row stride, 16 bytes of padding
  constexpr int kTileElems = kTile * kLd;
  constexpr int kChunks = D / 8;    // 16-byte copies per row
  // q's fragments held in registers; beyond D 128 re-read per k tile,
  // beside the (16, D) float32 o that takes 128 registers there.
  constexpr bool kHoldQ = D <= 128;
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
  for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    mma::cp_async16(q_s + r * kLd + c, qb + r * q_rs + c, true);
  }
  auto load_kv = [&](int kt, int st) {
    const size_t off = ((static_cast<size_t>(b) * S + kt * kTile) * Hkv + kvh) * D;
    for (int e = tid; e < kTile * kChunks; e += kMmaThreads) {
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
  uint32_t qf[kHoldQ ? D / 16 : 1][4];
  // A fragment of k-chunk kc of this warp's 16 rows of q.
  auto frag_q = [&](uint32_t(&r)[4], int kc) {
    mma::ldmatrix_x4(r, q_s + (16 * warp + (lane & 15)) * kLd + kc * 16 +
                            (lane >> 4) * 8);
  };

  const int nk = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile kt landed; stage (kt+1)&1 is free again
    if constexpr (kHoldQ) {
      if (kt == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) frag_q(qf[kc], kc);
      }
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
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[e] = qf[kc][e];
      } else {
        frag_q(aq, kc);
      }
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bb[4];
        mma::ldmatrix_x4(bb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                                 kc * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], aq, bb[0], bb[1]);
        mma::mma_bf16(s[2 * np + 1], aq, bb[2], bb[3]);
      }
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
    const size_t at = ((static_cast<size_t>(b) * S + row) * H + h) * D;
    if (out_f32) {
      float* orow = static_cast<float*>(o) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + j * 8 + 2 * t4) =
            make_float2(acc[j][2 * half] / lc, acc[j][2 * half + 1] / lc);
    } else {
      bf16* orow = static_cast<bf16*>(o) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t pair = mma::pack_bf16x2(acc[j][2 * half] / lc,
                                               acc[j][2 * half + 1] / lc);
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t4) = pair;
      }
    }
    if (t4 == 0) lse[static_cast<size_t>(bh) * S + row] = m[half] + logf(lc);
  }
}

// One launch of `kern` on the wrapper's plan, which must be the kernel's
// own: grid (B * H, S / 64), 128 threads, its dynamic shared memory.
template <typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kern, size_t smem, const void* q,
                          const void* k, const void* v, void* o, void* lse,
                          int B, int S, int H, int Hkv, int causal,
                          float scale, int out_f32, const Plan& plan,
                          cudaStream_t stream) {
  if (!plan.is(B * H, S / kTile, kMmaThreads, smem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(plan.grid_x, plan.grid_y), kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, Hkv, causal, scale, out_f32);
  return cudaGetLastError();
}

// float32: kF32Rows<D> rows of D + 4 floats; bf16: q and two stages of k
// and v, (64, D + 8) bf16 each.
template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int H, int Hkv, int causal,
                     float scale, int dtype, int out_f32, const Plan& plan,
                     cudaStream_t s) {
  if (dtype == kDtypeBF16) {
    constexpr size_t smem = sizeof(__nv_bfloat16) * 5 * kTile * (D + 8);
    return launch_kernel<__nv_bfloat16>(flash_fwd_bf16_kernel<D>, smem, q, k,
                                        v, o, lse, B, S, H, Hkv, causal, scale,
                                        out_f32, plan, s);
  }
  if (dtype != kDtypeF32) return cudaErrorInvalidValue;
  constexpr size_t smem = kF32Rows<D> * (sizeof(float) * D + 16);
  return launch_kernel<float>(flash_fwd_f32_kernel<D>, smem, q, k, v, o, lse,
                              B, S, H, Hkv, causal, scale, out_f32, plan, s);
}

}  // namespace

// q (B, S, H, D), k/v (B, S, Hkv, D), o (B, S, H, D), all contiguous, of
// one type and 16-byte aligned: dtype 0 = float32 (`flash_fwd_f32_kernel`),
// 1 = bfloat16 (`flash_fwd_bf16_kernel`); out_f32 1 makes o float32 (for
// bf16 inputs; float32 ones have a float32 o either way). lse (B * H, S)
// float32. S a multiple of 64, H a multiple of Hkv, D one of
// `with_head_dim`'s instances (flash_common.cuh); `scale` multiplies the
// logits (the wrapper's 1 / sqrt of the head dim before its zero padding).
// The plan (grid_x, grid_y, threads, smem) is the wrapper's
// `flash_fwd_plan`: grid (B * H, S / 64), 128 threads and the kernel's
// dynamic shared memory; any other plan is refused. Returns
// cudaGetLastError().
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int H,
                                int Hkv, int D, int causal, float scale,
                                int dtype, int out_f32, int grid_x,
                                int grid_y, int threads, int smem,
                                void* stream) {
  if (B < 1 || S < kTile || S % kTile != 0 || Hkv < 1 || H % Hkv != 0 ||
      (out_f32 != 0 && out_f32 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan{grid_x, grid_y, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_head_dim(D, [&](auto d) {
    return launch_d<decltype(d)::value>(q, k, v, o, lse, B, S, H, Hkv, causal,
                                        scale, dtype, out_f32, plan, s);
  }));
}
