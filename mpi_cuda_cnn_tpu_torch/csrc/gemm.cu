// GEMM for Hopper (sm_90a), float32 or bfloat16: C (M, N) = op(A) @ op(B)
// [+ bias], where op(A) is A (M, K) or, with ta, the transpose of a stored
// (K, M) matrix, and op(B) is B (K, N) or, with tb, the transpose of a
// stored (N, K) matrix. All row-major and contiguous, all of one element
// type (dtype 0 = float32, 1 = bfloat16); bias (N,) may be null.
//
// Replaces the TPU kernel `_matmul_kernel` / `_matmul` of
// mpi_cuda_cnn_tpu/ops/pallas_ops.py:59-90 (pallas_call at :77), the one
// contraction behind `dense_pallas` (:93-116): the FC forward x @ W and
// both halves of its backward, g @ W^T and x^T @ g. The transposes are
// read in place (ta/tb pick the shared-memory layout and the fragment
// loads), so the backward makes no transposed copy, and the ragged M, N
// and K edges are zero-filled on load instead of padded to 128 (the
// Pallas pad is a TPU tiling artefact). Products accumulate in float32
// for either type, as the TPU path does (`preferred_element_type`); the
// result is rounded to the element type once; with a bias it is rounded,
// the bias added in float32, and rounded again, as the JAX package's
// `_matmul(x, w) + b` rounds the product to x.dtype before the add (both
// roundings are exact for float32). Float32 stays on FMA: TF32 tensor
// cores would break float32 parity.
//
// What bounds it: at reference_cnn's training step (batch 32; fc 1568 ->
// 200 -> 200 -> 10) a product moves at most 1.3 MB and does at most 20
// MFLOP, under 0.4 us at 3.35 TB/s and 67 TFLOP/s float32: latency, the
// number of blocks in flight and the launch bound it. The eval batch's
// fc1 forward (2048 x 200 x 1568) is the one product with real work:
// 7.9 MB of bf16 operands, about 2.4 us of bytes.
//
// The design:
//   - One launch per product. A block owns a BM x 32 output tile (BM 16,
//     32 or 64 by M, from the wrapper's `gemm_plan`) and one split of K
//     (a run of 32-deep slices); the plan splits K so that even a batch-32
//     product puts about 100 blocks on the card's 132 SMs where it has
//     that many tile-slices.
//   - The slices stream through a ring of shared-memory stages (bf16 4,
//     float32 3) by 16-byte `cp.async` copies, zero-filled past M, N and
//     K (a source size of 0), two or three slices in flight while one
//     computes. (A ring of 8, all of a split's slices in flight at once,
//     measured no faster.) Where a stored row is not a whole number of 16-byte
//     chunks (N = 10 or K = 10 at fc3) or the operand is misaligned, that
//     operand is loaded element by element, four in flight a thread, into
//     the same stage (the plan picks, and refuses a misaligned operand
//     that the shape would copy by chunks).
//   - Each operand keeps its stored layout in shared memory, rows padded
//     by 16 bytes so that neighbouring rows fall in other banks; (ta, tb)
//     are template parameters, so no layout branch is left in the loop.
//   - bf16: `mma.sync` m16n8k16 with float32 accumulators (mma.cuh). The
//     4 warps tile the block as BM/16 x 4/(BM/16); each warp owns 16 rows
//     by 8, 16 or 32 columns. A (M, K) feeds the A fragment by plain
//     `ldmatrix`, A stored (K, M) by `ldmatrix.trans`; B (K, N) feeds the
//     col-major B fragment by `ldmatrix.trans`, B stored (N, K) by plain
//     `ldmatrix`.
//   - float32: BM x 32 / 16 threads, each holding 4 x 4 outputs; per 4
//     steps of k it reads 4 + 4 float4 from shared memory for 64 FMAs.
//   - The split sum in the same launch: each split writes its float32
//     partial tile, then `__threadfence()` and one atomicAdd on the tile's
//     int32 counter; the block that finds itself last sums the splits in
//     split order (the same bits whichever block is last: no float
//     atomics), applies the epilogue and resets the counter to zero for
//     the next launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace {

constexpr int kBN = 32;     // output columns of a tile
constexpr int kBK = 32;     // depth of a K slice
constexpr int kBatch = 4;   // element-wise loads in flight a thread

template <typename T>
constexpr bool kIsBF16 = std::is_same<T, __nv_bfloat16>::value;
// Elements of a 16-byte chunk: the copy width and every row's padding.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));
// Ring stages: bf16 three slices in flight ahead of the one in use,
// float32 (whose FMA tile takes longer a slice) two.
template <typename T>
constexpr int kStages = kIsBF16<T> ? 4 : 3;
// Threads: bf16 4 warps; float32 one thread per 4 x 4 outputs.
template <typename T, int BM>
constexpr int kThreadsOf = kIsBF16<T> ? 128 : BM * kBN / 16;

// Shared layouts, the stored ones: A as [m][k] or, with TA, [k][m]; B as
// [k][n] or, with TB, [n][k]; each row padded by one 16-byte chunk.
template <typename T, bool TA, int BM>
struct ATile {
  static constexpr int kRows = TA ? kBK : BM;
  static constexpr int kLd = (TA ? BM : kBK) + kVec<T>;
};
template <typename T, bool TB>
struct BTile {
  static constexpr int kRows = TB ? kBN : kBK;
  static constexpr int kLd = (TB ? kBK : kBN) + kVec<T>;
};

struct Args {
  int M, N, K, kchunk, splits;
  int a_vec, b_vec;
};

// The stored value of one output: the float32 sum rounded to T, plus the
// bias rounded again (see the header).
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, int gn) {
  if (bias == nullptr) return from_f32<T>(acc);
  return from_f32<T>(round_to<T>(acc) + to_f32(bias[gn]));
}

// Rows x cols of a stored matrix (ld elements a row) into a shared tile
// [rows][kLd]: the block of stored rows r0 .. r0 + rows - 1 (below rend)
// and columns c0 .. c0 + cols - 1 (below cend); the rest reads as zero.
// vec: 16-byte chunks (cend - c0 .. and ld multiples of a chunk, the base
// 16-byte aligned); else element by element, kBatch loads in flight, over
// the real rows and columns only.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ src,
                                          int ld, int r0, int rend, int c0,
                                          int cend, bool vec, int tid) {
  if (vec) {
    constexpr int kCpr = COLS / kVec<T>;  // chunks a row
#pragma unroll
    for (int e = tid; e < ROWS * kCpr; e += THREADS) {
      const int r = e / kCpr, q = (e - r * kCpr) * kVec<T>;
      const int gr = r0 + r, gc = c0 + q;
      const bool ok = gr < rend && gc < cend;
      const T* p = ok ? src + static_cast<size_t>(gr) * ld + gc : src;
      mma::cp_async16(tile + r * LD + q, p, ok);
    }
  } else {
    // The real block (rr x cr) is loaded, the rest of the tile zeroed
    // with no load: a thread's loads are all real ones.
    const int rr = max(0, min(ROWS, rend - r0)), cr = max(0, min(COLS, cend - c0));
    const T zero = from_f32<T>(0.f);
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e - r * COLS;
      if (r >= rr || c >= cr) tile[r * LD + c] = zero;
    }
    const int total = rr * cr;
    for (int e0 = tid; e0 < total; e0 += kBatch * THREADS) {
      T v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * THREADS;
        const int r = e / cr, c = e - r * cr;
        dst[u] = e < total ? r * LD + c : -1;
        if (e < total) v[u] = src[static_cast<size_t>(r0 + r) * ld + c0 + c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (dst[u] >= 0) tile[dst[u]] = v[u];
    }
  }
}

// ldmatrix of two 8 x 8 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(mma::smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(mma::smem_addr(p)));
}

template <typename T, bool TA, bool TB, int BM>
__global__ void __launch_bounds__(kThreadsOf<T, BM>)
    gemm_kernel(Args g, const T* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ bias, T* __restrict__ C,
                float* __restrict__ work, int* __restrict__ cnt) {
  constexpr int kT = kThreadsOf<T, BM>;
  constexpr int kS = kStages<T>;
  using AT = ATile<T, TA, BM>;
  using BT = BTile<T, TB>;
  __shared__ __align__(16) T As[kS][AT::kRows * AT::kLd];
  __shared__ __align__(16) T Bs[kS][BT::kRows * BT::kLd];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * g.kchunk;
  const int kend = min(g.K, kbeg + g.kchunk);
  const int nslices = (kend - kbeg + kBK - 1) / kBK;

  // Slice s (from k0) into stage st.
  auto load = [&](int st, int k0) {
    if constexpr (TA)
      load_tile<T, kBK, BM, AT::kLd, kT>(As[st], A, g.M, k0, kend, m0, g.M,
                                         g.a_vec, tid);
    else
      load_tile<T, BM, kBK, AT::kLd, kT>(As[st], A, g.K, m0, g.M, k0, kend,
                                         g.a_vec, tid);
    if constexpr (TB)
      load_tile<T, kBN, kBK, BT::kLd, kT>(Bs[st], B, g.K, n0, g.N, k0, kend,
                                          g.b_vec, tid);
    else
      load_tile<T, kBK, kBN, BT::kLd, kT>(Bs[st], B, g.N, k0, kend, n0, g.N,
                                          g.b_vec, tid);
  };

  // bf16: warp (wm, wn) owns rows 16 wm .. +15 and kNT n-tiles of 8 from
  // column kWC wn. float32: thread (tm, tn) owns rows 4 tm .. +3 and
  // columns 4 tn .. +3 (with TB tn + 8 c, so that the [n][k] reads of
  // neighbouring threads fall in other banks).
  constexpr int kWM = BM / 16 < 4 ? BM / 16 : 4;
  constexpr int kWC = kBN / (4 / kWM);
  constexpr int kNT = kWC / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int tn = tid % (kBN / 4), tm = tid / (kBN / 4);
  constexpr int kAccN = kIsBF16<T> ? kNT : 4;
  float acc[kAccN][4];
#pragma unroll
  for (int i = 0; i < kAccN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // One commit group per slice (empty past the last), so that waiting for
  // all but the newest kS - 2 groups means this slice has landed.
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < nslices) load(s, kbeg + s * kBK);
    mma::cp_async_commit();
  }
  for (int i = 0; i < nslices; ++i) {
    const int st = i % kS;
    mma::cp_async_wait<kS - 2>();
    __syncthreads();  // slice i landed; slice i - 1's stage is free
    if (i + kS - 1 < nslices) load((i + kS - 1) % kS, kbeg + (i + kS - 1) * kBK);
    mma::cp_async_commit();
    const T* as = As[st];
    const T* bs = Bs[st];
    if constexpr (kIsBF16<T>) {
#pragma unroll
      for (int k16 = 0; k16 < kBK; k16 += 16) {
        uint32_t a[4];
        if constexpr (TA)
          mma::ldmatrix_x4_trans(
              a, as + (k16 + (lane >> 4) * 8 + (lane & 7)) * AT::kLd +
                     wm * 16 + ((lane >> 3) & 1) * 8);
        else
          mma::ldmatrix_x4(a, as + (wm * 16 + (lane & 15)) * AT::kLd + k16 +
                                  (lane >> 4) * 8);
        // Matrix j = lane / 8 of an x4 holds (b0, b1) of n-tile 2p for
        // j = 0, 1 and of n-tile 2p + 1 for j = 2, 3.
#pragma unroll
        for (int p = 0; p < (kNT + 1) / 2; ++p) {
          const int nb = wn * kWC + 16 * p;
          const int j = lane >> 3;
          const T* addr;
          if constexpr (TB)
            addr = bs + (nb + (j >> 1) * 8 + (lane & 7)) * BT::kLd + k16 +
                   (j & 1) * 8;
          else
            addr = bs + (k16 + (j & 1) * 8 + (lane & 7)) * BT::kLd + nb +
                   (j >> 1) * 8;
          if constexpr (kNT == 1) {
            uint32_t b[2];
            ldmatrix_x2(b, addr, !TB);
            mma::mma_bf16(acc[0], a, b[0], b[1]);
          } else {
            uint32_t b[4];
            if constexpr (TB)
              mma::ldmatrix_x4(b, addr);
            else
              mma::ldmatrix_x4_trans(b, addr);
            mma::mma_bf16(acc[2 * p], a, b[0], b[1]);
            mma::mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        float av[4][4], bv[4][4];  // av[row][k], bv[k][col]
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 v;
          if constexpr (TA) {
            v = *reinterpret_cast<const float4*>(as + (kk + u) * AT::kLd + tm * 4);
            av[0][u] = v.x, av[1][u] = v.y, av[2][u] = v.z, av[3][u] = v.w;
          } else {
            v = *reinterpret_cast<const float4*>(as + (tm * 4 + u) * AT::kLd + kk);
            av[u][0] = v.x, av[u][1] = v.y, av[u][2] = v.z, av[u][3] = v.w;
          }
          if constexpr (TB) {
            v = *reinterpret_cast<const float4*>(bs + (tn + 8 * u) * BT::kLd + kk);
            bv[0][u] = v.x, bv[1][u] = v.y, bv[2][u] = v.z, bv[3][u] = v.w;
          } else {
            v = *reinterpret_cast<const float4*>(bs + (kk + u) * BT::kLd + tn * 4);
            bv[u][0] = v.x, bv[u][1] = v.y, bv[u][2] = v.z, bv[u][3] = v.w;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(av[r][u], bv[u][c], acc[r][c]);
      }
    }
  }

  // (row, column) in the tile of accumulator (i, j).
  auto at = [&](int i, int j, int& r, int& c) {
    if constexpr (kIsBF16<T>) {
      r = wm * 16 + (lane >> 2) + 8 * (j >> 1);
      c = wn * kWC + 8 * i + 2 * (lane & 3) + (j & 1);
    } else {
      r = tm * 4 + i;
      c = TB ? tn + 8 * j : tn * 4 + j;
    }
  };
  const size_t mn = static_cast<size_t>(g.M) * g.N;
  float* mine = work + blockIdx.z * mn;
#pragma unroll
  for (int i = 0; i < kAccN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r, c;
      at(i, j, r, c);
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= g.M || gn >= g.N) continue;
      const size_t idx = static_cast<size_t>(gm) * g.N + gn;
      if (g.splits == 1)
        C[idx] = epilogue(acc[i][j], bias, gn);
      else
        mine[idx] = acc[i][j];
    }
  if (g.splits == 1) return;

  // The last split of this tile to finish sums the splits in order.
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (tid == 0) last = atomicAdd(&cnt[tile], 1) == g.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Each thread sums kPer runs of 4 columns of one row; the loads of
  // kUnroll splits of all its runs are issued before their additions,
  // which go in split order.
  constexpr int kPer = BM * kBN / 4 / kT;
  constexpr int kUnroll = 16 / kPer;  // 16 float4 loads in flight
  const bool vec4 = (g.N & 3) == 0;
  int rm[kPer], rn[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = tid + p * kT;
    rm[p] = m0 + e / (kBN / 4);
    rn[p] = n0 + (e % (kBN / 4)) * 4;
  }
  float sum[kPer][4] = {};
  for (int z0 = 0; z0 < g.splits; z0 += kUnroll) {
    float v[kUnroll][kPer][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const bool ok = z0 + u < g.splits && rm[p] < g.M && rn[p] < g.N;
        const float* src =
            work + (z0 + u) * mn + static_cast<size_t>(rm[p]) * g.N + rn[p];
        if (ok && vec4) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(src));
          v[u][p][0] = q.x, v[u][p][1] = q.y, v[u][p][2] = q.z, v[u][p][3] = q.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[u][p][c] = ok && rn[p] + c < g.N ? __ldcg(src + c) : 0.f;
        }
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int p = 0; p < kPer; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[p][c] += v[u][p][c];
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (rm[p] < g.M && rn[p] + c < g.N)
        C[static_cast<size_t>(rm[p]) * g.N + rn[p] + c] =
            epilogue(sum[p][c], bias, rn[p] + c);
  if (tid == 0) cnt[tile] = 0;  // ready for the next launch
}

template <typename T, bool TA, bool TB, int BM>
cudaError_t run(const Args& g, const void* a, const void* b, const void* bias,
                void* c, void* work, void* cnt, cudaStream_t s) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + BM - 1) / BM, g.splits);
  gemm_kernel<T, TA, TB, BM><<<grid, kThreadsOf<T, BM>, 0, s>>>(
      g, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(c),
      static_cast<float*>(work), static_cast<int*>(cnt));
  return cudaGetLastError();
}

template <typename T, bool TA, bool TB>
cudaError_t by_tile(int bm, const Args& g, const void* a, const void* b,
                    const void* bias, void* c, void* work, void* cnt,
                    cudaStream_t s) {
  switch (bm) {
    case 16: return run<T, TA, TB, 16>(g, a, b, bias, c, work, cnt, s);
    case 32: return run<T, TA, TB, 32>(g, a, b, bias, c, work, cnt, s);
    case 64: return run<T, TA, TB, 64>(g, a, b, bias, c, work, cnt, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_layout(int ta, int tb, int bm, const Args& g, const void* a,
                      const void* b, const void* bias, void* c, void* work,
                      void* cnt, cudaStream_t s) {
  if (ta && tb) return by_tile<T, true, true>(bm, g, a, b, bias, c, work, cnt, s);
  if (ta) return by_tile<T, true, false>(bm, g, a, b, bias, c, work, cnt, s);
  if (tb) return by_tile<T, false, true>(bm, g, a, b, bias, c, work, cnt, s);
  return by_tile<T, false, false>(bm, g, a, b, bias, c, work, cnt, s);
}

}  // namespace

// The plan (bm, kchunk, splits, a_vec, b_vec) comes from the wrapper's
// `gemm_plan`: output tiles of bm (16, 32 or 64) x 32, K split into
// `splits` runs of `kchunk` (a multiple of 32; splits = ceil(K / kchunk)),
// a_vec / b_vec = 16-byte copies of A / B, which need the operand's
// stored rows to be whole 16-byte chunks and its base 16-byte aligned.
// With splits > 1, `work` holds splits * M * N float32 partials and `cnt`
// one zeroed int per output tile, which the kernel leaves zeroed. A plan
// that breaks any of these is refused. Returns cudaGetLastError() after
// the one launch.
extern "C" int gemm_launch(const void* a, const void* b, const void* bias,
                           void* c, void* work, void* cnt, int M, int N, int K,
                           int ta, int tb, int bm, int kchunk, int splits,
                           int a_vec, int b_vec, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || kchunk < kBK || kchunk % kBK != 0 ||
      splits != (K + kchunk - 1) / kchunk ||
      (splits > 1 && (work == nullptr || cnt == nullptr)) ||
      (bm != 16 && bm != 32 && bm != 64) ||
      static_cast<long long>(M) * K >= (1LL << 31) ||
      static_cast<long long>(N) * K >= (1LL << 31) ||
      static_cast<long long>(M) * N >= (1LL << 31) ||
      (M + bm - 1) / bm > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv = dtype == kDtypeBF16 ? 8 : 4;
  const int a_row = ta ? M : K, b_row = tb ? K : N;
  if ((a_vec && (a_row % kv != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0)) ||
      (b_vec && (b_row % kv != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{M, N, K, kchunk, splits, a_vec, b_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32)
    err = by_layout<float>(ta, tb, bm, g, a, b, bias, c, work, cnt, s);
  else if (dtype == kDtypeBF16)
    err = by_layout<__nv_bfloat16>(ta, tb, bm, g, a, b, bias, c, work, cnt, s);
  return static_cast<int>(err);
}
