// int8-weight matmul for Hopper (sm_90a): y = (x @ q) * s with x (N, din)
// float32, q (din, dout) int8, s (1, dout) float32 per-output-channel
// scales, y (N, dout) float32. N is the decode batch (slots) at a decode
// tick and the chunk width at a prefill chunk.
//
// Replaces the TPU kernel `_gemv_kernel` / `_run_gemv` / `int8_gemv` of
// mpi_cuda_cnn_tpu/ops/pallas_gemv.py (pallas_call at :143): the int8
// weight is widened to float32 exactly, products accumulate in float32,
// and the scale row multiplies the output once, after the sum (it is
// constant along the contracted din, so it never enters the sum).
//
// What bounds it on this card: not bytes and not arithmetic. At the
// serving shapes (N 8 or 32; din x dout 512 x 256 up to 512 x 8192 and
// 2048 x 512) a launch moves 0.1-4 MB and does at most 268 MFLOP, under
// 1.4 us of bytes at 3.35 TB/s and 4 us of float32 FMA at 67 TFLOP/s,
// against about 5 us for an empty launch. What costs is latency: the
// launch, and the chain of dependent device-memory round trips inside a
// block. A block that walks all of din in steps, waiting on memory at
// each, pays a round trip per step; a grid of one block per column tile
// leaves most of the 132 SMs idle (2-64 blocks at N 8).
//
// The design keeps the chain fixed, whatever din is:
//   - din is split across blocks. A block owns a tile of 32 output columns,
//     a slice of `kslice` rows of din (a multiple of 32, at most 512) and
//     up to 32 rows of x; `int8_gemm_plan` picks the splits so that the
//     grid holds about one block per SM (128-256 at the serving shapes)
//     wherever the product has that many (tile, slice) pairs.
//   - A block issues every copy of its slab before its first FMA: its
//     kslice x 32 bytes of q (16-byte `cp.async`, 8 or 4 where dout is not
//     a multiple of 16, byte loads where it is odd) and its rows of x
//     (16-byte `cp.async`, 4-byte where din % 4 or x's address forbids),
//     zero-filled past din, dout and N, then one wait and one barrier.
//   - Each thread holds an 8-row x 4-column float32 register tile and
//     takes every k_lanes-th group of 4 rows of the slice: per group it
//     reads x as one 16-byte shared load per row and q as one 4-byte word
//     per row, widens the int8 bytes exactly (a byte permute into a
//     float32 of exponent 2^23 and one subtraction, no I2F), and does 128
//     FMAs. The k-lanes' tiles meet in shared memory, summed in k-lane
//     order.
//   - With one split the block scales and stores its outputs. Otherwise it
//     writes its float32 partial tile to the wrapper's scratch, then
//     `__threadfence()` and one atomicAdd on the tile's int32 counter; the
//     block that finds itself last sums the splits in split order (all of
//     a chunk's loads in flight before its additions; the same bits
//     whichever block is last: no float atomics), multiplies by the scale
//     once and resets the counter for the next launch. So each product is
//     one launch, and its chain is: copies, sums, the partial's store, the
//     counter, the split sum. `tools/gemv_breakdown.py` times the kernel
//     with each of these taken out.
//
// Layouts (all row-major, contiguous): x (N, din), q (din, dout), s (1,
// dout), y (N, dout); scratch (row blocks, tiles, splits, rows, 32)
// float32; counters one int32 per (row block, tile), zero between launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 32;         // output columns of a tile
constexpr int kQuads = kTileN / 4; // 4-column groups of a tile
constexpr int kGroupRows = 8;      // rows of x of a thread's register tile
constexpr int kMaxRows = 32;       // rows of x a block holds
constexpr int kSliceUnit = 32;     // kslice is a multiple of this
constexpr int kMaxSlice = 512;     // the deepest slice
constexpr int kMaxThreads = 256;
constexpr int kQPitch = kTileN + 16;  // bytes of a q row in shared memory
constexpr int kSumChunk = 8;          // split partials in flight a thread
constexpr int kLaneChunk = 8;         // k-lanes in flight a thread; k_lanes
                                      // is a multiple of it

struct Geometry {
  int N, din, dout;
  int rows;      // rows of x a block holds (8, 16, 24 or 32)
  int kslice;    // din rows of a split
  int splits;    // ceil(din / kslice)
  int k_lanes;   // threads sharing a (row group, column quad) over k
  int q_vec;     // bytes of a q copy: 16, 8, 4 or 1
  int x_vec;     // bytes of an x copy: 16 or 4
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int x_offset(const Geometry& g) {
  return g.kslice * kQPitch;
}

// Shared memory: the q slab and the x slab, which the k-lanes' register
// tiles overwrite once the sums are done.
__host__ __device__ inline int smem_bytes(const Geometry& g, int threads) {
  const int slabs = x_offset(g) + g.rows * g.kslice * 4;
  const int tiles = threads * kGroupRows * 4 * 4;
  return slabs > tiles ? slabs : tiles;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16, 8 or 4; both addresses aligned to it) from global to shared
// memory, asynchronously; with `valid` false nothing is read and dst is
// zeroed (a source size of 0).
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
}

// The four signed bytes of w as exact floats: byte b + 128 (the sign bit
// flipped) becomes the low mantissa byte of 2^23, and 2^23 + 128 comes
// off again.
__device__ __forceinline__ void widen(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One output quad (4 columns of one row), scaled by its scales `sv` and
// stored where it lies inside y.
__device__ __forceinline__ void store_y(float* __restrict__ y,
                                        const Geometry& g, int row, int col,
                                        float4 v, const float (&sv)[4]) {
  if (row >= g.N || col >= g.dout) return;
  float* dst = y + static_cast<size_t>(row) * g.dout + col;
  if ((g.dout & 3) == 0) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(v.x * sv[0], v.y * sv[1], v.z * sv[2], v.w * sv[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (col + c < g.dout) dst[c] = lane_of(v, c) * sv[c];
}

__global__ void __launch_bounds__(kMaxThreads)
int8_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, float* __restrict__ y,
                 float* __restrict__ work, int* __restrict__ cnt, Geometry g) {
  // The dynamic region starts on a 128-byte line after last_s. At 16
  // bytes past one, where the flag alone would put it, the widest products
  // run slower (tools/gemv_breakdown.py's smem_16).
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ bool last_s;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int tiles = ceil_div(g.dout, kTileN);
  int bid = blockIdx.x;  // (row block, tile, split), split fastest
  const int split = bid % g.splits;
  bid /= g.splits;
  const int tile = bid % tiles;
  const int rb = bid / tiles;
  const int k0 = split * g.kslice;
  const int kvalid = min(g.kslice, g.din - k0);
  const int c0 = tile * kTileN;
  const int r0 = rb * g.rows;

  unsigned char* qs = smem;                                 // [kslice][kQPitch]
  float* xs = reinterpret_cast<float*>(smem + x_offset(g));  // [rows][kslice]

  // The output quad this thread sums at the end, and its scales, loaded
  // now so that their latency hides under the slab's.
  const int outs = g.rows * kQuads;  // output quads of the block
  const bool mine = tid < outs;
  const int orow = tid / kQuads, ocol = c0 + 4 * (tid % kQuads);
  float sv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    sv[c] = mine && ocol + c < g.dout ? __ldg(s + ocol + c) : 0.f;

  // This thread: column quad `quad`, row group `rg`, k-lane `kl`.
  const int quad = tid % kQuads;
  const int kl = (tid / kQuads) % g.k_lanes;
  const int rg = tid / (kQuads * g.k_lanes);

  // Every copy of the slab, then one wait.
  if (g.q_vec == 1) {
    for (int e = tid; e < g.kslice * kTileN; e += threads) {
      const int r = e / kTileN, c = e % kTileN;
      const bool ok = r < kvalid && c0 + c < g.dout;
      const size_t at = static_cast<size_t>(k0 + r) * g.dout + c0 + c;
      qs[r * kQPitch + c] = static_cast<unsigned char>(ok ? q[at] : 0);
    }
  } else {
    const int per_row = kTileN / g.q_vec;
    for (int e = tid; e < g.kslice * per_row; e += threads) {
      const int r = e / per_row, c = (e % per_row) * g.q_vec;
      const bool ok = r < kvalid && c0 + c < g.dout;
      cp_async(qs + r * kQPitch + c,
               ok ? q + static_cast<size_t>(k0 + r) * g.dout + c0 + c : q,
               g.q_vec, ok);
    }
  }
  {
    const int per = g.x_vec / 4;  // floats a copy
    const int per_row = g.kslice / per;
    for (int e = tid; e < g.rows * per_row; e += threads) {
      const int r = e / per_row, k = (e % per_row) * per;
      const bool ok = r0 + r < g.N && k < kvalid;
      cp_async(xs + r * g.kslice + k,
               ok ? x + static_cast<size_t>(r0 + r) * g.din + k0 + k : x,
               g.x_vec, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  float acc[kGroupRows][4];
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int groups = ceil_div(kvalid, 4);
  const float* xrow = xs + rg * kGroupRows * g.kslice;
  for (int gi = kl; gi < groups; gi += g.k_lanes) {
    float4 xv[kGroupRows];
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r)
      xv[r] = *reinterpret_cast<const float4*>(xrow + r * g.kslice + 4 * gi);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(qs + (4 * gi + i) * kQPitch +
                                                4 * quad);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
      widen(w[i], f);
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        const float xi = lane_of(xv[r], i);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xi, f[c], acc[r][c]);
      }
    }
  }

  // The k-lanes' tiles, summed in k-lane order: one output quad a thread,
  // the loads of 8 k-lanes in flight before their additions.
  __syncthreads();  // every thread is done with the slabs
  float4* red = reinterpret_cast<float4*>(smem);  // [k_lanes][rows][kQuads]
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r)
    red[(kl * g.rows + rg * kGroupRows + r) * kQuads + quad] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mine) {
    for (int l0 = 0; l0 < g.k_lanes; l0 += kLaneChunk) {
      float4 v[kLaneChunk];
#pragma unroll
      for (int u = 0; u < kLaneChunk; ++u) v[u] = red[(l0 + u) * outs + tid];
#pragma unroll
      for (int u = 0; u < kLaneChunk; ++u)
        sum.x += v[u].x, sum.y += v[u].y, sum.z += v[u].z, sum.w += v[u].w;
    }
  }
  if (g.splits == 1) {
    if (mine) store_y(y, g, r0 + orow, ocol, sum, sv);
    return;
  }

  // This split's partial tile, then the count; the last split sums.
  const int ctr = rb * tiles + tile;
  float4* part = reinterpret_cast<float4*>(work) +
                 static_cast<size_t>(ctr) * g.splits * outs;
  if (mine) part[split * outs + tid] = sum;
  __threadfence();  // this block's partial is visible before its count
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&cnt[ctr], 1) == g.splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (mine) {
    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < g.splits; z0 += kSumChunk) {
      float4 v[kSumChunk];
#pragma unroll
      for (int u = 0; u < kSumChunk; ++u)
        v[u] = z0 + u < g.splits ? __ldcg(part + (z0 + u) * outs + tid)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kSumChunk; ++u)
        if (z0 + u < g.splits)
          tot.x += v[u].x, tot.y += v[u].y, tot.z += v[u].z, tot.w += v[u].w;
    }
    store_y(y, g, r0 + orow, ocol, tot, sv);
  }
  if (tid == 0) cnt[ctr] = 0;  // ready for the next launch
}

// The widest copy of q that dout allows: every row's tile columns start
// on a multiple of it.
int q_vec_for(int dout) {
  return dout % 16 == 0 ? 16 : dout % 8 == 0 ? 8 : dout % 4 == 0 ? 4 : 1;
}

}  // namespace

// The plan (rows .. x_vec, grid, threads, smem) is the wrapper's
// `int8_gemm_plan`; any other is refused:
//   - rows = min(32, N rounded up to 8);
//   - kslice a multiple of 32 up to 512, splits = ceil(din / kslice);
//   - k_lanes = min(256 / rows rounded down to a multiple of 8, kslice / 4),
//     threads = rows * k_lanes (8 column quads, rows / 8 row groups);
//   - q_vec the widest copy dout allows, q aligned to it; x_vec 16 exactly
//     where din % 4 == 0 and x is 16-byte aligned, else 4;
//   - grid = row blocks * tiles * splits; smem the slabs' (or the register
//     tiles') bytes.
// With splits > 1, `work` holds grid * rows * 32 float32 partials and `cnt`
// one zeroed int32 per (row block, tile), which the kernel leaves zeroed.
// Returns cudaGetLastError() after the one launch.
extern "C" int int8_gemm_launch(const void* x, const void* q, const void* s,
                                void* y, void* work, void* cnt, int N, int din,
                                int dout, int rows, int kslice, int splits,
                                int k_lanes, int q_vec, int x_vec, int grid,
                                int threads, int smem, void* stream) {
  if (N < 1 || din < 1 || dout < 1 ||
      static_cast<long long>(N) * din >= (1LL << 31) ||
      static_cast<long long>(din) * dout >= (1LL << 31) ||
      static_cast<long long>(N) * dout >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{N, din, dout, rows, kslice, splits, k_lanes, q_vec, x_vec};
  const int want_rows =
      N >= kMaxRows ? kMaxRows : ceil_div(N, kGroupRows) * kGroupRows;
  const int most_lanes =
      rows < kGroupRows ? 0 : kMaxThreads / rows / kLaneChunk * kLaneChunk;
  const int want_lanes = most_lanes < kslice / 4 ? most_lanes : kslice / 4;
  const bool x16 = din % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long blocks = static_cast<long long>(ceil_div(N, want_rows)) *
                           ceil_div(dout, kTileN) * splits;
  if (rows != want_rows || kslice < kSliceUnit || kslice > kMaxSlice ||
      kslice % kSliceUnit != 0 || splits != ceil_div(din, kslice) ||
      k_lanes != want_lanes || threads != rows * k_lanes ||
      q_vec != q_vec_for(dout) ||
      reinterpret_cast<uintptr_t>(q) % q_vec != 0 ||
      x_vec != (x16 ? 16 : 4) || grid != blocks ||
      smem != smem_bytes(g, threads) ||
      (splits > 1 && (work == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int8_gemm_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(y),
      static_cast<float*>(work), static_cast<int*>(cnt), g);
  return static_cast<int>(cudaGetLastError());
}
