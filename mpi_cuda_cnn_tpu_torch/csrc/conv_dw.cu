// Convolution weight gradient for Hopper (sm_90a), NHWC / HWIO, float32
// or bfloat16 (dtype 0 or 1: x, g and dw of one type):
//
//   dw[ky, kx, c, o] = sum over pixels p = (n, oy, ox) of
//                      x[n, oy*stride + ky - pad, ox*stride + kx - pad, c]
//                      * g[n, oy, ox, o]
//
// with x (N, H, W, C) read as 0 outside its extent, the cotangent g
// (N, OH, OW, O) and dw (KH, KW, C, O): the transposed product
// dw (K, O) = P^T (K, M) @ g (M, O) of the forward's patch matrix P,
// summed over the M = N*OH*OW pixels.
//
// Replaces the TPU kernel `_conv1_dw_kernel` / `_conv1_dw` of
// mpi_cuda_cnn_tpu/ops/pallas_ops.py:264-319 with its wrapper `_conv_dw`
// (:322-341): there each (ky, kx) is a window^T @ g contraction
// accumulated across batch tiles in the output block, which the TPU's
// sequential grid allows, and a strided conv runs one such kernel per
// phase over padded, phase-sliced copies. Here the stride and padding are
// arguments (a stride-2 conv is one launch, no copies), and the pixel sum
// is split across blocks, whose float32 partials are summed in chunk
// order: no atomics on the values, so dw is the same, bit for bit, run to
// run. The sum is rounded to the element type once, the twin of
// `dw.astype(x.dtype)` (:341).
//
// What bounds it: at the presets' deep stride-1 layers (conv-bench's
// shapes at batch 128; 2*M*K*O operations, x and g read once, dw written
// once) the work of the forward: 9.66 / 4.83 / 4.83 GFLOP at 128 x 32 x 32
// x 64 -> 64, 128 x 16 x 16 x 64 -> 128, 128 x 8 x 8 x 128 -> 256, so
// about 0.144 / 0.072 / 0.072 ms of float32 FMA, and in bf16 0.0100 ms of
// bytes (33.5 MB of x and g) at the first and 0.0049 ms of tensor-core
// operations at the others. At reference_cnn's batch-32 shapes (6,272 or
// 1,568 pixels into 144 or 4,608 outputs, at most 14.5 MFLOP and 0.4 MB)
// both bounds are under 1 us: there latency and launches bound it.
//
// The design: the halo tile of K6 (conv_gemm.cu), transposed. A block of
// 128 threads owns an output tile of up to 9 taps x cs channels x BN
// output channels (bf16: 16 x 64; float32: 16 x 64 at the deep shapes, 4 x
// 32 at the narrow ones, all chosen by the wrapper's `conv_dw_plan`) and
// a chunk of pixel tiles. For each pixel tile (ni images x th x tw output
// pixels, at most 128) it loads, two tiles ahead in bf16 and one in
// float32, by 16-byte `cp.async` (zero-filled padding), the x halo under
// the tile ((stride (th - 1) + KH) x (stride (tw - 1) + KW) pixels x cs
// channels, each pixel row padded by 16 bytes) and the g tile (pixels x
// BN), then runs every tap's product from those two tiles: x and g are
// read from device memory once per pixel tile and output tile, and each x
// value serves all the taps that cover it. The tile's geometry is decoded
// into shared tables once, so no load divides; the tap loop is unrolled
// with no branch (a tile of fewer than 9 taps repeats its last one and
// drops the sums at the store), which lets each tap's operand loads
// overlap the previous tap's products.
//   - bf16: `mma.sync` m16n8k16 with float32 accumulators (mma.cuh). A =
//     x^T (16 channels x 16 pixels) by `ldmatrix.trans` of the halo's
//     tap-shifted pixel rows (each lane hands in the address of one pixel
//     row), B = g (16 pixels x 8 channels of O) by `ldmatrix.trans` of the
//     g tile; warp w owns output columns 16 w .. 16 w + 15 of every tap.
//   - float32: an FMA register tile over the same shared tiles, every tap
//     x 2 channels x 4 columns a thread (deep) or every tap x 1 x 1
//     (narrow), TF32 off.
//   - Loads: x where C is a multiple of a 16-byte chunk, g where O is, by
//     16-byte copies; otherwise (reference_cnn's conv1 has C = 1)
//     element-wise loads of the real channels into the same tiles, a few
//     in flight a thread, the padding zeroed once. The plan picks and
//     refuses a misaligned operand.
//   - The sum over pixel chunks: each chunk writes float32 partials; where
//     an output tile has few of them (reference_cnn's shapes), the last
//     block to finish the tile, which learns it from a counter in device
//     memory after `__threadfence()`, sums them in chunk order and resets
//     the counter: one launch. Otherwise (the deep shapes, where one block
//     would read megabytes) a second kernel sums every output's chunks in
//     the same order.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPixels = 128;  // output pixels of a pixel tile
constexpr int kMaxTaps = 9;   // taps of an output tile
constexpr int kSmemLimit = 232448;

struct Geom {
  int N, H, W, C, O, KH, KW, OH, OW, stride, pad;
  int ni, th, tw, hh, hw;      // pixel tile and its x halo
  int tiles_x, tiles_y, ntiles;
  int cs, nslices, nobl, taps;  // output tile: taps x cs x BN
  int tpc, nchunks, nout;       // pixel tiles a chunk, chunks, KH*KW*C*O
};

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T, int CS, int BN>
__host__ __device__ size_t stage_bytes(const Geom& g) {
  return sizeof(T) * (static_cast<size_t>(g.ni) * g.hh * g.hw * (CS + kVec<T>) +
                      static_cast<size_t>(kPixels) * (BN + kVec<T>));
}

// Pixel tiles in flight: bf16 loads two ahead of the one in use; float32,
// whose FMA tile takes far longer a tile, one.
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 3 : 2;

// Three int tables (each row's halo pixel, each row's (image, y, x) in the
// tile, each halo pixel's (image, y, x)), then kStages stages.
__host__ __device__ inline size_t tables_bytes(const Geom& g) {
  return sizeof(int) * (2 * kPixels + (g.ni * g.hh * g.hw + 3) / 4 * 4);
}

template <typename T, int CS, int BN>
size_t smem_bytes(const Geom& g) {
  return tables_bytes(g) + kStages<T> * stage_bytes<T, CS, BN>(g);
}

// (image, y, x) packed 8 : 12 : 12 bits, the fields of a tile (at most 128
// images, a halo at most 4095 pixels on a side).
__device__ __forceinline__ int pack3(int i, int y, int x) {
  return (i << 24) | (y << 12) | x;
}

constexpr int kBatch = 4;   // element-wise loads in flight a thread
constexpr int kUnroll = 8;  // chunks of partials loaded ahead of their sums
constexpr int kSums = 4;    // outputs a thread of the last block sums at once

// s[j] = sum over chunks ch = 0 .. n - 1, in that order, of
// part[ch * nout + idx[j]] for the NB outputs idx[j] >= 0: the loads of
// kUnroll chunks of every output are issued before their additions, so a
// thread keeps NB * kUnroll loads in flight.
template <int NB>
__device__ __forceinline__ void chunk_sums(const float* part, size_t nout,
                                           int n, const long long (&idx)[NB],
                                           float (&s)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j] = 0.f;
  int ch = 0;
  for (; ch + kUnroll <= n; ch += kUnroll) {
    float v[NB][kUnroll];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[j][u] = idx[j] >= 0 ? __ldcg(part + (ch + u) * nout + idx[j]) : 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[j] += v[j][u];
  }
  for (; ch < n; ++ch)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (idx[j] >= 0) s[j] += __ldcg(part + ch * nout + idx[j]);
}

// Per element type and tile: the output tile (CS channels x BN) and, for
// float32, a thread's share of it (RC channels x RO columns, every tap).
template <typename T, int CS, int BN, int RC, int RO>
__global__ void __launch_bounds__(kThreads)
    conv_dw_kernel(Geom g, const T* __restrict__ x, const T* __restrict__ gy,
                   float* __restrict__ part, int* __restrict__ cnt,
                   T* __restrict__ dw, int x_vec, int g_vec, int one_pass) {
  constexpr int kV = kVec<T>;
  constexpr int kLdH = CS + kV, kLdG = BN + kV;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kS = kStages<T>;
  int* pbt = reinterpret_cast<int*>(smem_raw);  // halo pixel of each row
  int* rinfo = pbt + kPixels;    // each row's pack3(image, y, x), or -1
  int* hinfo = rinfo + kPixels;  // each halo pixel's pack3(image, y, x)
  unsigned char* stages = smem_raw + tables_bytes(g);
  const size_t stage = stage_bytes<T, CS, BN>(g);
  const int halo_px = g.ni * g.hh * g.hw;
  auto halo_of = [&](int st) {
    return reinterpret_cast<T*>(stages + st * stage);
  };
  auto gt_of = [&](int st) {
    return reinterpret_cast<T(*)[kLdG]>(stages + st * stage +
                                        sizeof(T) * halo_px * kLdH);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int ot = blockIdx.y;
  const int obase = (ot % g.nobl) * BN;
  ot /= g.nobl;
  const int cbase = (ot % g.nslices) * CS;
  const int tap0 = (ot / g.nslices) * g.taps;
  const int tg = min(g.taps, g.KH * g.KW - tap0);
  const int per = g.th * g.tw, tile_px = g.ni * per;
  const int creal = min(CS, g.C - cbase), oreal = min(BN, g.O - obase);
  const T zero = from_f32<T>(0.f);

  // The element-wise loads write only this tile's real channels, columns
  // and rows: the rest of every stage in use is zeroed once here.
  if (!x_vec || !g_vec) {
    const size_t words = min(kS, g.tpc) * stage / 16;
    int4* z = reinterpret_cast<int4*>(stages);
    for (size_t i = tid; i < words; i += kThreads) z[i] = make_int4(0, 0, 0, 0);
  }
  // The tile's geometry, decoded once so that no load divides.
  for (int r = tid; r < kPixels; r += kThreads) {
    int base = 0, info = -1;
    if (r < tile_px) {
      const int i = r / per, rem = r - i * per;
      const int ty = rem / g.tw, tx = rem - ty * g.tw;
      base = (i * g.hh + ty * g.stride) * g.hw + tx * g.stride;
      info = pack3(i, ty, tx);
    }
    pbt[r] = base;
    rinfo[r] = info;
  }
  for (int p = tid; p < halo_px; p += kThreads) {
    const int plane = g.hh * g.hw;
    const int i = p / plane, rem = p - i * plane;
    const int hy = rem / g.hw;
    hinfo[p] = pack3(i, hy, rem - hy * g.hw);
  }
  // Halo shift of each tap of the tile. Every tile runs kMaxTaps taps, so
  // that no branch splits the unrolled tap loop; those past the kernel's
  // last tap repeat it, and their sums are dropped at the store.
  int toff[kMaxTaps];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    const int tap = min(tap0 + t, g.KH * g.KW - 1);
    const int ky = tap / g.KW;
    toff[t] = ky * g.hw + tap - ky * g.KW;
  }

  // Pixel tile `tile` into stage st: the x halo (cs channels from cbase)
  // and g's rows (BN channels from obase); padding, rows past the tile or
  // the output, and channels past C or O read as zero.
  auto load = [&](int st, int tile) {
    T* hs = halo_of(st);
    T(*gs)[kLdG] = gt_of(st);
    const int txt = tile % g.tiles_x;
    const int rest = tile / g.tiles_x;
    const int n0 = (rest / g.tiles_y) * g.ni;
    const int oy0 = (rest % g.tiles_y) * g.th, ox0 = txt * g.tw;
    const int iy0 = oy0 * g.stride - g.pad, ix0 = ox0 * g.stride - g.pad;
    // offset in x of halo pixel p, channel c, or -1 outside x
    auto x_at = [&](int p, int c) -> long long {
      const int info = hinfo[p];
      const int n = n0 + (info >> 24), iy = iy0 + ((info >> 12) & 4095),
                ix = ix0 + (info & 4095);
      if (n >= g.N || iy < 0 || iy >= g.H || ix < 0 || ix >= g.W || c >= g.C)
        return -1;
      return ((static_cast<long long>(n) * g.H + iy) * g.W + ix) * g.C + c;
    };
    // offset in g of tile row r, column o, or -1 past the tile or g
    auto g_at = [&](int r, int o) -> long long {
      const int info = rinfo[r];
      if (info < 0 || o >= g.O) return -1;
      const int n = n0 + (info >> 24), oy = oy0 + ((info >> 12) & 4095),
                ox = ox0 + (info & 4095);
      if (n >= g.N || oy >= g.OH || ox >= g.OW) return -1;
      return ((static_cast<long long>(n) * g.OH + oy) * g.OW + ox) * g.O + o;
    };
    if (x_vec) {
      constexpr int kHq = CS / kV;
      for (int e = tid; e < halo_px * kHq; e += kThreads) {
        const int p = e / kHq, q = e - p * kHq;
        const long long off = x_at(p, cbase + q * kV);
        mma::cp_async16(hs + p * kLdH + q * kV, off >= 0 ? x + off : x, off >= 0);
      }
    } else {
      const int total = halo_px * creal;
      for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
        T v[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          dst[u] = -1;
          if (e < total) {
            const int p = e / creal, cc = e - p * creal;
            const long long off = x_at(p, cbase + cc);
            dst[u] = p * kLdH + cc;
            v[u] = off >= 0 ? x[off] : zero;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (dst[u] >= 0) hs[dst[u]] = v[u];
      }
    }
    if (g_vec) {
      constexpr int kGq = BN / kV;
      for (int e = tid; e < kPixels * kGq; e += kThreads) {
        const int r = e / kGq, q = e - r * kGq;
        const long long off = g_at(r, obase + q * kV);
        mma::cp_async16(&gs[r][q * kV], off >= 0 ? gy + off : gy, off >= 0);
      }
    } else {
      const int total = tile_px * oreal;
      for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
        T v[kBatch];
        int rr[kBatch], qq[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          rr[u] = -1;
          if (e < total) {
            rr[u] = e / oreal;
            qq[u] = e - rr[u] * oreal;
            const long long off = g_at(rr[u], obase + qq[u]);
            v[u] = off >= 0 ? gy[off] : zero;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (rr[u] >= 0) gs[rr[u]][qq[u]] = v[u];
      }
    }
  };

  // bf16: per tap, two m16n8 accumulators (warp w's 16 columns of BN);
  // float32: per tap, RC channels x RO columns.
  constexpr int kA = kBF16 ? 2 : RC;
  constexpr int kB = kBF16 ? 4 : RO;
  float acc[kMaxTaps][kA][kB];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t)
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int b = 0; b < kB; ++b) acc[t][a][b] = 0.f;
  constexpr int kTC = CS / RC;  // float32: threads along the channels
  const int tc = tid % kTC, to = tid / kTC;

  const int t_begin = blockIdx.x * g.tpc;
  const int t_end = min(t_begin + g.tpc, g.ntiles);
  __syncthreads();  // the tables written, the stages cleared
  // One commit group per tile (empty past the last), so that waiting for
  // all but the newest kS - 2 groups means this tile has landed.
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (t_begin + s < t_end) load(s, t_begin + s);
    mma::cp_async_commit();
  }
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int st = (tile - t_begin) % kS;
    mma::cp_async_wait<kS - 2>();
    __syncthreads();  // this tile landed; the previous tile's stage is free
    if (tile + kS - 1 < t_end) load((st + kS - 1) % kS, tile + kS - 1);
    mma::cp_async_commit();
    const T* hs = halo_of(st);
    T(*gs)[kLdG] = gt_of(st);
    if constexpr (kBF16) {
      const int ksteps = (tile_px + 15) >> 4;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, &gs[16 * ks + (lane & 15)][16 * warp + (lane >> 4) * 8]);
        // lane l: row l % 8 of matrix l / 8, which holds pixels 16 ks +
        // 8 (l / 16) .. +7 at channels 8 ((l / 8) % 2) .. +7: transposed,
        // the A fragment (channels x pixels) of mma.m16n8k16
        const T* arow = hs + pbt[16 * ks + (lane & 7) + ((lane >> 4) << 3)] * kLdH +
                        ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t) {
          uint32_t a[4];
          mma::ldmatrix_x4_trans(a, arow + toff[t] * kLdH);
          mma::mma_bf16(acc[t][0], a, bf[0], bf[1]);
          mma::mma_bf16(acc[t][1], a, bf[2], bf[3]);
        }
      }
    } else {
      for (int q = 0; q < tile_px; ++q) {
        const T* hrow = hs + pbt[q] * kLdH + tc * RC;
        float gv[RO];
        if constexpr (RO == 4) {
          const float4 v = *reinterpret_cast<const float4*>(&gs[q][to * 4]);
          gv[0] = v.x;
          gv[1] = v.y;
          gv[2] = v.z;
          gv[3] = v.w;
        } else {
          gv[0] = gs[q][to];
        }
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t) {
          float xv[RC];
          if constexpr (RC == 2) {
            const float2 v = *reinterpret_cast<const float2*>(hrow + toff[t] * kLdH);
            xv[0] = v.x;
            xv[1] = v.y;
          } else {
            xv[0] = hrow[toff[t] * kLdH];
          }
#pragma unroll
          for (int a = 0; a < RC; ++a)
#pragma unroll
            for (int b = 0; b < RO; ++b)
              acc[t][a][b] = fmaf(xv[a], gv[b], acc[t][a][b]);
        }
      }
    }
  }

  // This chunk's sums: dw itself for one chunk, else float32 partials.
  float* mine = part + static_cast<size_t>(blockIdx.x) * g.nout;
  auto put = [&](int t, int c, int o, float v) {
    if (t >= tg || c >= g.C || o >= g.O) return;
    const size_t idx = (static_cast<size_t>(tap0 + t) * g.C + c) * g.O + o;
    if (g.nchunks == 1)
      dw[idx] = from_f32<T>(v);
    else
      mine[idx] = v;
  };
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if constexpr (kBF16) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put(t, cbase + (lane >> 2) + 8 * (e >> 1),
              obase + 16 * warp + 8 * j + 2 * (lane & 3) + (e & 1), acc[t][j][e]);
    } else {
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int b = 0; b < RO; ++b)
          put(t, cbase + tc * RC + a, obase + to * RO + b, acc[t][a][b]);
    }
  }
  if (g.nchunks == 1 || !one_pass) return;

  // One pass: the last block of this output tile sums its chunks.
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (tid == 0) pbt[0] = atomicAdd(&cnt[blockIdx.y], 1) == g.nchunks - 1;
  __syncthreads();
  if (!pbt[0]) return;
  __threadfence();
  const int real = tg * creal * oreal;
  for (int e0 = tid; e0 < real; e0 += kSums * kThreads) {
    long long idx[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
      const int e = e0 + j * kThreads;
      idx[j] = -1;
      if (e < real) {
        const int t = e / (creal * oreal), r = e - t * (creal * oreal);
        const int c = cbase + r / oreal, o = obase + r % oreal;
        idx[j] = (static_cast<long long>(tap0 + t) * g.C + c) * g.O + o;
      }
    }
    float sum[kSums];
    chunk_sums(part, g.nout, g.nchunks, idx, sum);
#pragma unroll
    for (int j = 0; j < kSums; ++j)
      if (idx[j] >= 0) dw[idx[j]] = from_f32<T>(sum[j]);
  }
  if (tid == 0) cnt[blockIdx.y] = 0;  // ready for the next launch
}

// Two passes: every output's chunks summed in chunk order.
template <typename T>
__global__ void __launch_bounds__(256)
    conv_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                          int nout, int nchunks) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const long long idx[1] = {e < nout ? e : -1};
  float sum[1];
  chunk_sums(part, nout, nchunks, idx, sum);
  if (e < nout) dw[e] = from_f32<T>(sum[0]);
}

template <typename T, int CS, int BN, int RC, int RO>
cudaError_t run(const Geom& g, const void* x, const void* gy, float* part,
                int* cnt, void* dw, int x_vec, int g_vec, int one_pass,
                cudaStream_t s) {
  const size_t smem = smem_bytes<T, CS, BN>(g);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  auto kern = conv_dw_kernel<T, CS, BN, RC, RO>;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(g.nchunks, (g.KH * g.KW + g.taps - 1) / g.taps * g.nslices * g.nobl);
  kern<<<grid, kThreads, smem, s>>>(g, static_cast<const T*>(x),
                                    static_cast<const T*>(gy), part, cnt,
                                    static_cast<T*>(dw), x_vec, g_vec, one_pass);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.nchunks == 1 || one_pass) return err;
  conv_dw_reduce_kernel<T><<<(g.nout + 255) / 256, 256, 0, s>>>(
      part, static_cast<T*>(dw), g.nout, g.nchunks);
  return cudaGetLastError();
}

}  // namespace

// The tile plan (ni, th, tw, cs, bn, x_vec, g_vec, tpc, nchunks, one_pass)
// comes from the wrapper's `conv_dw_plan`: pixel tiles of ni images x th x
// tw output pixels (at most 128), chunks of tpc of them (nchunks =
// ceil(tiles / tpc) blocks along x), and output tiles of up to 9 taps x cs
// channels x bn (bf16: 16 x 64; float32: 16 x 64 or 4 x 32) along y;
// x_vec = 1 copies x, g_vec = 1 copies g in 16-byte chunks. `part` holds
// nchunks * KH*KW*C*O float32 partials where nchunks > 1 (else it is not
// read and may be null); with one_pass, `cnt` holds one zeroed int a y
// block, which the kernel leaves zeroed. A plan that does not tile the
// pixels exactly, does not fit shared memory, or takes 16-byte copies the
// geometry or alignment does not allow, is refused. Returns
// cudaGetLastError() after the launch (or the second one).
extern "C" int conv_dw_launch(const void* x, const void* g, void* part,
                              void* cnt, void* dw, int N, int H, int W, int C,
                              int O, int KH, int KW, int OH, int OW,
                              int stride, int pad, int ni, int th, int tw,
                              int cs, int bn, int x_vec, int g_vec, int tpc,
                              int nchunks,
                              int one_pass, int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      OH < 1 || OW < 1 || stride < 1 || pad < 0 || ni < 1 || th < 1 ||
      tw < 1 || ni > N || th > OH || tw > OW || ni * th * tw > kPixels ||
      tpc < 1 || nchunks < 1 ||
      static_cast<long long>(N) * H * W >= (1LL << 31) ||
      static_cast<long long>(N) * OH * OW >= (1LL << 31) ||
      static_cast<long long>(KH) * KW * C * O >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (OW + tw - 1) / tw, tiles_y = (OH + th - 1) / th;
  const long long ntiles = static_cast<long long>((N + ni - 1) / ni) * tiles_y * tiles_x;
  const int nslices = (C + cs - 1) / cs, nobl = (O + bn - 1) / bn;
  const int taps = KH * KW < kMaxTaps ? KH * KW : kMaxTaps;
  const long long grid_y =
      static_cast<long long>((KH * KW + taps - 1) / taps) * nslices * nobl;
  if (ntiles >= (1LL << 31) || nchunks != (ntiles + tpc - 1) / tpc ||
      static_cast<long long>(stride) * (th - 1) + KH > 4095 ||
      static_cast<long long>(stride) * (tw - 1) + KW > 4095 ||
      grid_y > 65535 || (nchunks > 1 && part == nullptr) ||
      (nchunks > 1 && one_pass && cnt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv = dtype == kDtypeBF16 ? 8 : 4;
  if ((x_vec && (C % kv != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      (g_vec && (O % kv != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom geo{N,       H,       W,
                 C,       O,       KH,
                 KW,      OH,      OW,
                 stride,  pad,     ni,
                 th,      tw,      stride * (th - 1) + KH,
                 stride * (tw - 1) + KW,
                 tiles_x, tiles_y, static_cast<int>(ntiles),
                 cs,      nslices, nobl,
                 taps,    tpc,     nchunks,
                 KH * KW * C * O};
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeBF16 && cs == 16 && bn == 64)
    err = run<__nv_bfloat16, 16, 64, 1, 1>(geo, x, g, p, c, dw, x_vec, g_vec,
                                           one_pass, s);
  else if (dtype == kDtypeF32 && cs == 16 && bn == 64)
    err = run<float, 16, 64, 2, 4>(geo, x, g, p, c, dw, x_vec, g_vec,
                                   one_pass, s);
  else if (dtype == kDtypeF32 && cs == 4 && bn == 32)
    err = run<float, 4, 32, 1, 1>(geo, x, g, p, c, dw, x_vec, g_vec, one_pass,
                                  s);
  return static_cast<int>(err);
}
