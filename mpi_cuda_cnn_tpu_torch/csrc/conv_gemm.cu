// Stride-1 implicit-GEMM convolution for Hopper (sm_90a), NHWC activations
// and HWIO weights, float32 or bfloat16 (dtype 0 or 1; x, w and y of one
// type):
//
//   y (M, O) = P (M, K) @ W_flat (K, O),   M = N*OH*OW,  K = KH*KW*C,
//   P[m, (ky*KW + kx)*C + c] = x[n, oy + ky - pad, ox + kx - pad, c]
//
// where m = (n, oy, ox), x reads as 0 outside its extent, and W_flat is w
// (KH, KW, C, O) read in place as the (K, O) matrix it already is.
//
// Replaces the TPU kernel `_conv1_gemm_kernel` / `_conv1_gemm` of
// mpi_cuda_cnn_tpu/ops/pallas_conv_gemm.py:47-135 (pallas_call at :123)
// behind `conv2d_pallas_gemm` (:160-173). What carries over is the point
// of that design: the patch matrix P exists only on chip, so neither P nor
// a padded copy of x is ever written to device memory. What does not: the
// VMEM batch-tile budget (`_pick_gemm_batch_tile`, :89-111), which has no
// counterpart on this card, and the wrapper's `jnp.pad` and slice
// (:156-157): the halo load zero-fills instead.
//
// What bounds it, at the conv bench's stride-1 shapes (k3 s1 p1; x read
// once, w once, y written once; 2*M*K*O operations; 67 TFLOP/s float32
// without tensor cores, 989 TFLOP/s bf16, 3.35 TB/s):
//
//   N x H x W x C -> O          GFLOP   float32 bound    bf16 bound
//   128 x 32 x 32 x 3 -> 64      0.453  0.0105 ms bytes  0.0052 ms bytes
//   128 x 32 x 32 x 64 -> 64     9.664  0.1442 ms ops    0.0100 ms bytes
//   128 x 16 x 16 x 64 -> 128    4.832  0.0721 ms ops    0.0049 ms ops
//   128 x 8 x 8 x 128 -> 256     4.832  0.0721 ms ops    0.0049 ms ops
//
// The design: one halo tile. A block of 128 threads owns an output tile of
// ni images x th rows x tw columns (at most 128 pixels: four rows of 32 at
// 32 x 32, eight of 16 at 16 x 16, two whole images at 8 x 8) by BN output
// channels, all chosen by the wrapper's `conv_gemm_plan`. It loads the x
// window under that tile, (th + KH - 1) x (tw + KW - 1) pixels of each
// image, into shared memory once, cs channels at a time (the whole of C at
// the bench's shapes), with 16-byte `cp.async` copies whose zero-fill
// (source size 0) is the padding. Each pixel's channel row is padded by 16
// bytes, so that `ldmatrix` rows of neighbouring pixels fall in other
// banks. It then walks K one tap and kc channels (bf16: 32 where the
// slice allows, else 16; float32 up to 16) at a time: the rows of W_flat
// for that step stream through a 4-stage `cp.async` ring, and the step's
// A operand is the halo itself read at shifted addresses: row m of tap
// (ky, kx) is halo pixel (oy + ky, ox + kx), which each lane hands to
// `ldmatrix` (the Pallas kernel's concatenated window slices, done as
// addressing). So x is read from device memory once per tile and P is
// never stored, not even in shared memory. The output is stored as bf16
// pairs or float4 runs where O allows.
//   - bf16: `mma.sync` m16n8k16 with float32 accumulators (mma.cuh); warp
//     w owns tile rows 32 w .. 32 w + 31 by BN (64 or 128), B by
//     `ldmatrix.trans` of the [k][n] ring stage. C is padded with zeros to a multiple of 16
//     (at C = 3: 13 zero channels, a waste of MMA work at a shape bound by
//     bytes).
//   - float32: the same tiles, an FMA register tile of 8 rows x BN/8
//     columns a thread (BN 32 or 64), its A read as float4 along the channels of a halo
//     row and its B as float4 along a ring row (TF32 stays off: the result
//     stays float32-accurate). C is padded to a multiple of 4.
//   - Loads: x where C is a multiple of a 16-byte chunk, w where O is,
//     by 16-byte `cp.async` copies; otherwise (C = 1, 3, 6, ...)
//     element-wise loads of the real channels into the same tiles, a few
//     in flight a thread, the padding zeroed once. The plan picks and
//     refuses a misaligned operand.
// Products accumulate in float32 for either type, and the sum is rounded
// to the element type once at the store (the TPU kernel's
// `preferred_element_type=float32` and `astype(o_ref.dtype)`).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace {

constexpr int kRows = 128;     // output pixels of a tile
constexpr int kThreads = 128;
constexpr int kStages = 4;     // weight-ring stages: 3 loading, 1 in use
constexpr int kSmemLimit = 232448;
constexpr int kBatch = 4;      // element-wise loads in flight a thread

struct Geom {
  int N, H, W, C, O, KH, KW, OH, OW, pad;
  int ni, th, tw, hh, hw;  // tile and its halo (th + KH - 1, tw + KW - 1)
  int tiles_x, tiles_y;
  int cp, cs, kc;          // C padded, channels of a halo slice, of a step
};

// Elements of a 16-byte chunk: the copy width and every row's padding.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Weight rows a ring stage holds: the deepest step (bf16: two m16n8k16
// depths; float32: 16).
template <typename T>
constexpr int kStepRows = sizeof(T) == 2 ? 32 : 16;

template <typename T, int BN>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(T) * kStages * kStepRows<T> * (BN + kVec<T>);
}

template <typename T, int BN>
__host__ __device__ size_t smem_bytes(const Geom& g) {
  return ring_bytes<T, BN>() +
         sizeof(T) * static_cast<size_t>(g.ni) * g.hh * g.hw * (g.cs + kVec<T>);
}

// Halo pixel of tile row r at tap (0, 0), or 0 for a row past the tile
// (its output is dropped at the store).
__device__ __forceinline__ int halo_base(const Geom& g, int r) {
  const int per = g.th * g.tw;
  if (r >= g.ni * per) return 0;
  const int i = r / per, rem = r - i * per;
  const int ty = rem / g.tw;
  return (i * g.hh + ty) * g.hw + rem - ty * g.tw;
}

// Output pixel (n*OH + oy)*OW + ox of tile row r, or -1 past the tile or
// the output.
__device__ __forceinline__ int out_pixel(const Geom& g, int r, int n0, int oy0,
                                         int ox0) {
  const int per = g.th * g.tw;
  if (r >= g.ni * per) return -1;
  const int i = r / per, rem = r - i * per;
  const int ty = rem / g.tw;
  const int n = n0 + i, oy = oy0 + ty, ox = ox0 + rem - ty * g.tw;
  if (n >= g.N || oy >= g.OH || ox >= g.OW) return -1;
  return (n * g.OH + oy) * g.OW + ox;
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_gemm_kernel(Geom g, const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int x_vec, int w_vec) {
  constexpr int kV = kVec<T>;
  constexpr int kLdB = BN + kV;
  constexpr int kSR = kStepRows<T>;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T (*ring)[kSR][kLdB] = reinterpret_cast<T (*)[kSR][kLdB]>(smem_raw);
  T* halo = reinterpret_cast<T*>(smem_raw + ring_bytes<T, BN>());
  const int ldh = g.cs + kV;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int b = blockIdx.x;
  const int ox0 = (b % g.tiles_x) * g.tw;
  b /= g.tiles_x;
  const int oy0 = (b % g.tiles_y) * g.th;
  const int n0 = (b / g.tiles_y) * g.ni;
  const int col0 = blockIdx.y * BN;
  const int halo_px = g.ni * g.hh * g.hw;
  const int plane = g.hh * g.hw;
  const T zero = from_f32<T>(0.f);

  // The element-wise loads write only real channels and columns: the
  // rest of shared memory is zeroed once here (a weight row past C may
  // later hold a stale, finite weight: its halo channel is zero).
  if (!x_vec || !w_vec) {
    const size_t words = smem_bytes<T, BN>(g) / 16;
    for (size_t i = tid; i < words; i += kThreads)
      reinterpret_cast<int4*>(smem_raw)[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  }

  // Offset in x of halo pixel p, channel c, or -1 outside x.
  auto x_at = [&](int p, int c) -> long long {
    const int i = p / plane, rem = p - i * plane;
    const int hy = rem / g.hw;
    const int n = n0 + i, iy = oy0 - g.pad + hy,
              ix = ox0 - g.pad + rem - hy * g.hw;
    if (n >= g.N || iy < 0 || iy >= g.H || ix < 0 || ix >= g.W || c >= g.C)
      return -1;
    return ((static_cast<long long>(n) * g.H + iy) * g.W + ix) * g.C + c;
  };

  // Halo slice [cs0, cs0 + cs) of every pixel under the tile: 16-byte
  // copies, or kBatch element loads in flight a thread over the slice's
  // real channels (all of them after the first slice, whose zeros past C
  // the clear above wrote).
  auto load_halo = [&](int cs0) {
    if (x_vec) {
      const int nq = g.cs / kV;
      for (int e = tid; e < halo_px * nq; e += kThreads) {
        const int p = e / nq, q = e - p * nq;
        const long long off = x_at(p, cs0 + q * kV);
        mma::cp_async16(halo + p * ldh + q * kV, off >= 0 ? x + off : x, off >= 0);
      }
    } else {
      const int nc = cs0 == 0 ? min(g.cs, g.C) : g.cs;
      const int total = halo_px * nc;
      for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
        T v[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          dst[u] = -1;
          if (e < total) {
            const int p = e / nc, cc = e - p * nc;
            const long long off = x_at(p, cs0 + cc);
            dst[u] = p * ldh + cc;
            v[u] = off >= 0 ? x[off] : zero;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (dst[u] >= 0) halo[dst[u]] = v[u];
      }
    }
  };

  // Weight rows of step s of slice cs0 (tap s / (cs / kc), kc channels)
  // into ring stage st: 16-byte copies zero-filled past C and O, or
  // element loads of the rows before C and the columns before O.
  const int nck = g.cs / g.kc;
  auto load_w = [&](int st, int s, int cs0) {
    const int tap = s / nck;
    const int c0 = cs0 + (s - tap * nck) * g.kc;
    const size_t row0 = static_cast<size_t>(tap) * g.C + c0;
    if (w_vec) {
      constexpr int kRowChunks = BN / kV;
      for (int e = tid; e < g.kc * kRowChunks; e += kThreads) {
        const int kr = e / kRowChunks, nc = e - kr * kRowChunks;
        const int o = col0 + nc * kV;
        const bool ok = c0 + kr < g.C && o < g.O;
        mma::cp_async16(&ring[st][kr][nc * kV],
                        ok ? w + (row0 + kr) * g.O + o : w, ok);
      }
    } else {
      const int nr = min(g.kc, g.C - c0), ncol = min(BN, g.O - col0);
      const int total = nr > 0 ? nr * ncol : 0;
      for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
        T v[kBatch];
        int kr[kBatch], nn[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          kr[u] = -1;
          if (e < total) {
            kr[u] = e / ncol;
            nn[u] = e - kr[u] * ncol;
            v[u] = w[(row0 + kr[u]) * g.O + col0 + nn[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (kr[u] >= 0) ring[st][kr[u]][nn[u]] = v[u];
      }
    }
  };

  // bf16: warp w owns rows 32 w .. 32 w + 31 (two m16 tiles) x BN; lane
  // l's ldmatrix row of m-tile mt is 32 w + 16 mt + l % 16.
  // float32: thread (ty, tx) owns rows ty + 16 i (i < 8) and columns
  // 32 (j / 4) + 4 tx + j % 4 (j < BN / 8), so that the eight tx of a row
  // read one contiguous run of a ring row.
  constexpr int kNT = BN / 8;
  constexpr int kMT = kBF16 ? 2 : 8;
  float acc[kMT][kNT][kBF16 ? 4 : 1];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < (kBF16 ? 4 : 1); ++e) acc[i][j][e] = 0.f;
  const int tx = tid & 7, ty = tid >> 3;
  int pb[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
    pb[i] = halo_base(g, kBF16 ? 32 * warp + 16 * i + (lane & 15) : ty + 16 * i);

  const int steps = g.KH * g.KW * nck;
  for (int cs0 = 0; cs0 < g.cp; cs0 += g.cs) {
    __syncthreads();  // the previous slice's halo and ring are read
    load_halo(cs0);
    // One commit group per step (the halo in the first, empty groups past
    // the last), so that waiting for all but the newest kStages - 2
    // groups means step s has landed.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load_w(s, s, cs0);
      mma::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      mma::cp_async_wait<kStages - 2>();
      __syncthreads();  // step s landed; step s - 1's stage is free again
      const int next = s + kStages - 1;
      if (next < steps) load_w(next % kStages, next, cs0);
      mma::cp_async_commit();
      const int st = s % kStages;
      const int tap = s / nck;
      const int ky = tap / g.KW;
      const int toff = ky * g.hw + tap - ky * g.KW;  // halo shift of the tap
      const int c0 = (s - tap * nck) * g.kc;          // within the slice
      if constexpr (kBF16) {
        // one m16n8k16 depth: A from the halo at the tap's shift, B from
        // the ring stage
        auto mma_k16 = [&](int kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma::ldmatrix_x4(a[mt], halo + (pb[mt] + toff) * ldh + c0 + kk +
                                        (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < BN / 16; ++np) {
            uint32_t bf[4];
            mma::ldmatrix_x4_trans(
                bf, &ring[st][kk + (lane & 15)][np * 16 + (lane >> 4) * 8]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma::mma_bf16(acc[mt][2 * np], a[mt], bf[0], bf[1]);
              mma::mma_bf16(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
            }
          }
        };
        mma_k16(0);
        if (g.kc == 32) mma_k16(16);
      } else {
        // four channels: A as float4 along a halo row, B along ring rows
        auto fma_c4 = [&](int c4) {
          float av[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(
                halo + (pb[i] + toff) * ldh + c0 + c4);
            av[i][0] = v.x;
            av[i][1] = v.y;
            av[i][2] = v.z;
            av[i][3] = v.w;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float bv[kNT];
#pragma unroll
            for (int j4 = 0; j4 < kNT / 4; ++j4) {
              const float4 v = *reinterpret_cast<const float4*>(
                  &ring[st][c4 + kk][32 * j4 + 4 * tx]);
              bv[4 * j4] = v.x;
              bv[4 * j4 + 1] = v.y;
              bv[4 * j4 + 2] = v.z;
              bv[4 * j4 + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < kNT; ++j)
                acc[i][j][0] = fmaf(av[i][kk], bv[j], acc[i][j][0]);
          }
        };
        if (g.kc == 16) {  // the deep shapes' step, unrolled
#pragma unroll
          for (int c4 = 0; c4 < 16; c4 += 4) fma_c4(c4);
        } else {
          for (int c4 = 0; c4 < g.kc; c4 += 4) fma_c4(c4);
        }
      }
    }
  }

  if constexpr (kBF16) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = out_pixel(g, 32 * warp + 16 * mt + (lane >> 2) + 8 * half,
                                n0, oy0, ox0);
        if (m < 0) continue;
        T* yp = y + static_cast<size_t>(m) * g.O;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = col0 + nt * 8 + 2 * (lane & 3);
          if (col + 1 < g.O && (g.O & 1) == 0) {  // a 4-byte pair
            *reinterpret_cast<__nv_bfloat162*>(yp + col) = __floats2bfloat162_rn(
                acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          } else {
            if (col < g.O) yp[col] = from_f32<T>(acc[mt][nt][2 * half]);
            if (col + 1 < g.O) yp[col + 1] = from_f32<T>(acc[mt][nt][2 * half + 1]);
          }
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = out_pixel(g, ty + 16 * i, n0, oy0, ox0);
      if (m < 0) continue;
      T* yp = y + static_cast<size_t>(m) * g.O;
#pragma unroll
      for (int j4 = 0; j4 < kNT / 4; ++j4) {
        const int col = col0 + 32 * j4 + 4 * tx;
        if (col + 3 < g.O && (g.O & 3) == 0) {  // a 16-byte run
          *reinterpret_cast<float4*>(yp + col) =
              make_float4(acc[i][4 * j4][0], acc[i][4 * j4 + 1][0],
                          acc[i][4 * j4 + 2][0], acc[i][4 * j4 + 3][0]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < g.O) yp[col + e] = from_f32<T>(acc[i][4 * j4 + e][0]);
        }
      }
    }
  }
}

template <typename T, int BN>
cudaError_t run(const Geom& g, const void* x, const void* w, void* y,
                int x_vec, int w_vec, dim3 grid, cudaStream_t s) {
  const size_t smem = smem_bytes<T, BN>(g);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  auto kern = conv_gemm_kernel<T, BN>;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, s>>>(g, static_cast<const T*>(x),
                                    static_cast<const T*>(w), static_cast<T*>(y),
                                    x_vec, w_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Geom& g, const void* x, const void* w, void* y,
                   int bn, int x_vec, int w_vec, dim3 grid, cudaStream_t s) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kV = kVec<T>;
  const int unit = kBF16 ? 16 : 4;  // C padded to a multiple of this
  const bool kc_ok = kBF16 ? (g.kc == 16 || g.kc == 32)
                           : (g.kc == 4 || g.kc == 8 || g.kc == 16);
  if (g.cp != (g.C + unit - 1) / unit * unit || g.cs < 1 || g.cp % g.cs != 0 ||
      g.cs % unit != 0 || !kc_ok || g.cs % g.kc != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0 ||  // the vector stores
      (x_vec && (g.C % kV != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      (w_vec && (g.O % kV != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)))
    return cudaErrorInvalidValue;
  // float32 keeps 8 x BN/8 outputs a thread in registers: 32 or 64; bf16
  // 64 or 128 (its 32-wide instance spilled).
  if constexpr (kBF16) {
    if (bn == 64) return run<T, 64>(g, x, w, y, x_vec, w_vec, grid, s);
    if (bn == 128) return run<T, 128>(g, x, w, y, x_vec, w_vec, grid, s);
  } else {
    if (bn == 32) return run<T, 32>(g, x, w, y, x_vec, w_vec, grid, s);
    if (bn == 64) return run<T, 64>(g, x, w, y, x_vec, w_vec, grid, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// y (N, OH, OW, O) with OH = H + 2 pad - KH + 1, OW = W + 2 pad - KW + 1.
// The tile plan (ni, th, tw, bn, x_vec, w_vec, cs, kc, grid_m, grid_n)
// comes from the wrapper's `conv_gemm_plan`: an output tile of ni images x
// th x tw pixels (at most 128) x bn channels (bf16 64 or 128, float32 32
// or 64) a block, grid_m = ceil(N / ni) * ceil(OH / th) * ceil(OW / tw)
// blocks over the pixels and grid_n = ceil(O / bn) over the channels; the
// halo holds cs channels of C padded (bf16: to a multiple of 16, float32:
// of 4) and a step kc of them (bf16 16 or 32, float32 4, 8 or 16); x_vec
// = 1 copies x, w_vec = 1 copies w in 16-byte chunks; y must be 16-byte
// aligned. A plan that does not tile the output exactly, does not fit
// shared memory, or takes 16-byte copies the geometry or alignment does
// not allow, is refused. Returns cudaGetLastError() after the launch.
extern "C" int conv_gemm_launch(const void* x, const void* w, void* y, int N,
                                int H, int W, int C, int O, int KH, int KW,
                                int pad, int ni, int th, int tw, int bn,
                                int x_vec, int w_vec, int cs, int kc,
                                int grid_m, int grid_n, int dtype,
                                void* stream) {
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      pad < 0 || OH < 1 || OW < 1 || ni < 1 || th < 1 || tw < 1 || bn < 1 ||
      ni > N || th > OH || tw > OW || ni * th * tw > kRows ||
      static_cast<long long>(N) * OH * OW >= (1LL << 31) ||
      static_cast<long long>(N) * H * W >= (1LL << 31) ||
      static_cast<long long>(KH) * KW * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (OW + tw - 1) / tw, tiles_y = (OH + th - 1) / th;
  if (grid_m != static_cast<long long>((N + ni - 1) / ni) * tiles_y * tiles_x ||
      grid_n != (O + bn - 1) / bn || grid_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int unit = dtype == kDtypeBF16 ? 16 : 4;
  const Geom g{N,  H,  W,  C,       O,       KH,   KW, OH,
               OW, pad, ni, th,     tw,      th + KH - 1, tw + KW - 1,
               tiles_x, tiles_y, (C + unit - 1) / unit * unit, cs, kc};
  const dim3 grid(grid_m, grid_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kDtypeF32:
      err = launch<float>(g, x, w, y, bn, x_vec, w_vec, grid, s);
      break;
    case kDtypeBF16:
      err = launch<__nv_bfloat16>(g, x, w, y, bn, x_vec, w_vec, grid, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
