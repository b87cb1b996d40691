// Direct 2-D convolution for Hopper (sm_90a), NHWC activations and HWIO
// weights, float32 or bfloat16 (dtype 0 or 1, x, w and y of one type):
//
//   y[n, oy, ox, o] = sum over (ky, kx, c) of
//                     xv[n, oy*stride + ky - pt, ox*stride + kx - pl, c]
//                     * wl[ky, kx, c, o]
//
// where xv is x (N, H, W, C) dilated by `dil` (dil - 1 zeros between
// neighbouring pixels, the transposed conv's lhs dilation) and read as 0
// outside it (padding by bounds check, never materialised), and wl is w
// (KH, KW, C, O), or with `flip` the spatially flipped, in/out-swapped
// weights of the forward conv whose input gradient this is:
// wl[ky, kx, c, o] = w[KH-1-ky, KW-1-kx, o, c] with w stored (KH, KW, O, C).
// The caller gives the output extent (OH, OW), which with the far-side
// padding fixes the geometry.
//
// Replaces the TPU kernel `_conv1_kernel` / `_conv1` of
// mpi_cuda_cnn_tpu/ops/pallas_ops.py:136-226, with the wrappers around it:
// `_phases` / `_conv_forward` (:229-261) for the forward of
// `conv2d_pallas` (:344) and the transposed conv of `_conv_bwd`
// (:355-387). The TPU version runs a stride-s conv as s*s stride-1 phase
// convs over padded, phase-sliced copies (a Mosaic workaround, :15-19) and
// the input gradient over an explicitly dilated and padded cotangent. Here
// stride, per-side padding, input dilation and the weight flip are
// arguments of one kernel, so a stride-2 forward is one launch, and the
// input gradient is one launch over the undilated cotangent whose
// dilation holes read as zero.
//
// What bounds it: at conv-bench's deep stride-1 shapes (128 x 32 x 32 x 64
// -> 64 and alike) operations, 9.7 GFLOP against 34 MB in bf16 (about
// 290 flops a byte, the card's balance point); at reference_cnn's batch-32
// shapes (at most 14.5 MFLOP, 118 KB) latency: a few dozen blocks, each a
// handful of K slices deep.
//
// The design: an implicit GEMM, M = N*OH*OW output pixels by O output
// channels over K = KH*KW*C, ordered tap-major (ky, kx, then c) as the TPU
// kernel's per-tap (BN*OH*OW, Cin) @ (Cin, Cout) contractions. One block
// of 128 threads owns a 128 x BN output tile (BN in 16..128, chosen by the
// wrapper's `conv_direct_plan`) and walks K in 64-byte slices (32 bf16 or
// 16 float32 values) through three shared-memory stages: slices k+1 and
// k+2 load while slice k is multiplied. Each thread computes the base
// (n, oy*stride - pt, ox*stride - pl) of the rows it gathers once, into
// registers, and steps its K column's (ky, kx, c) from slice to slice
// without a division; a padding or dilation hole reads as zero (zero-fill
// of cp.async, or a bounds check), so neither the padded nor the dilated
// input exists. The weight tile is read in place: HWIO rows [k][o], or
// for `flip` rows [o][k] of the (KH, KW, O, C) layout at
// [KH-1-ky, KW-1-kx, o, c]; `ldmatrix` with and without `.trans` reads the
// two layouts as the same operand.
//   - Loads: where C (and O, without flip) is a multiple of 16 bytes'
//     worth of elements and x and w are 16-byte aligned, 16-byte
//     `cp.async` copies (one tap per copy); otherwise (C = 1, 3, 6, ...)
//     an element-wise gather with the same masks. The wrapper picks.
//   - bf16: tiles stay bf16 in shared memory, rows padded by 16 bytes so
//     `ldmatrix` is free of bank conflicts; each warp owns 32 rows x BN
//     and runs `mma.sync` m16n8k16 with float32 accumulators (mma.cuh).
//   - float32: the same tiles and gather, an FMA mainloop on a register
//     tile of 8 rows x BN/8 columns a thread (TF32 stays off: the result
//     stays float32-accurate).
// The sum is rounded to the element type once at the store (the TPU
// kernel's float32 accumulator and `astype(o_ref.dtype)`).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128;      // output pixels (rows) of a block tile
constexpr int kThreads = 128;
constexpr int kStages = 3;    // K slices in shared memory: 2 loading, 1 in use

struct Geom {
  int N, H, W, C, O, KH, KW, OH, OW, stride, pt, pl, dil;
  int dil_shift;  // log2(dil) for a power of two, else -1
  int M, K;       // N*OH*OW, KH*KW*C
};

// Per element type: K slice depth (64 bytes of a row), elements of a
// 16-byte copy, and the 16-byte row padding of every shared tile.
template <typename T>
struct Cfg {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kBK = 4 * kVec;
  static constexpr int kPad = kVec;
};

struct Tap {
  int ky, kx, c;
};

__device__ __forceinline__ Tap decode(const Geom& g, int k) {
  const int tap = k / g.C;
  const int ky = tap / g.KW;
  return {ky, tap - ky * g.KW, k - tap * g.C};
}

// Moves tap t one K column on.
__device__ __forceinline__ void next_column(const Geom& g, Tap& t) {
  if (++t.c == g.C) {
    t.c = 0;
    if (++t.kx == g.KW) {
      t.kx = 0;
      ++t.ky;
    }
  }
}

// Element offset in x of tap t for the output row whose first image
// pixel is rb (n*H*W, -1 past M) and whose window starts at (ry, rx) of
// the dilated, padded input; -1 on padding, a dilation hole or past M.
__device__ __forceinline__ long long x_offset(const Geom& g, int rb, int ry,
                                              int rx, const Tap& t) {
  int vy = ry + t.ky, vx = rx + t.kx;
  if (rb < 0 || vy < 0 || vx < 0) return -1;
  if (g.dil > 1) {
    if (g.dil_shift > 0) {
      if ((vy | vx) & (g.dil - 1)) return -1;
      vy >>= g.dil_shift;
      vx >>= g.dil_shift;
    } else {
      if (vy % g.dil != 0 || vx % g.dil != 0) return -1;
      vy /= g.dil;
      vx /= g.dil;
    }
  }
  if (vy >= g.H || vx >= g.W) return -1;
  return (static_cast<long long>(rb) + vy * g.W + vx) * g.C + t.c;
}

// Offset of wl[ky, kx, c, o] in w: HWIO rows k = (ky, kx, c) of O, or for
// `flip` the (KH, KW, O, C) layout at [KH-1-ky, KW-1-kx, o, c].
__device__ __forceinline__ size_t w_offset(const Geom& g, bool flip, int k,
                                           const Tap& t, int o) {
  if (flip)
    return (static_cast<size_t>(g.KH * g.KW - 1 - (t.ky * g.KW + t.kx)) * g.O +
            o) * g.C + t.c;
  return static_cast<size_t>(k) * g.O + o;
}

template <typename T, int BN, bool FLIP>
struct Smem {
  using C = Cfg<T>;
  static constexpr int kLdA = C::kBK + C::kPad;
  static constexpr int kBRows = FLIP ? BN : C::kBK;
  static constexpr int kLdB = (FLIP ? C::kBK : BN) + C::kPad;
  T a[kStages][kBM][kLdA];     // [m][k]
  T b[kStages][kBRows][kLdB];  // [k][n], or [n][k] with FLIP
};

// One thread's share of the A (patch) and B (weight) tile loads. The
// geometry of the thread's output rows is computed once, into registers;
// slices are loaded in K order, and with VEC the thread's column advances
// one slice per load, so no slice decodes (ky, kx, c) by division.
//   VEC: 16-byte chunk q = tid % 4 of rows tid / 4 + 32 i (one tap a
//        chunk), and of the flipped weight rows tid / 4 + 32 j;
//   else: every column of row tid, element by element.
template <typename T, int BN, bool VEC, bool FLIP>
struct Loader {
  using C = Cfg<T>;
  static constexpr int kBK = C::kBK, kVec = C::kVec;
  static constexpr int kRows = VEC ? kBM / 32 : 1;
  int rb[kRows], ry[kRows], rx[kRows];
  int k;  // VEC: this thread's column of the next slice, and its tap t
  Tap t;

  __device__ __forceinline__ void init(const Geom& g, int m0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + (VEC ? (tid >> 2) + 32 * i : tid);
      rb[i] = -1;
      ry[i] = rx[i] = 0;
      if (m < g.M) {
        const int ox = m % g.OW;
        const int rest = m / g.OW;
        rb[i] = (rest / g.OH) * g.H * g.W;
        ry[i] = (rest % g.OH) * g.stride - g.pt;
        rx[i] = ox * g.stride - g.pl;
      }
    }
    k = VEC ? (tid & 3) * kVec : 0;
    t = k < g.K ? decode(g, k) : Tap{0, 0, 0};
  }

  // Stage slice [k0, k0 + kBK) into stage st.
  __device__ __forceinline__ void load(Smem<T, BN, FLIP>& sm, int st,
                                       const Geom& g, const T* __restrict__ x,
                                       const T* __restrict__ w, int k0,
                                       int n0) {
    const int tid = threadIdx.x;
    const T zero = from_f32<T>(0.f);
    if constexpr (VEC) {
      const int q = tid & 3;
      const bool kin = k < g.K;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long off = kin ? x_offset(g, rb[i], ry[i], rx[i], t) : -1;
        mma::cp_async16(&sm.a[st][(tid >> 2) + 32 * i][q * kVec],
                        off >= 0 ? x + off : x, off >= 0);
      }
      if constexpr (FLIP) {
        // chunk e = tid + 128 j has e % 4 == q: the same column as A's
        for (int e = tid; e < BN * 4; e += kThreads) {
          const int o = n0 + (e >> 2);
          const bool ok = kin && o < g.O;
          mma::cp_async16(&sm.b[st][e >> 2][q * kVec],
                          ok ? w + w_offset(g, true, k, t, o) : w, ok);
        }
      } else {
        constexpr int kRowChunks = BN / kVec;
        for (int e = tid; e < kBK * kRowChunks; e += kThreads) {
          const int kr = e / kRowChunks, nc = e - kr * kRowChunks;
          const int kk = k0 + kr, o = n0 + nc * kVec;
          const bool ok = kk < g.K && o < g.O;
          mma::cp_async16(&sm.b[st][kr][nc * kVec],
                          ok ? w + static_cast<size_t>(kk) * g.O + o : w, ok);
        }
      }
      k += kBK;
      t.c += kBK;
      while (t.c >= g.C) {
        t.c -= g.C;
        if (++t.kx == g.KW) {
          t.kx = 0;
          ++t.ky;
        }
      }
    } else {
      Tap u = k0 < g.K ? decode(g, k0) : Tap{0, 0, 0};
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const long long off =
            k0 + j < g.K ? x_offset(g, rb[0], ry[0], rx[0], u) : -1;
        sm.a[st][tid][j] = off >= 0 ? x[off] : zero;
        next_column(g, u);
      }
      for (int e = tid; e < kBK * BN; e += kThreads) {
        int kr, nr;
        if constexpr (FLIP) {
          nr = e / kBK;
          kr = e - nr * kBK;
        } else {
          kr = e / BN;
          nr = e - kr * BN;
        }
        const int kk = k0 + kr, o = n0 + nr;
        T v = zero;
        if (kk < g.K && o < g.O)
          v = w[w_offset(g, FLIP, kk, FLIP ? decode(g, kk) : Tap{0, 0, 0}, o)];
        if constexpr (FLIP)
          sm.b[st][nr][kr] = v;
        else
          sm.b[st][kr][nr] = v;
      }
    }
  }
};

template <typename T, int BN, bool VEC, bool FLIP>
__global__ void __launch_bounds__(kThreads)
    conv_direct_kernel(Geom g, const T* __restrict__ x,
                       const T* __restrict__ w, T* __restrict__ y) {
  using C = Cfg<T>;
  constexpr int kBK = C::kBK;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, BN, FLIP>& sm = *reinterpret_cast<Smem<T, BN, FLIP>*>(smem_raw);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  Loader<T, BN, VEC, FLIP> ld;
  ld.init(g, m0);

  // bf16: warp w owns rows 32 w .. 32 w + 31 (two m16 tiles) x BN.
  // float32: thread (ty, tx) owns rows ty + 16 i (i < 8), columns tx + 8 j.
  constexpr int kNT = BN / 8;
  constexpr int kMT = kBF16 ? 2 : 8;
  float acc[kMT][kNT][kBF16 ? 4 : 1];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < (kBF16 ? 4 : 1); ++e) acc[i][j][e] = 0.f;

  const int lane = tid & 31, warp = tid >> 5;
  const int nk = (g.K + kBK - 1) / kBK;
  // One commit group per slice (empty past the last), so that waiting
  // for all but the newest kStages - 2 groups means slice s has landed.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) ld.load(sm, s, g, x, w, s * kBK, n0);
    if constexpr (VEC) mma::cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    if constexpr (VEC) mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s landed; slice s - 1's stage is free again
    const int next = s + kStages - 1;
    if (next < nk) ld.load(sm, next % kStages, g, x, w, next * kBK, n0);
    if constexpr (VEC) mma::cp_async_commit();
    const int st = s % kStages;
    if constexpr (kBF16) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma::ldmatrix_x4(
              a[mt], &sm.a[st][32 * warp + 16 * mt + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t b[4];
          if constexpr (FLIP)
            mma::ldmatrix_x4(b, &sm.b[st][np * 16 + (lane & 7) + (lane >> 4) * 8]
                                       [kk + ((lane >> 3) & 1) * 8]);
          else
            mma::ldmatrix_x4_trans(
                b, &sm.b[st][kk + (lane & 15)][np * 16 + (lane >> 4) * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma::mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma::mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    } else {
      const int tx = tid & 7, ty = tid >> 3;
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[8], b[kNT];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.a[st][ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if constexpr (FLIP)
            b[j] = sm.b[st][tx + 8 * j][k];
          else
            b[j] = sm.b[st][k][tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            acc[i][j][0] = fmaf(a[i], b[j], acc[i][j][0]);
      }
    }
  }

  if constexpr (kBF16) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + nt * 8 + 2 * (lane & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + 32 * warp + 16 * mt + (lane >> 2) + 8 * half;
          if (m >= g.M) continue;
          T* yp = y + static_cast<size_t>(m) * g.O + col;
          if (col < g.O) yp[0] = from_f32<T>(acc[mt][nt][2 * half]);
          if (col + 1 < g.O) yp[1] = from_f32<T>(acc[mt][nt][2 * half + 1]);
        }
      }
  } else {
    const int tx = tid & 7, ty = tid >> 3;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int o = n0 + tx + 8 * j;
        if (o < g.O)
          y[static_cast<size_t>(m) * g.O + o] = from_f32<T>(acc[i][j][0]);
      }
    }
  }
}

template <typename T, int BN, bool VEC, bool FLIP>
cudaError_t run(const Geom& g, const T* x, const T* w, T* y, dim3 grid,
                cudaStream_t s) {
  constexpr size_t smem = sizeof(Smem<T, BN, FLIP>);
  auto kern = conv_direct_kernel<T, BN, VEC, FLIP>;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, s>>>(g, x, w, y);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_bn(const Geom& g, const void* x, const void* w, void* y,
                      int vec, int flip, dim3 grid, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec && flip) return run<T, BN, true, true>(g, xt, wt, yt, grid, s);
  if (vec) return run<T, BN, true, false>(g, xt, wt, yt, grid, s);
  if (flip) return run<T, BN, false, true>(g, xt, wt, yt, grid, s);
  return run<T, BN, false, false>(g, xt, wt, yt, grid, s);
}

template <typename T>
cudaError_t launch(const Geom& g, const void* x, const void* w, void* y,
                   int bn, int vec, int flip, dim3 grid, cudaStream_t s) {
  constexpr int kVec = Cfg<T>::kVec;
  if (vec && (g.C % kVec != 0 || (!flip && g.O % kVec != 0) ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return cudaErrorInvalidValue;
  switch (bn) {
    case 16: return launch_bn<T, 16>(g, x, w, y, vec, flip, grid, s);
    case 32: return launch_bn<T, 32>(g, x, w, y, vec, flip, grid, s);
    case 64: return launch_bn<T, 64>(g, x, w, y, vec, flip, grid, s);
    case 128:
      // float32 keeps 8 x BN/8 outputs a thread in registers: at most 64.
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_bn<T, 128>(g, x, w, y, vec, flip, grid, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The tile plan (bn, vec, grid_m, grid_n) comes from the wrapper's
// `conv_direct_plan`: a 128 x bn output tile a block, grid_m = ceil(M /
// 128) blocks over the output pixels and grid_n = ceil(O / bn) over the
// output channels; vec = 1 takes the 16-byte copies. A plan that does not
// tile the output exactly, or a vec the geometry or alignment does not
// allow, is refused. Returns cudaGetLastError() after the launch.
extern "C" int conv_direct_launch(const void* x, const void* w, void* y, int N,
                                  int H, int W, int C, int O, int KH, int KW,
                                  int OH, int OW, int stride, int pt, int pl,
                                  int dil, int flip, int bn, int vec,
                                  int grid_m, int grid_n, int dtype,
                                  void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      OH < 1 || OW < 1 || stride < 1 || dil < 1 || bn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(N) * OH * OW;
  const long long K = static_cast<long long>(KH) * KW * C;
  if (M > INT32_MAX - kBM || K > INT32_MAX - 64 ||
      static_cast<long long>(N) * H * W > INT32_MAX ||
      grid_m != (M + kBM - 1) / kBM || grid_n != (O + bn - 1) / bn ||
      grid_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dil_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if (dil == (1 << sh)) dil_shift = sh;
  const Geom g{N,  H,  W,      C,  O,   KH,        KW,
               OH, OW, stride, pt, pl,  dil,       dil_shift,
               static_cast<int>(M), static_cast<int>(K)};
  const dim3 grid(grid_m, grid_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kDtypeF32:
      err = launch<float>(g, x, w, y, bn, vec, flip, grid, s);
      break;
    case kDtypeBF16:
      err = launch<__nv_bfloat16>(g, x, w, y, bn, vec, flip, grid, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
