// Paged attention read for Hopper (sm_90a): one layer's attention output
// straight off the KV page pools, for a decode tick (kk = 1) or a prefill
// chunk (kk = chunk).
//
// Replaces the TPU kernel `_paged_kernel` / `paged_attend` of
// mpi_cuda_cnn_tpu/ops/pallas_paged_attention.py. That kernel keeps the
// whole (g*kk, L) float32 logits strip and the (L, hd) value rows of a
// (slot, kv head) in VMEM and takes an exact softmax at the last page. At
// the serving prefill shape (g*kk = 4*32 rows, L = 1280) the strip alone
// is 655 KB, far above a block's 227 KB of shared memory, so this kernel
// does not carry it over: it keeps one page of keys and values in shared
// memory at a time and folds it into an online softmax held in registers
// (running max m, running sum l, output accumulator). That is 1-2 ulp off
// the exact softmax, inside the port's stated tolerances.
//
// What bounds it: bytes. Per (slot, kv head) it reads the pages its rows
// can see once (keys and values, plus the int8 scales), does about 4*hd
// flops per (row, key) pair, and writes hd floats per row: far below the
// card's ~20 flop/byte float32 balance point at the serving shapes. At the
// model sizes served here every launch moves well under a megabyte, so a
// launch costs a few microseconds against a sub-microsecond byte bound:
// it is launch-bound. The design does what is cheap against that:
//   - grid (slot, kv head, row group): each block loads its own
//     block-table entries (this replaces the TPU's scalar prefetch) and
//     loops over pages inside the block (this replaces the sequential grid
//     axis);
//   - the rows of one block are query rows that share a kv head (query
//     head h reads kv head h / (H / Hkv)), so a page staged in shared
//     memory serves every row of the group; one warp owns one row;
//   - pages past the largest position of the block's rows are skipped:
//     masked keys contribute exactly 0 to the reference's softmax
//     (NEG_INF = -1e30), so skipping them changes nothing;
//   - int8 pages: a key's scale multiplies its logit after the dot, a
//     value's scale multiplies its probability before the PV sum, the
//     reference's contract; bf16 pages are widened to float32 on load.
// Making it fast (TMA page loads, several pages in flight, wgmma for the
// prefill chunk) is later work.
//
// Layouts (all contiguous): q (B, kk, H, hd) f32; k/v pages (P, ps, Hkv,
// hd) f32 | bf16 | int8; ks/vs (P, ps, Hkv, 1) f32 (int8 only); block
// table (B, npages) i32; positions (B, kk) i32; out (B, kk, H*hd) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, bool kInt8>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ positions, float* __restrict__ out, int kk,
    int H, int Hkv, int hd, int ps, int npages) {
  extern __shared__ float smem[];
  __shared__ int max_pos_s;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / Hkv;
  // Row r of the (g*kk) rows of this kv head is query head kvh*g + r/kk
  // at chunk position r%kk (the reference's g-major order).
  const int row = blockIdx.z * warps + warp;
  const bool active = row < g * kk;
  const int gi = active ? row / kk : 0;
  const int j = active ? row % kk : 0;
  const int h = kvh * g + gi;
  const int hdp = hd + 1;  // padded key rows: lanes read different keys

  float* q_s = smem;                  // (warps, hd)
  float* k_s = q_s + warps * hd;      // (ps, hd + 1)
  float* v_s = k_s + ps * hdp;        // (ps, hd)
  float* ks_s = v_s + ps * hd;        // (ps,)
  float* vs_s = ks_s + ps;            // (ps,)

  const int pos = active ? positions[b * kk + j] : -1;
  const float* qrow = q + ((static_cast<size_t>(b) * kk + j) * H + h) * hd;
  for (int d = lane; d < hd; d += 32) q_s[warp * hd + d] = active ? qrow[d] : 0.f;
  if (threadIdx.x == 0) max_pos_s = 0;
  __syncthreads();
  if (lane == 0 && active) atomicMax(&max_pos_s, pos);
  __syncthreads();
  const int n_pages = min(npages, max_pos_s / ps + 1);

  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const size_t key_stride = static_cast<size_t>(Hkv) * hd;
  float m = -INFINITY;
  float l = 0.f;
  float acc[kMaxHd / 32];
#pragma unroll
  for (int t = 0; t < kMaxHd / 32; ++t) acc[t] = 0.f;

  for (int i = 0; i < n_pages; ++i) {
    const int page = table[b * npages + i];
    __syncthreads();  // every warp is done with the previous page
    const size_t base = (static_cast<size_t>(page) * ps * Hkv + kvh) * hd;
    for (int e = threadIdx.x; e < ps * hd; e += blockDim.x) {
      const int r = e / hd;
      const int d = e - r * hd;
      k_s[r * hdp + d] = to_f32(kpool[base + r * key_stride + d]);
      v_s[r * hd + d] = to_f32(vpool[base + r * key_stride + d]);
    }
    if (kInt8) {
      for (int r = threadIdx.x; r < ps; r += blockDim.x) {
        const size_t si = (static_cast<size_t>(page) * ps + r) * Hkv + kvh;
        ks_s[r] = kscale[si];
        vs_s[r] = vscale[si];
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < ps; c += 32) {
      const int r = c + lane;
      const int key = i * ps + r;
      float logit = -INFINITY;
      if (r < ps && key <= pos) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += q_s[warp * hd + d] * k_s[r * hdp + d];
        logit = dot * scale;
        if (kInt8) logit *= ks_s[r];
      }
      const float cmax = warp_max(logit);
      if (cmax == -INFINITY) continue;  // the whole chunk is masked
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      const float p = (logit == -INFINITY) ? 0.f : expf(logit - m_new);
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int t = 0; t < kMaxHd / 32; ++t) acc[t] *= alpha;
      const int nr = min(32, ps - c);
      for (int rr = 0; rr < nr; ++rr) {
        float pr = __shfl_sync(kFull, p, rr);
        if (kInt8) pr *= vs_s[c + rr];
        const float* vrow = v_s + (c + rr) * hd;
#pragma unroll
        for (int t = 0; t < kMaxHd / 32; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) acc[t] += pr * vrow[d];
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float inv = 1.f / l;
  float* orow = out + ((static_cast<size_t>(b) * kk + j) * H + h) * hd;
#pragma unroll
  for (int t = 0; t < kMaxHd / 32; ++t) {
    const int d = lane + 32 * t;
    if (d < hd) orow[d] = acc[t] * inv;
  }
}

template <typename T, bool kInt8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* table,
                   const void* positions, void* out, int B, int kk, int H,
                   int Hkv, int hd, int ps, int npages, int warps,
                   cudaStream_t stream) {
  const int gkk = (H / Hkv) * kk;
  const dim3 grid(B, Hkv, (gkk + warps - 1) / warps);
  const dim3 block(32 * warps);
  const size_t smem =
      sizeof(float) * (warps * hd + ps * (hd + 1) + ps * hd + 2 * ps);
  auto kern = paged_attention_kernel<T, kInt8>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<float*>(out), kk, H,
      Hkv, hd, ps, npages);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 pages, 1 = bfloat16 pages, 2 = int8 pages (+ scales).
// warps: query rows per block (1..32). Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* table,
                                      const void* positions, void* out,
                                      int B, int kk, int H, int Hkv, int hd,
                                      int ps, int npages, int dtype,
                                      int warps, void* stream) {
  if (B < 1 || kk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 || hd > kMaxHd ||
      ps < 1 || npages < 1 || warps < 1 || warps > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float, false>(q, k, v, ks, vs, table, positions, out, B,
                                 kk, H, Hkv, hd, ps, npages, warps, s);
      break;
    case 1:
      err = launch<__nv_bfloat16, false>(q, k, v, ks, vs, table, positions,
                                         out, B, kk, H, Hkv, hd, ps, npages,
                                         warps, s);
      break;
    case 2:
      err = launch<int8_t, true>(q, k, v, ks, vs, table, positions, out, B,
                                 kk, H, Hkv, hd, ps, npages, warps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
