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
// does not carry it over: it folds page after page into an online softmax
// held in registers (running max m, running sum l, output accumulator).
// That is 1-2 ulp off the exact softmax, inside the port's stated
// tolerances.
//
// What bounds it: bytes, and at the serving shapes latency. Per (slot, kv
// head) it reads the pages its rows can see once (keys and values, plus
// the int8 scales), does about 4*hd flops per (row, key) pair, and writes
// hd floats per row: far below the card's balance point. At decode (8
// slots, 2 kv heads, 80 pages of 16 int8 keys) a launch moves about 2 MB,
// under a microsecond at the HBM rate; what costs is the chain of
// dependent steps per page. The design (Flash-Decoding; vLLM's
// PagedAttention v2 partitions) is about that chain:
//   - the visible pages of each (slot, kv head) are split into contiguous
//     ranges, one block a range (`paged_attention_plan` picks the count so
//     the grid fills the card: 16 splits of 5 pages at decode), and a
//     block's rows are query rows that share the kv head (query head h
//     reads kv head h / (H / Hkv)), one warp a row, so a page staged in
//     shared memory serves every row of the group;
//   - a block loads its range of the block table into shared memory once
//     (this replaces the TPU's scalar prefetch) and double-buffers its
//     pages: page i + 1 is copied by `cp.async` in 16-byte (or 8-, 4-byte)
//     pieces, the int8 scales by 4-byte copies, while page i is folded
//     (deeper rings, up to 4 pages in flight, timed the same at decode);
//   - every lane works: the keys of a page are taken 16 at a time, each
//     key's dot product over 2 lanes (alternate d slices of 4, the last
//     hd % 4 columns by the first lane) summed by an xor-shuffle; a page
//     of more than 16 keys takes more passes, rows past the page read its
//     last key with p = 0; the p v sum gives each lane 2 of every 64
//     columns (one at an odd tail), the pass's p broadcast by shuffles
//     and its value rows loaded all at once before the sums (one key at a
//     time, behind a branch, each key's latency was exposed: about 2 us a
//     page on an H100 SXM at 700 W);
//   - any head dim: a block's lanes hold 256 output columns (8 each), so
//     above 256 the columns are split into chunks of 256, one block a
//     chunk, and each chunk's block computes the logits over the whole
//     head dim again (its key rows staged whole, its value rows only its
//     chunk's columns); where two pages do not fit in shared memory the
//     ring has one stage (the next page copied after the fold), and
//     where a pool row is not 4-byte aligned (bf16 at an odd hd, int8 at
//     hd % 4 != 0) the page copy is plain 2- or 1-byte loads in place of
//     `cp.async`;
//   - pages past the largest position of the block's rows are skipped:
//     masked keys contribute exactly 0 to the reference's softmax
//     (NEG_INF = -1e30), so skipping them changes nothing; a split that
//     sees no key writes m = -inf, l = 0;
//   - int8 pages: a key's scale multiplies its logit after the dot, a
//     value's scale multiplies its probability before the PV sum, the
//     reference's contract; bf16 pages are widened to float32 on use;
//   - the splits' float32 partials (m, l, acc) go to a scratch; the last
//     block of each (slot, kv head, row group) to finish (an int32 counter
//     per tile, after `__threadfence()`; it resets the counter) merges them
//     in split order (at most 16 splits, every load of the merge in
//     flight at once), so the output is the same bit for bit run to run.
//     A split with no visible key adds exactly nothing (its weight is 0,
//     never exp(-inf - -inf)). With one split the block writes the output
//     itself.
//
// Layouts (all contiguous): q (B, kk, H, hd) f32; k/v pages (P, ps, Hkv,
// hd) f32 | bf16 | int8; ks/vs (P, ps, Hkv, 1) f32 (int8 only); block
// table (B, npages) i32; positions (B, kk) i32; out (B, kk, H*hd) f32;
// part (B, kk, H, splits, chunks * ent) f32: (m, l, the chunk's acc) per
// split and chunk, ent = 2 + the chunk width rounded up to even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 256;         // output columns of a block (a chunk)
constexpr int kAcc = kCols / 32;   // a lane's output columns: 2 of each 64
constexpr int kMaxSplits = 16;     // the merge holds every split's m and l
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 226 * 1024;  // dynamic, below the static few bytes
constexpr int kKeys = 16;             // keys of a pass, 2 lanes a key
constexpr int kDP = 32 / kKeys;       // lanes of a key's dot product

// The wrapper's plan (`paged_attention_plan` in ops/paged_attention.py).
struct Geometry {
  int B, kk, H, Hkv, hd, ps, npages;
  int warps, row_groups, chunks, splits, pps, copy_bytes, stages;
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// A chunk's column count (the last may be narrower), and the width the
// scratch and the staged value rows give every chunk.
__host__ __device__ inline int chunk_width(const Geometry& g) {
  return g.hd < kCols ? g.hd : kCols;
}

// Bytes of a staged key or value row of n columns: rounded to 16 bytes,
// plus 16 (the lanes of a pass read rows 16 bytes apart in bank terms).
__host__ __device__ inline int row_ld(int n, int elem) {
  return round16(n * elem) + 16;
}

// One stage of the ring: a page of keys (whole rows), a page of values
// (the chunk's columns) and, for int8, their scales.
__host__ __device__ inline int stage_bytes(const Geometry& g, int elem,
                                           bool int8) {
  return round16(g.ps * (row_ld(g.hd, elem) + row_ld(chunk_width(g), elem)) +
                 (int8 ? 8 * g.ps : 0));
}

// The block table slice, the rows' q (rows of hd rounded up to 4), then
// the ring.
__host__ __device__ inline int ring_offset(const Geometry& g) {
  return round16(4 * g.pps) + 4 * g.warps * ((g.hd + 3) & ~3);
}

// A split's scratch entry: m, l and the chunk's columns, even in count.
__host__ __device__ inline int entry_floats(const Geometry& g) {
  return 2 + ((chunk_width(g) + 1) & ~1);
}

// Max and sum over the lanes that differ in the bits >= `from` of their
// index (from = lanes per key: the lanes of one key hold the same value).
__device__ __forceinline__ float keys_max(float v, int from) {
  for (int o = 16; o >= from; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float keys_sum(float v, int from) {
  for (int o = 16; o >= from; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16, 8 or 4; both addresses aligned to it) from global to
// shared memory, asynchronously; 2 or 1 bytes (a pool row that is not
// 4-byte aligned) by a plain load and store.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if (bytes == 2)
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  else if (bytes == 1)
    *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  else if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four (load4) or two (load2) neighbouring elements of a staged row as
// float32.
template <typename T>
__device__ __forceinline__ float4 load4(const unsigned char* p);
template <>
__device__ __forceinline__ float4 load4<float>(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const unsigned char* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <>
__device__ __forceinline__ float4 load4<int8_t>(const unsigned char* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

template <typename T>
__device__ __forceinline__ float load1(const unsigned char* p);
template <>
__device__ __forceinline__ float load1<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
template <>
__device__ __forceinline__ float load1<__nv_bfloat16>(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
template <>
__device__ __forceinline__ float load1<int8_t>(const unsigned char* p) {
  return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
}

template <typename T>
__device__ __forceinline__ float2 load2(const unsigned char* p);
template <>
__device__ __forceinline__ float2 load2<float>(const unsigned char* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <>
__device__ __forceinline__ float2 load2<int8_t>(const unsigned char* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

template <typename T, bool kInt8>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ positions, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counters, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int max_pos_s;
  __shared__ bool last_s;
  constexpr int elem = sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // (slot, kv head, row group, chunk, split), split fastest
  int bid = blockIdx.x;
  const int sp = bid % g.splits;
  bid /= g.splits;
  const int ch = bid % g.chunks;
  bid /= g.chunks;
  const int rg = bid % g.row_groups;
  bid /= g.row_groups;
  const int kvh = bid % g.Hkv;
  const int b = bid / g.Hkv;
  const int grp = g.H / g.Hkv;
  // Row r of the (grp*kk) rows of this kv head is query head kvh*grp +
  // r/kk at chunk position r%kk (the reference's g-major order).
  const int row = rg * g.warps + warp;
  const bool active = row < grp * g.kk;
  const int gi = active ? row / g.kk : 0;
  const int j = active ? row % g.kk : 0;
  const int h = kvh * grp + gi;
  // This block's output columns: [c0, c0 + ncols) of the head dim.
  const int c0 = ch * kCols;
  const int ncols = min(kCols, g.hd - c0);

  const int ldk = row_ld(g.hd, elem);
  const int ldv = row_ld(chunk_width(g), elem);
  const int qld = (g.hd + 3) & ~3;
  const int stage = stage_bytes(g, elem, kInt8);
  int* tbl_s = reinterpret_cast<int*>(smem);  // (pps,)
  float* q_s = reinterpret_cast<float*>(smem + round16(4 * g.pps));  // (warps, qld)
  unsigned char* ring = smem + ring_offset(g);
  auto k_at = [&](int st) { return ring + st * stage; };
  auto v_at = [&](int st) { return ring + st * stage + g.ps * ldk; };
  auto ks_at = [&](int st) {
    return reinterpret_cast<float*>(ring + st * stage + g.ps * (ldk + ldv));
  };
  auto vs_at = [&](int st) { return ks_at(st) + g.ps; };

  // The rows' positions and q, and this split's block-table entries, all
  // read at once.
  const int pos = active ? positions[b * g.kk + j] : -1;
  const float* qrow = q + ((static_cast<size_t>(b) * g.kk + j) * g.H + h) * g.hd;
  for (int d = lane; d < qld; d += 32)
    q_s[warp * qld + d] = active && d < g.hd ? qrow[d] : 0.f;
  const int p0 = sp * g.pps;
  for (int i = threadIdx.x; i < min(g.pps, g.npages - p0); i += blockDim.x)
    tbl_s[i] = table[b * g.npages + p0 + i];
  if (threadIdx.x == 0) max_pos_s = 0;
  __syncthreads();
  if (lane == 0 && active) atomicMax(&max_pos_s, pos);
  __syncthreads();
  // Pages any row of the block can see, and this split's share of them.
  const int n_vis = min(g.npages, max_pos_s / g.ps + 1);
  const int np = max(0, min(p0 + g.pps, n_vis) - p0);

  // Page i of the range into stage i % stages, as one commit group: its
  // key rows whole, its value rows' chunk columns.
  const int kcpr = g.hd * elem / g.copy_bytes;  // copies per key row
  const int vcpr = ncols * elem / g.copy_bytes;  // copies per value row
  auto fetch = [&](int i) {
    if (i < np) {
      const int st = i % g.stages;
      const size_t key0 = static_cast<size_t>(tbl_s[i]) * g.ps * g.Hkv + kvh;
      const auto* kb = reinterpret_cast<const unsigned char*>(kpool);
      const auto* vb = reinterpret_cast<const unsigned char*>(vpool);
      for (int e = threadIdx.x; e < g.ps * kcpr; e += blockDim.x) {
        const int r = e / kcpr, c = (e - r * kcpr) * g.copy_bytes;
        const size_t src = (key0 + static_cast<size_t>(r) * g.Hkv) * g.hd * elem + c;
        cp_async(k_at(st) + r * ldk + c, kb + src, g.copy_bytes);
      }
      for (int e = threadIdx.x; e < g.ps * vcpr; e += blockDim.x) {
        const int r = e / vcpr, c = (e - r * vcpr) * g.copy_bytes;
        const size_t src = (key0 + static_cast<size_t>(r) * g.Hkv) * g.hd * elem +
                           static_cast<size_t>(c0) * elem + c;
        cp_async(v_at(st) + r * ldv + c, vb + src, g.copy_bytes);
      }
      if (kInt8) {
        for (int r = threadIdx.x; r < g.ps; r += blockDim.x) {
          cp_async(ks_at(st) + r, kscale + key0 + static_cast<size_t>(r) * g.Hkv, 4);
          cp_async(vs_at(st) + r, vscale + key0 + static_cast<size_t>(r) * g.Hkv, 4);
        }
      }
    }
    cp_async_commit();
  };
  fetch(0);

  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(g.hd)));
  const int kr = lane / kDP, dp = lane - kr * kDP;
  const float* qw = q_s + warp * qld;
  const int hd4 = g.hd / 4;
  float m = -INFINITY;
  float l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.f;

  for (int i = 0; i < np; ++i) {
    cp_async_wait_all();  // page i of this thread's copies landed
    __syncthreads();      // every copy of page i landed; page i - 1 is folded
    if (g.stages > 1) fetch(i + 1);  // into page i - 1's stage
    const int st = i % g.stages;
    const unsigned char* ks = k_at(st);
    const unsigned char* vs = v_at(st);
    const int key0 = (p0 + i) * g.ps;
    for (int c = 0; c < g.ps && active; c += kKeys) {
      // Key r of the page (a row past the page reads the last: its p is 0).
      const int r = c + kr;
      const unsigned char* krow = ks + min(r, g.ps - 1) * ldk;
      float dot = 0.f;
#pragma unroll 8
      for (int d4 = dp; d4 < hd4; d4 += kDP) {
        const float4 kv = load4<T>(krow + d4 * 4 * elem);
        const float4 qv = *reinterpret_cast<const float4*>(qw + d4 * 4);
        dot += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
      if (dp == 0)
        for (int d = 4 * hd4; d < g.hd; ++d) dot += qw[d] * load1<T>(krow + d * elem);
#pragma unroll
      for (int o = kDP / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      const bool valid = r < g.ps && key0 + r <= pos;
      float logit = -INFINITY;
      if (valid) {
        logit = dot * scale;
        if (kInt8) logit *= ks_at(st)[r];
      }
      const float cmax = keys_max(logit, kDP);
      if (cmax == -INFINITY) continue;  // no key of this pass is visible
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      const float p = valid ? expf(logit - m_new) : 0.f;
      l = l * alpha + keys_sum(p, kDP);
#pragma unroll
      for (int t = 0; t < kAcc; ++t) acc[t] *= alpha;
      // p v: the pass's p broadcast and its value rows loaded all at once,
      // then summed in key order.
      float pv[kKeys];
#pragma unroll
      for (int rr = 0; rr < kKeys; ++rr) {
        pv[rr] = __shfl_sync(kFull, p, rr * kDP);
        if (kInt8) pv[rr] *= vs_at(st)[min(c + rr, g.ps - 1)];
      }
#pragma unroll
      for (int t = 0; t < kAcc / 2; ++t) {
        const int d = 2 * lane + 64 * t;
        if (d < ncols) {
          float2 vv[kKeys];
          if (d + 1 < ncols) {
#pragma unroll
            for (int rr = 0; rr < kKeys; ++rr)
              vv[rr] = load2<T>(vs + min(c + rr, g.ps - 1) * ldv + d * elem);
          } else {  // the odd last column
#pragma unroll
            for (int rr = 0; rr < kKeys; ++rr)
              vv[rr] = make_float2(
                  load1<T>(vs + min(c + rr, g.ps - 1) * ldv + d * elem), 0.f);
          }
#pragma unroll
          for (int rr = 0; rr < kKeys; ++rr) {
            acc[2 * t] += pv[rr] * vv[rr].x;
            acc[2 * t + 1] += pv[rr] * vv[rr].y;
          }
        }
      }
      m = m_new;
    }
    if (g.stages == 1) {  // the one stage is free once every row folded it
      __syncthreads();
      fetch(i + 1);
    }
  }
  cp_async_wait_all();

  // Columns d, d + 1 (d even) of a row of n columns at `dst`: one 8-byte
  // store where both exist and `dst + d` is 8-byte aligned.
  auto store2 = [](float* dst, int d, int n, bool aligned, float x, float y) {
    if (d + 1 < n && aligned) {
      *reinterpret_cast<float2*>(dst + d) = make_float2(x, y);
    } else {
      dst[d] = x;
      if (d + 1 < n) dst[d + 1] = y;
    }
  };
  const size_t orow = (static_cast<size_t>(b) * g.kk + j) * g.H + h;
  float* orow_p = out + orow * g.hd + c0;
  const bool oal = (g.hd & 1) == 0;  // orow * hd + c0 + d is even
  if (g.splits == 1) {
    if (!active) return;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int t = 0; t < kAcc / 2; ++t) {
      const int d = 2 * lane + 64 * t;
      if (d < ncols) store2(orow_p, d, ncols, oal, acc[2 * t] * inv, acc[2 * t + 1] * inv);
    }
    return;
  }

  // This split's partial: (m, l, acc) of each row, at (row, split, chunk).
  const int ent = entry_floats(g);
  auto entry = [&](int s) {
    return part + ((orow * g.splits + s) * g.chunks + ch) * ent;
  };
  if (active) {
    float* e = entry(sp);
    if (lane == 0) *reinterpret_cast<float2*>(e) = make_float2(m, l);
#pragma unroll
    for (int t = 0; t < kAcc / 2; ++t) {
      const int d = 2 * lane + 64 * t;
      if (d < ncols)
        *reinterpret_cast<float2*>(e + 2 + d) =
            make_float2(acc[2 * t], acc[2 * t + 1]);
    }
  }
  // The last split of this (slot, kv head, row group, chunk) merges, in
  // order.
  const int tile = ((b * g.Hkv + kvh) * g.row_groups + rg) * g.chunks + ch;
  __threadfence();  // this block's partials are visible before its count
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(&counters[tile], 1) == g.splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (active) {
    // Every split's (m, l), then the lane's columns of every split's acc,
    // all loads independent of one another; a split past the count or
    // with no visible key has weight 0 (never exp(-inf - -inf)); the sums
    // run in split order.
    float w[kMaxSplits], ls[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const float2 ml = s < g.splits
          ? __ldcg(reinterpret_cast<const float2*>(entry(s)))
          : make_float2(-INFINITY, 0.f);
      w[s] = ml.x, ls[s] = ml.y;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) mx = fmaxf(mx, w[s]);
    float lsum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      w[s] = w[s] == -INFINITY ? 0.f : expf(w[s] - mx);
      lsum += w[s] * ls[s];
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
#pragma unroll
    for (int t = 0; t < kAcc / 2; ++t) {
      const int d = 2 * lane + 64 * t;
      if (d >= ncols) continue;
      float2 a[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        a[s] = s < g.splits
            ? __ldcg(reinterpret_cast<const float2*>(entry(s) + 2 + d))
            : make_float2(0.f, 0.f);
      float ox = 0.f, oy = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        ox += w[s] * a[s].x;
        oy += w[s] * a[s].y;
      }
      store2(orow_p, d, ncols, oal, ox * inv, oy * inv);
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <typename T, bool kInt8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* table,
                   const void* positions, void* out, void* part,
                   void* counters, const Geometry& g, int grid, int threads,
                   int smem, cudaStream_t stream) {
  // The plan must be this kernel's own: its grid, one warp a row, the
  // column chunks, and the shared memory of its ring.
  const int rows = g.H / g.Hkv * g.kk;
  const int elem = static_cast<int>(sizeof(T));
  const int need = ring_offset(g) + g.stages * stage_bytes(g, elem, kInt8);
  const bool async = g.copy_bytes >= 4;
  if (g.warps < 1 || g.warps > 32 || g.row_groups != (rows + g.warps - 1) / g.warps ||
      g.chunks != (g.hd + kCols - 1) / kCols ||
      g.pps < 1 || g.splits != (g.npages + g.pps - 1) / g.pps ||
      g.splits > kMaxSplits || (g.stages != 1 && g.stages != 2) ||
      (g.copy_bytes != 16 && g.copy_bytes != 8 && g.copy_bytes != 4 &&
       g.copy_bytes != 2 && g.copy_bytes != 1) ||
      (g.hd * elem) % g.copy_bytes != 0 ||
      (!async && (g.hd * elem) % 4 == 0) ||  // cp.async where it can
      threads != 32 * g.warps ||
      grid != g.B * g.Hkv * g.row_groups * g.chunks * g.splits ||
      smem != need || smem > kMaxSmem ||
      (g.splits > 1 && (part == nullptr || counters == nullptr)) ||
      (kInt8 && (ks == nullptr || vs == nullptr))) {
    return cudaErrorInvalidValue;
  }
  auto kern = paged_attention_kernel<T, kInt8>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), g);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 pages, 1 = bfloat16 pages, 2 = int8 pages (+ scales).
// The plan (warps .. stages, grid, threads, smem) is the wrapper's
// `paged_attention_plan`; any other is refused. part and counters: the
// splits' scratch and one zeroed int32 counter per (slot, kv head, row
// group, chunk), both unused (may be null) with one split. Every pool
// pointer aligned to copy_bytes. Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* positions, void* out,
    void* part, void* counters, int B, int kk, int H, int Hkv, int hd, int ps,
    int npages, int dtype, int warps, int row_groups, int chunks, int splits,
    int pps, int copy_bytes, int stages, int grid, int threads, int smem,
    void* stream) {
  if (B < 1 || kk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 || ps < 1 ||
      npages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{B, kk, H, Hkv, hd, ps, npages, warps, row_groups, chunks,
                   splits, pps, copy_bytes, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float, false>(q, k, v, ks, vs, table, positions, out, part,
                                 counters, g, grid, threads, smem, s);
      break;
    case 1:
      err = launch<__nv_bfloat16, false>(q, k, v, ks, vs, table, positions,
                                         out, part, counters, g, grid, threads,
                                         smem, s);
      break;
    case 2:
      err = launch<int8_t, true>(q, k, v, ks, vs, table, positions, out, part,
                                 counters, g, grid, threads, smem, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
