// Paged single-token decode attention for Hopper (sm_90a).
//
// mv_paged_decode_attn replaces multiverso_tpu/ops/pallas_attention.py::
// paged_decode_attn (B7), the serving step's read of the paged KV pool.
// For each decode slot b and head h it attends this step's query
// q[b, h, :] over the slot's logical key positions r in [0, G * P), whose
// K and V rows live in physical page ptab[b, r / P] of ONE layer's pool at
// row r % P:
//
//   s_r   = (q . k_r) * scale + (valid(r) ? 0 : -1e30)
//   valid = r < lengths[b]  or  bucket <= r <= bucket + t[b]
//   o     = sum_r exp(s_r - m) v_r / sum_r exp(s_r - m)
//
// the TPU kernel's online softmax across pages (_paged_kernel,
// pallas_attention.py:201-245), with m starting at -1e30 (not -inf: a
// fully masked stretch before a valid key is wiped by
// alpha = exp(-1e30 - m) = 0, and -inf - -inf would give NaN). The
// output is normalised, o = acc / l, float32. Pages are float32, bfloat16
// or int8 and every operation is float32 (expf, no fast math, no tensor
// cores). An int8 page comes with its scale planes ks and vs, one float32
// a key or value row ([n_phys, heads, page, 1] of one layer): each element
// is dequantized as float(k8) * ks[row] before it enters the dot product,
// and as float(v8) * vs[row] before it enters the accumulator, which is
// the JAX step's decode_rows after its gather (serving/continuous.py:
// 448-454); the TPU kernel has no scale planes. Page-table entries are
// clamped into [0, n_phys) as the JAX
// step's mode="clip" gather does, so an idle slot whose row points at
// the garbage page 0 computes a finite row and never reads outside the
// pool.
//
// What bounds it on this card: bytes. The function needs the K and V row
// of each key the mask admits (a masked key adds exactly 0) for 4 * dh
// flops per key, about 0.5 flop per byte in float32, far below the
// card's ~20 flops per byte of float32 HBM balance. An int8 row is dh + 4
// bytes with its scale (68 at dh 64, against float32's 256). At the serving shape
// (8 slots, 12 heads, dh 64, page 16, G 36) the admitted keys of
// chip_smoke.py's serving inputs need 8.4 MB, ~2.5 us at 3.35 TB/s, out
// of the 28.3 MB that all G pages hold. There the kernel is bound by
// latency, not bytes: one slot holds 33 of the 91 live pages, and its
// CTAs' chain of start-up (the mask scalars and page-table row, then the
// first tiles), tiles and merge sets the time. At a long-context shape
// (8 slots of G 132, ~100 MB) it streams near the HBM rate.
//
// Design.
//   * Only live pages are read. Page j of slot b is live iff j * P <
//     lengths[b] or [j * P, j * P + P - 1] meets [bucket, bucket + t[b]]:
//     at most two runs of logical pages, [0, n1) and [s2, e2) (live_runs
//     below), computed by every CTA from lengths and t on the card, so the
//     launch needs no read on the host and can be captured in a CUDA
//     graph. A skipped page's table entry and rows are never read; a key
//     of a live page that the mask excludes still scores -1e30. Every
//     page a skipped page could have added is exactly 0: its scores are
//     q.k * scale - 1e30, whose exp underflows against any admitted
//     score, and the serving path always admits position `bucket`. Where
//     a slot admits no key at all (not reachable from the serving path),
//     the kernel reads all G pages, every score is -1e30 and the result
//     is the mean of V over all G * P rows, as the kernel before this one
//     and the TPU kernel give.
//   * A slot's live pages are split over `splits` CTAs of each (slot,
//     head) (flash-decoding): CTA s takes the contiguous live pages
//     [s * n / splits, (s + 1) * n / splits) of the slot's n, keeps a
//     partial (acc, m, l) and writes it to `part`. The last CTA of a
//     (slot, head) to finish, found by a ticket counter that it resets to
//     0 (so a launch captured in a CUDA graph replays), merges the
//     partials in split order into acc / l, each column loading 8
//     partials at a time. Float atomics never touch the values: two
//     launches are bitwise equal. The tickets (and the wrapper's scratch)
//     are one set per card: B7's launches on a card run in stream order,
//     as the serving path's do. The wrapper chooses `splits` from B * H
//     and G so that the grid makes PAGED_CTAS_PER_SM CTAs an SM
//     (ops/attention.py::paged_splits; 6 at the serving shape); the live
//     count of a slot is known only on the card, so a short slot's later
//     CTAs find no page and only take their ticket. A CTA covers one
//     head, not all heads of a page: the page's [H, P, dh] block is
//     contiguous too, but one head's [P, dh] block is already 4 KB of
//     16-byte loads, and a per-head CTA keeps 96 x splits CTAs at the
//     serving shape where a per-page CTA would have 8 x splits.
//   * Pages are staged in tiles of up to kTileBytes of K and as much of V
//     (one page's rows of one head at dh 64, page 16, float32) through a
//     ring of kRing tiles in shared memory, by 16-byte cp.async (float4,
//     or 8 bfloat16 values), so tiles i + 1 .. i + kRing - 1 arrive while
//     tile i is computed; the slot's page-table row sits in shared memory.
//     A head size whose rows are not whole 16-byte vectors, or a pool not
//     16-byte aligned, takes the narrow instance of the same kernel (one
//     value a vector; bfloat16 and int8 then copied by plain loads). An
//     int8 tile's rows (16 int8 values a vector: 4 loads a row at dh 64)
//     come with their K and V scales, staged by 4-byte cp.async into a
//     ring of their own in the same commit group, so a row's scale lands
//     with the row.
//   * Every lane works on the dot products: LK lanes hold one key row (at
//     dh 64 in float32, 8 lanes of two float4 each), so a warp scores
//     32 / LK keys at once, a CTA a page of 16 in one pass, and each score
//     is reduced in log2(LK) xor shuffles within its group. Each group
//     keeps its own online softmax (one expf a key, no divergence:
//     exp(s - m), or exp(m - s) where s is the new max) and p . V goes by
//     the same columns. The groups, then the warps, then the CTAs merge
//     (m, l, acc) in a fixed order.
// One wrapper call is one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 4;                // tiles in flight a CTA
constexpr int kTileBytes = 4096;        // K bytes of a tile (V as many)
constexpr int kMaxD = 256;
constexpr int kRowCap = 512;            // page-table entries kept in smem
constexpr int kMaxTickets = 1 << 16;    // (slot, head) pairs that can split
constexpr int kMaxScaleRows = 256;      // rows of an int8 tile (its scales)
constexpr float kNegInf = -1e30f;       // pallas_attention.py NEG_INF

static_assert(kWarps * (kMaxD + 2) * 4 <= kRing * 2 * kTileBytes,
              "the warps' merge reuses the ring");

// One ticket counter per (slot, head), zero when the module loads; the
// last CTA of a (slot, head) sets its counter back to 0.
__device__ int g_tickets[kMaxTickets];

// Phase marks: built with -DMV_PAGED_PROFILE (scripts/torch_paged_steps.py
// --phases), thread 0 of each of the first kProfCtas CTAs stores
// %globaltimer at its start (0), after its start-up loads (1), after its
// pages (2) and at its exit (3); mv_paged_decode_attn_profile reads them.
// Empty in the real build.
#ifdef MV_PAGED_PROFILE
constexpr int kProfCtas = 1 << 16;
__device__ unsigned long long g_prof[kProfCtas][4];
#define PROF_MARK(k)                                                   \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kProfCtas) {                  \
      unsigned long long ns;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));           \
      g_prof[blockIdx.x][k] = ns;                                      \
    }                                                                  \
  } while (0)
#else
#define PROF_MARK(k) \
  do {               \
  } while (0)
#endif

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// E values of type T from shared memory at p into x, as float32: one
// 16-byte load for the vector instances.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[E]) {
  if constexpr (E == 1) {
    x[0] = to_f(*p);
  } else if constexpr (sizeof(T) == 1) {
    static_assert(E == 16, "int8 vectors are 16 values");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = static_cast<float>(
            static_cast<int8_t>(static_cast<uint8_t>(w[i] >> (8 * j))));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(E == 4, "float32 vectors are float4");
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    static_assert(E == 8, "bfloat16 vectors are 8 values");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// One vector of BYTES bytes from global to shared memory: cp.async for 4
// and 16 bytes (landed after the next wait), a plain copy for 1 and 2.
template <int BYTES>
__device__ __forceinline__ void copy_vec(void* dst, const void* src) {
  if constexpr (BYTES == 1) {
    *static_cast<unsigned char*>(dst) =
        __ldg(static_cast<const unsigned char*>(src));
  } else if constexpr (BYTES == 2) {
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  } else {
    static_assert(BYTES == 4 || BYTES == 16, "cp.async takes 4 or 16");
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The live logical pages of a slot, as two runs [0, n1) and [s2, e2):
// the prompt's pages and the pages that meet [bucket, bucket + t]. Where
// no page is live, every page is taken (every score is then -1e30).
struct Live {
  int n1, s2, e2;
  __device__ __forceinline__ int count() const { return n1 + e2 - s2; }
  // The logical page of the k-th live page.
  __device__ __forceinline__ int page(int k) const {
    return k < n1 ? k : s2 + (k - n1);
  }
};

__device__ __forceinline__ Live live_runs(int length, int t, int bucket,
                                          int page, int n_pages) {
  const long long span = static_cast<long long>(n_pages) * page;
  long long len = length < 0 ? 0 : length;
  if (len > span) len = span;
  Live r;
  r.n1 = static_cast<int>((len + page - 1) / page);
  const long long lo = bucket < 0 ? 0 : bucket;
  long long hi = static_cast<long long>(bucket) + t;
  if (hi > span - 1) hi = span - 1;
  int a2 = 0, b2 = 0;
  if (lo <= hi) {
    a2 = static_cast<int>(lo / page);
    b2 = static_cast<int>(hi / page) + 1;
  }
  r.s2 = max(a2, r.n1);
  r.e2 = max(b2, r.s2);
  if (r.count() == 0) r.n1 = r.s2 = r.e2 = n_pages;
  return r;
}

// E: values a vector (16 bytes, or 1 value in the narrow instances); LK:
// lanes that hold one key row; NV: vectors a lane holds of a row.
template <typename T, int E, int LK, int NV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ ptab,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tstep, float* __restrict__ o,
                    float* __restrict__ part, int heads, int n_pages,
                    int page, int d, int64_t page_stride,
                    int64_t scale_stride, int n_phys, int bucket,
                    float scale, int splits, int tile_rows) {
  constexpr int GK = 32 / LK;                  // keys a warp scores at once
  constexpr int VB = E * static_cast<int>(sizeof(T));
  constexpr int kTileElems = kTileBytes / static_cast<int>(sizeof(T));
  // int8 pages: a tile's K and V row scales, in a ring of their own.
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kScaleRows = kQuant ? kMaxScaleRows : 1;
  __shared__ __align__(16) unsigned char ring_raw[kRing * 2 * kTileBytes];
  __shared__ __align__(16) float sring[kRing * 2 * kScaleRows];
  __shared__ int row[kRowCap];
  __shared__ int last;
  T* ring = reinterpret_cast<T*>(ring_raw);

  const int64_t bh = blockIdx.x / splits;
  const int split = static_cast<int>(blockIdx.x - bh * splits);
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh - static_cast<int64_t>(b) * heads);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % LK;
  const int grp = lane / LK;
  const int nvec = d / E;
  PROF_MARK(0);

  // The slot's mask scalars, its page-table row (into shared memory,
  // clamped; a row longer than kRowCap is read from global memory tile by
  // tile) and the lane's query columns are read together.
  const int length = lengths[b];
  const int t = tstep[b];
  const int* prow = ptab + static_cast<int64_t>(b) * n_pages;
  const bool row_s = n_pages <= kRowCap;
  if (row_s)
    for (int j = threadIdx.x; j < n_pages; j += kThreads)
      row[j] = min(max(prow[j], 0), n_phys - 1);
  float qr[NV][E];
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int v = li + LK * n;
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[n][e] = v < nvec ? q[bh * d + v * E + e] : 0.f;
  }
  const Live live = live_runs(length, t, bucket, page, n_pages);
  const int n_live = live.count();
  const int k0 = static_cast<int>(static_cast<int64_t>(split) * n_live /
                                  splits);
  const int k1 = static_cast<int>(static_cast<int64_t>(split + 1) * n_live /
                                  splits);
  const int tpp = (page + tile_rows - 1) / tile_rows;   // tiles a page
  const int n_tiles = (k1 - k0) * tpp;
  const int64_t head_off = static_cast<int64_t>(h) * page * d;
  __syncthreads();
  PROF_MARK(1);

  // Tile i into its ring slot: its live page's physical page (the table
  // entry, clamped), rows [r0, r0 + tile_rows) of it.
  auto issue = [&](int i) {
    const int j = live.page(k0 + i / tpp);
    const int phys = row_s ? row[j] : min(max(prow[j], 0), n_phys - 1);
    const int r0 = (i % tpp) * tile_rows;
    const int nr = min(tile_rows, page - r0);
    const int n = nr * nvec;
    const int64_t off = phys * page_stride + head_off +
                        static_cast<int64_t>(r0) * d;
    T* kd = ring + (i % kRing) * 2 * kTileElems;
    T* vd = kd + kTileElems;
    for (int v = threadIdx.x; v < n; v += kThreads) {
      copy_vec<VB>(kd + v * E, kp + off + v * E);
      copy_vec<VB>(vd + v * E, vp + off + v * E);
    }
    if constexpr (kQuant) {
      const int64_t soff = phys * scale_stride +
                           static_cast<int64_t>(h) * page + r0;
      float* ksd = sring + (i % kRing) * 2 * kScaleRows;
      for (int r = threadIdx.x; r < nr; r += kThreads) {
        copy_vec<4>(ksd + r, ks + soff + r);
        copy_vec<4>(ksd + kScaleRows + r, vs + soff + r);
      }
    }
  };

  float m = kNegInf;
  float l = 0.f;
  float acc[NV][E];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[n][e] = 0.f;

  // Prologue: the first kRing - 1 tiles.
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kRing - 2>();
    __syncthreads();        // tile i landed; every warp is done with i - 1
    const int nx = i + kRing - 1;
    if (nx < n_tiles) issue(nx);
    cp_async_commit();

    const int pi = i / tpp;
    const int r0 = (i - pi * tpp) * tile_rows;
    const int rows = min(tile_rows, page - r0);
    const int pos0 = live.page(k0 + pi) * page + r0;
    const T* kt = ring + (i % kRing) * 2 * kTileElems;
    const T* vt = kt + kTileElems;
    const float* kst = sring + (i % kRing) * 2 * kScaleRows;
    for (int kb = warp * GK; kb < rows; kb += kWarps * GK) {
      const int r = kb + grp;
      const bool valid = r < rows;
      // The row's scales (int8 pages; 1 and unread otherwise).
      float sk = 1.f, sv = 1.f;
      if constexpr (kQuant) {
        if (valid) {
          sk = kst[r];
          sv = kst[kScaleRows + r];
        }
      }
      // Two partial sums (even and odd vectors) halve the FMA chain.
      float sp[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int v = li + LK * n;
        if (valid && v < nvec) {
          float x[E];
          load_vec<T, E>(kt + r * d + v * E, x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if constexpr (kQuant) x[e] *= sk;
            sp[n & 1] = fmaf(qr[n][e], x[e], sp[n & 1]);
          }
        }
      }
      float s = sp[0] + sp[1];
#pragma unroll
      for (int off = LK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (!valid) continue;
      s *= scale;
      const int pos = pos0 + r;
      s += (pos < length || (pos >= bucket && pos <= bucket + t)) ? 0.f
                                                                  : kNegInf;
      // One expf a key and no divergence between the warp's groups: a new
      // max rescales the sums by exp(m - s) and weighs the key 1, any
      // other key weighs exp(s - m).
      const bool grows = s > m;
      const float e = expf(grows ? m - s : s - m);
      const float alpha = grows ? e : 1.f;
      const float p = grows ? 1.f : e;
      m = grows ? s : m;
      l = l * alpha + p;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int v = li + LK * n;
        if (v < nvec) {
          float x[E];
          load_vec<T, E>(vt + r * d + v * E, x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if constexpr (kQuant) x[e] *= sv;
            acc[n][e] = fmaf(p, x[e], acc[n][e] * alpha);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  PROF_MARK(2);

  // Merge the warp's groups (xor over the lane bits above LK), in order.
#pragma unroll
  for (int off = LK; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m2);
    const float a1 = expf(m - mx);
    const float a2 = expf(m2 - mx);
    l = l * a1 + l2 * a2;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = __shfl_xor_sync(0xffffffffu, acc[n][e], off);
        acc[n][e] = acc[n][e] * a1 + x * a2;
      }
    m = mx;
  }

  // Then the warps, through the ring's memory: (m, l, acc[d]) each.
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(ring_raw);
  float* wm = wacc + kWarps * d;
  float* wl = wm + kWarps;
  if (grp == 0) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = li + LK * n;
      if (v < nvec)
#pragma unroll
        for (int e = 0; e < E; ++e) wacc[warp * d + v * E + e] = acc[n][e];
    }
    if (li == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  __syncthreads();
  float mx = wm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wm[w]);
  float aw[kWarps];
  float sum_l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    aw[w] = expf(wm[w] - mx);
    sum_l += wl[w] * aw[w];
  }
  if (splits == 1) {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum_o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum_o += wacc[w * d + c] * aw[w];
      o[bh * d + c] = sum_o / sum_l;
    }
    PROF_MARK(3);
    return;
  }

  // Split: write this CTA's partial, take a ticket; the last CTA of the
  // (slot, head) merges every non-empty split's partial in split order.
  const int stride = d + 2;
  float* mine = part + (bh * splits + split) * stride;
  if (k1 > k0) {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum_o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum_o += wacc[w * d + c] * aw[w];
      mine[c] = sum_o;
    }
    if (threadIdx.x == 0) {
      mine[d] = mx;
      mine[d + 1] = sum_l;
    }
  }
  // As a cooperative grid barrier: the CTA's barrier, then one thread's
  // fence and atomic publish every thread's writes; the last CTA's fence
  // orders its reads of the partials after them.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&g_tickets[bh], 1) == splits - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) {
    PROF_MARK(3);
    return;
  }
  // Each column merges the splits in order, 8 at a time: their m, l and
  // the column's acc loaded together (a split with no page was never
  // written and is skipped), the running max and sums rescaled per 8.
  const float* all = part + bh * splits * stride;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float gm = kNegInf;
    float sum = 0.f;
    float sum_o = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float pm[8], pl[8], pa[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int sj = s0 + j;
        const bool some = sj < splits &&
                          static_cast<int64_t>(sj) * n_live / splits <
                              static_cast<int64_t>(sj + 1) * n_live / splits;
        const float* ps = all + sj * stride;
        pm[j] = some ? __ldcg(ps + d) : -INFINITY;
        pl[j] = some ? __ldcg(ps + d + 1) : 0.f;
        pa[j] = some ? __ldcg(ps + c) : 0.f;
      }
      float cm = gm;
#pragma unroll
      for (int j = 0; j < 8; ++j) cm = fmaxf(cm, pm[j]);
      const float r = expf(gm - cm);
      sum *= r;
      sum_o *= r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (pm[j] == -INFINITY) continue;
        const float a = expf(pm[j] - cm);
        sum += pl[j] * a;
        sum_o += pa[j] * a;
      }
      gm = cm;
    }
    o[bh * d + c] = sum_o / sum;
  }
  if (threadIdx.x == 0) g_tickets[bh] = 0;
  PROF_MARK(3);
}

template <typename T, int E, int LK, int NV>
int launch(const float* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* ptab, const int* lengths,
           const int* t, float* o, float* part, int64_t bh, int heads,
           int n_pages, int page, int d, int64_t page_stride,
           int64_t scale_stride, int n_phys, int bucket, float scale,
           int splits, cudaStream_t st) {
  const int row_bytes = d * static_cast<int>(sizeof(T));
  int tile_rows = min(page, max(1, kTileBytes / row_bytes));
  if (sizeof(T) == 1) tile_rows = min(tile_rows, kMaxScaleRows);
  const unsigned grid = static_cast<unsigned>(bh * splits);
  paged_decode_kernel<T, E, LK, NV><<<grid, kThreads, 0, st>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ks, vs, ptab,
      lengths, t, o, part, heads, n_pages, page, d, page_stride,
      scale_stride, n_phys, bucket, scale, splits, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

#define MV_PAGED_ARGS                                                     \
  q, kp, vp, ks, vs, ptab, lengths, t, o, part, bh, heads, n_pages, page,  \
      d, page_stride, scale_stride, n_phys, bucket, scale, splits, st

#define MV_PAGED_PARAMS                                                   \
  const float *q, const void *kp, const void *vp, const float *ks,         \
      const float *vs, const int *ptab, const int *lengths, const int *t,  \
      float *o, float *part, int64_t bh, int heads, int n_pages, int page, \
      int d, int64_t page_stride, int64_t scale_stride, int n_phys,        \
      int bucket, float scale, int splits, cudaStream_t st

// The vector instances: E values a 16-byte vector. A key row takes 8
// lanes (4 where it has 4 vectors or fewer), so a warp scores 4 keys at
// once and a CTA a page of 16 in one pass; a lane holds NV vectors. int8
// rows (E = 16) have at most 16 vectors at kMaxD.
template <typename T>
int dispatch_vec(MV_PAGED_PARAMS) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  if (nvec <= 4) return launch<T, E, 4, 1>(MV_PAGED_ARGS);
  if (nvec <= 8) return launch<T, E, 8, 1>(MV_PAGED_ARGS);
  if (nvec <= 16) return launch<T, E, 8, 2>(MV_PAGED_ARGS);
  if constexpr (E <= 8) {
    if (nvec <= 32) return launch<T, E, 8, 4>(MV_PAGED_ARGS);
  }
  if constexpr (E == 4) return launch<T, E, 8, 8>(MV_PAGED_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The narrow instances: one value a vector, 32 lanes a row.
template <typename T>
int dispatch_narrow(MV_PAGED_PARAMS) {
  if (d <= 32) return launch<T, 1, 32, 1>(MV_PAGED_ARGS);
  if (d <= 64) return launch<T, 1, 32, 2>(MV_PAGED_ARGS);
  if (d <= 128) return launch<T, 1, 32, 4>(MV_PAGED_ARGS);
  return launch<T, 1, 32, 8>(MV_PAGED_ARGS);
}

template <typename T>
int dispatch(MV_PAGED_PARAMS) {
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  const bool vec = row_bytes % 16 == 0 &&
                   (page_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  if (vec) return dispatch_vec<T>(MV_PAGED_ARGS);
  return dispatch_narrow<T>(MV_PAGED_ARGS);
}

#undef MV_PAGED_ARGS
#undef MV_PAGED_PARAMS

}  // namespace

#define MV_ENTRY_ARGS                                                     \
  q, kp, vp, ks, vs, ptab, lengths, t, o, part, bh, heads, n_pages, page,  \
      d, page_stride, scale_stride, n_phys, bucket, scale, splits, st

extern "C" {

// q [batch, heads, d] float32; kp and vp one layer of the page pool,
// [n_phys, heads, page, d] with rows of a page contiguous per head and
// page_stride elements between pages, float32 (kind 0), bfloat16 (kind 1)
// or int8 (kind 2); for int8, ks and vs the layer's scale planes,
// [n_phys, heads, page, 1] float32 with a page's rows contiguous per head
// and scale_stride elements between pages (unread otherwise); ptab
// [batch, n_pages], lengths and t [batch], int32. splits CTAs take each
// (slot, head); with splits > 1, part holds batch * heads * splits *
// (d + 2) floats of scratch. Writes o [batch, heads, d] float32. Returns
// cudaGetLastError() after the launch (0 = launched); shapes the kernel
// does not take return cudaErrorInvalidValue and launch nothing.
int mv_paged_decode_attn(const float* q, const void* kp, const void* vp,
                         const float* ks, const float* vs, const int* ptab,
                         const int* lengths, const int* t, float* o,
                         float* part, int batch, int heads, int n_pages,
                         int page, int d, int64_t page_stride,
                         int64_t scale_stride, int n_phys, int bucket,
                         float scale, int kind, int splits, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  if (n_pages <= 0 || page <= 0 || d <= 0 || d > kMaxD || n_phys <= 0 ||
      splits <= 0 || splits > n_pages || bh * splits > 0x7fffffffLL ||
      (splits > 1 && (part == nullptr || bh > kMaxTickets)) || kind < 0 ||
      kind > 2 ||
      (kind == 2 && (ks == nullptr || vs == nullptr || scale_stride <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 1)
    return dispatch<__nv_bfloat16>(MV_ENTRY_ARGS);
  if (kind == 2) return dispatch<int8_t>(MV_ENTRY_ARGS);
  return dispatch<float>(MV_ENTRY_ARGS);
}

#ifdef MV_PAGED_PROFILE
// The phase marks of the first n CTAs of the last launch, 4 each, into
// host memory.
int mv_paged_decode_attn_profile(unsigned long long* host, int n) {
  if (n < 0 || n > kProfCtas) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_prof, sizeof(unsigned long long) * 4 * n));
}
#endif

}  // extern "C"

#undef MV_ENTRY_ARGS
