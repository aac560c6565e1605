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
// a key or value row ([n_phys, heads, page, 1] of one layer), the JAX
// step's decode_rows after its gather (serving/continuous.py:448-454;
// the TPU kernel has no scale planes): a row's scale is common to its
// whole dot product and to its whole V row, so it is applied once a key,
// s = (ks[row] * sum q . k8) * scale and p * vs[row] on V, where
// decode_rows multiplies every element (float rounding differs only).
// Page-table entries are
// clamped into [0, n_phys) as the JAX
// step's mode="clip" gather does, so an idle slot whose row points at
// the garbage page 0 computes a finite row and never reads outside the
// pool.
//
// What bounds it on this card: bytes. The function needs the K and V row
// of each key the mask admits (a masked key adds exactly 0) for 4 * dh
// flops per key, about 0.5 flop per byte in float32, far below the
// card's ~20 flops per byte of float32 HBM balance. An int8 row is dh + 4
// bytes with its scale (68 at dh 64, against float32's 256): 2 flops and
// a conversion a byte, still far below. At the serving shape
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
//     head) (flash-decoding) in whole tiles: of the slot's n live pages in
//     units of ppt (the last one may be short), u = ceil(n / ppt), CTA s
//     takes the units [s * u / splits, (s + 1) * u / splits)
//     (ops/attention.py::paged_split_pages), keeps a partial (acc, m, l)
//     and writes it to `part`. The last CTA of a
//     (slot, head) to finish, found by a ticket counter that it resets to
//     0 (so a launch captured in a CUDA graph replays), merges the
//     partials in split order into acc / l, each column loading 8
//     partials at a time. Float atomics never touch the values: two
//     launches are bitwise equal. The tickets (and the wrapper's scratch)
//     are one set per card: B7's launches on a card run in stream order,
//     as the serving path's do. The wrapper chooses `splits` from B * H
//     and the table's units (G / ppt) so that the grid makes
//     PAGED_CTAS_PER_SM CTAs an SM (ops/attention.py::paged_splits; 6 at
//     the serving shape, float32 and int8 alike); the live
//     count of a slot is known only on the card, so a short slot's later
//     CTAs find no page and only take their ticket. A CTA covers one
//     head, not all heads of a page: the page's [H, P, dh] block is
//     contiguous too, but one head's [P, dh] block is already 4 KB of
//     16-byte loads, and a per-head CTA keeps 96 x splits CTAs at the
//     serving shape where a per-page CTA would have 8 x splits.
//   * Pages are staged in tiles of up to kTileBytes of K and as much of V
//     through a ring of kRing tiles in shared memory, by 16-byte cp.async
//     (float4, 8 bfloat16 or 16 int8 values), so tiles i + 1 .. i + kRing
//     - 1 arrive while tile i is computed; the slot's page-table row sits
//     in shared memory. A tile is sized in bytes: for rows narrower than
//     float32's, where whole pages fit, it holds ppt of them
//     (ops/attention.py::paged_tile_pages): at dh 64 and pages of 16 two
//     of bfloat16 and four of int8, so the 1-byte rows keep as many bytes
//     in flight as float32's (a tile of one int8 page left a quarter of
//     them) and give every warp keys in every tile (a page of 16 keys
//     filled two of the four warps). Each page of a tile comes from its
//     own physical page (its page of a row or vector found by one
//     multiply-high, div_by), and each key's position from its own page,
//     so a tile may span the gap between the two live runs. A float32
//     tile stays one page, its page looked up once a tile as before: the
//     page lookups of the multi-page code cost float32 7-8% at the
//     serving shape, where one page of 16 rows of 64 already fills a
//     tile. Where no page fits, a page is several tiles. A head size whose
//     rows are not whole 16-byte vectors, or a pool not 16-byte aligned,
//     takes the narrow instance of the same kernel (one value a vector;
//     bfloat16 and int8 then copied by plain loads). An int8 tile's rows
//     come with their K and V scales, a page's 16 contiguous floats of
//     each plane as four 16-byte cp.async (4 bytes a row where a page's
//     scales are not whole aligned vectors: a page of 3, or a plane not
//     16-byte aligned) into a ring of their own in the same commit group,
//     so a row's scale lands with the row. int8 values become float32 by
//     a byte permute and a subtraction (exact; no int-to-float
//     conversion), and the sums of narrow rows are rescaled only when a
//     key raises the max (multiplying by alpha = 1 changes no bit). At
//     dh 64, 4 lanes a key row (two passes of 32 keys a tile) read faster
//     than 2 lanes (one pass of 64): 0.0114 against 0.0130 ms at the
//     serving shape and 0.0279 against 0.0338 at the long-context one, in
//     a CUDA graph on one H100 in one run (PERF.md).
//   * Every lane works on the dot products: LK lanes hold one key row (at
//     dh 64 in float32, 8 lanes of two float4 each; in int8, 4 lanes of
//     one 16-byte vector), so a warp scores 32 / LK keys at once, a CTA
//     16 (float32) or 32 (int8) a pass, and each score is reduced in
//     log2(LK) xor shuffles within its group. Each group
//     keeps its own online softmax (one expf a key, no divergence:
//     exp(s - m), or exp(m - s) where s is the new max) and p . V goes by
//     the same columns. The groups, then the warps, then the CTAs merge
//     (m, l, acc) in a fixed order.
//   * A head of kMaxD < d <= kMaxWideD (257-512 columns) takes the wide
//     instances (paged_wide_kernel), the same design at wider rows: one
//     CTA of a (slot, head, split) scores each live key once over the
//     whole row, and O's columns are split over the lanes that hold the
//     row. A row is 1,028-2,048 bytes in float32, so the tiles are larger
//     (WideRing): float32 tiles of up to 12 KB of K rows (and as many of
//     V) in a ring of 4, bfloat16 and int8 tiles of up to 10 KB in a ring
//     of 3, whole pages where they fit (int8 at dh 320: 2 pages of 16
//     rows), else a page in ceil(page bytes / tile bytes) tiles of equal
//     rows (float32 at dh 320: 2 tiles of 8 rows; at dh 512 3 of 6, 6 and
//     4). The ring lives in dynamic shared memory: float32 98,304 bytes
//     and 2,064 static, 2 CTAs an SM (192 KB of ring an SM); bfloat16
//     61,440, int8 62,592 with its scales' ring, 3 CTAs an SM (180 KB),
//     the occupancy calculator's counts (chip_smoke.py prints them),
//     against the tiled instance's 4 x 32 KB at dh 64. The 1- and 2-byte
//     rows take the smaller ring for more warps: a byte of them costs
//     more instructions (a byte permute and a subtraction a value for
//     int8) than a byte of float32, and 3 CTAs an SM read them 11-20%
//     faster, float32 up to 9% slower (PERF.md, run I2); __launch_bounds__
//     holds each instance to its ring's CTAs an SM. 16 lanes hold a key
//     row (a warp scores 2 keys at once, a CTA 8 a pass), each NV 16-byte
//     vectors: float32 5, 6 or 8 (dh <= 320, 384, 512), bfloat16 3 or 4
//     (dh <= 384, 512), int8 2 past dh 384, so a lane keeps at most 32
//     query values and 32 accumulator columns in registers; int8 up to dh
//     384 takes 8 lanes of 3 vectors (4 keys a warp; at dh 320, 20 of 24
//     vectors busy against 20 of 32 at 16 lanes: 17.5% faster at the
//     long-context shape, 168 registers, I3). Lanes past the row's last
//     vector add exact zeros (they load nothing). As in the
//     int8 instance, every page of a tile is found by a multiply-high,
//     every key's position from its own page, and the sums rescaled only
//     when a key raises the max; the int8 scale is applied once a key, a
//     page's scales copied by 16-byte cp.async where they are aligned
//     vectors. Rows that are not whole 16-byte vectors, or a pool off a
//     16-byte boundary, take the narrow-row wide instance: 32 lanes a
//     row, 16 values a lane. The splits count whole tiles
//     (ops/attention.py::paged_tile_pages), the merge scratch is d + 2
//     floats a split, as for the tiled instances, and the last CTA merges
//     up to 4 columns a thread at once (merge_wide: a column at a time
//     took 8-15 us at dh 320-512, against 3.6-4 us at dh 64, I2). The
//     tiled instances' code is untouched: the wide ones are a kernel of
//     their own.
//   * A head wider than kMaxWideD takes the column-chunked instance
//     (paged_decode_chunked_kernel): the output columns are split into
//     chunks of 256 over CTAs (gridDim.y), each of which scores every live
//     key over the whole row and keeps its own chunk's accumulator; a warp
//     scores one key at a time with its lanes striding over the row, read
//     from global memory; the live-page skip, the splits and the ticket
//     merge are the same, with one ticket and one (m, l) pair a chunk.
//     Every chunk's CTA computes the same scores in the same order.
//     Simple and right; not yet fast.
// One wrapper call is one launch. The entry point reports the instance
// that took it, and the wrapper counts its launches by that report.

#include <atomic>

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
// The wide instances (kMaxD < d <= kMaxWideD): their ring by page type
// (WideRing), the rows of an int8 tile's scales, and the output columns
// a thread merges.
constexpr int kMaxWideD = 512;
constexpr int kWideScaleRows = 48;
constexpr int kWideCols = kMaxWideD / kThreads;
// The instances, as mv_paged_decode_attn reports them: their indices in
// ops/attention.py::B7_INSTANCE_NAMES.
enum Instance {
  kInstTiled = 0,
  kInstWideVec = 1,
  kInstWideNarrow = 2,
  kInstChunked = 3
};

// A wide CTA's ring: kTiles tiles in flight, each kTileBytes of K rows
// (and as many of V). float32 keeps 4 of 12 KB (2 CTAs an SM); the 2- and
// 1-byte rows, which take more instructions a byte, 3 of 10 KB (3 CTAs an
// SM, 12 warps). kSmem: the dynamic shared memory of a CTA, the ring,
// then (int8) the ring of the rows' scales.
template <typename T>
struct WideRing {
  static constexpr int kTiles = sizeof(T) == 4 ? 4 : 3;
  static constexpr int kTileBytes = sizeof(T) == 4 ? 12288 : 10240;
  static constexpr int kCtasPerSm = sizeof(T) == 4 ? 2 : 3;
  static constexpr int kSmem =
      kTiles * 2 * kTileBytes +
      (sizeof(T) == 1 ? kTiles * 2 * kWideScaleRows * 4 : 0);
  static_assert(kWarps * (kMaxWideD + 2) * 4 <= kTiles * 2 * kTileBytes,
                "the wide warps' merge reuses the ring");
  static_assert(kTileBytes / (kMaxD + 1) <= kWideScaleRows,
                "an int8 wide tile's rows fit its scales' ring");
};

static_assert(kWarps * (kMaxD + 2) * 4 <= kRing * 2 * kTileBytes,
              "the warps' merge reuses the ring");
static_assert(kWideScaleRows % 4 == 0, "scales copy as 16-byte vectors");

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
    // Each byte b, biased to b + 128 (xor 0x80), becomes the low byte of
    // the float 2^23 + (b + 128) (one byte permute), and 2^23 + 128 is
    // taken away: exact, with no int-to-float conversion (a quarter-rate
    // instruction).
    static_assert(E == 16, "int8 vectors are 16 values");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                           raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] =
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | j)) -
            8388736.0f;
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

// floor(x / n) for 0 <= x, n < 2^16 as one multiply-high by
// div_mul(n): ceil(2^32 / n) leaves an error under x / 2^32 < 1 / n, so
// the floor is exact (n == 1 gives 0: x itself).
__device__ __forceinline__ uint32_t div_mul(int n) {
  return n > 1 ? 0xffffffffu / static_cast<uint32_t>(n) + 1u : 0u;
}
__device__ __forceinline__ int div_by(int x, uint32_t mul) {
  return mul ? static_cast<int>(__umulhi(static_cast<uint32_t>(x), mul)) : x;
}

// Tile i of a split that holds the live pages [p0, p1): rows [r0, r0 +
// nr) of each of its np live pages [first, first + np) (first counts the
// slot's live pages). Where whole pages fit a tile (tile_rows == page),
// a tile holds ppt of them; else (ppt == 1) a page is tpp tiles of up to
// tile_rows rows.
struct Tile {
  int first, np, r0, nr;
};

__device__ __forceinline__ Tile tile_of(int i, int p0, int p1, int ppt,
                                        int tpp, int tile_rows, int page) {
  const int u = i / tpp;
  Tile tl;
  tl.first = p0 + u * ppt;
  tl.np = min(ppt, p1 - tl.first);
  tl.r0 = (i - u * tpp) * tile_rows;
  tl.nr = min(tile_rows, page - tl.r0);
  return tl;
}

// The last CTA's merge of a (slot, head)'s split partials: each of the w
// columns merges the splits in order, 8 at a time: their m, l (at column
// ml of each partial's row, `stride` floats apart) and the column's acc
// loaded together (a split with no unit of work, of n_units split as the
// kernel splits them, was never written and is skipped), the running max
// and sums rescaled per 8; out[c] = acc / l.
__device__ __forceinline__ void merge_splits(const float* all, int stride,
                                             int ml, int w, int splits,
                                             int n_units, float* out) {
  for (int c = threadIdx.x; c < w; c += kThreads) {
    float gm = kNegInf;
    float sum = 0.f;
    float sum_o = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float pm[8], pl[8], pa[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int sj = s0 + j;
        const bool some = sj < splits &&
                          static_cast<int64_t>(sj) * n_units / splits <
                              static_cast<int64_t>(sj + 1) * n_units / splits;
        const float* ps = all + sj * stride;
        pm[j] = some ? __ldcg(ps + ml) : -INFINITY;
        pl[j] = some ? __ldcg(ps + ml + 1) : 0.f;
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
    out[c] = sum_o / sum;
  }
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
                    float scale, int splits, int tile_rows,
                    int tile_pages, int svec) {
  constexpr int GK = 32 / LK;                  // keys a warp scores at once
  constexpr int VB = E * static_cast<int>(sizeof(T));
  constexpr int kTileElems = kTileBytes / static_cast<int>(sizeof(T));
  // int8 pages: a tile's K and V row scales, in a ring of their own.
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kScaleRows = kQuant ? kMaxScaleRows : 1;
  // Rows narrower than float32's take tiles of several pages (ppt); a
  // float32 tile stays one page (or part of one), and its code the
  // single-page path with no page lookup a vector or a key.
  constexpr bool kMulti = sizeof(T) < 4;
  const int ppt = kMulti ? tile_pages : 1;
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
  // The split's share: whole units of ppt live pages (a unit is one tile
  // where pages fit it), so no tile crosses a split.
  const int n_units = (n_live + ppt - 1) / ppt;
  const int u0 = static_cast<int>(static_cast<int64_t>(split) * n_units /
                                  splits);
  const int u1 = static_cast<int>(static_cast<int64_t>(split + 1) * n_units /
                                  splits);
  const int p0 = min(u0 * ppt, n_live);
  const int p1 = min(u1 * ppt, n_live);
  const int tpp = (page + tile_rows - 1) / tile_rows;   // tiles a page
  const int n_tiles = (u1 - u0) * tpp;
  const int64_t head_off = static_cast<int64_t>(h) * page * d;
  // A tile of several pages holds whole pages (nr == page): which of its
  // pages a row, a vector of rows or a copy of scales falls in.
  const uint32_t row_div = div_mul(page);
  const uint32_t vec_div = div_mul(page * nvec);
  const uint32_t sc_div = div_mul(svec ? page / 4 : page);
  __syncthreads();
  PROF_MARK(1);

  // The physical page of the slot's k-th live page (the table entry,
  // clamped).
  auto phys_of = [&](int k) {
    const int j = live.page(k);
    return row_s ? row[j] : min(max(prow[j], 0), n_phys - 1);
  };

  // Tile i into its ring slot: page j of the tile (its own physical page)
  // at rows [j nr, j nr + nr) of the slot, the copies of all its pages
  // spread over the CTA's threads; its K and V scales (int8) by 16-byte
  // copies where svec (a page's scales are whole aligned vectors), else 4
  // bytes a row.
  auto issue = [&](int i) {
    const Tile tl = tile_of(i, p0, p1, ppt, tpp, tile_rows, page);
    const int per_page = tl.nr * nvec;          // vectors of a page's rows
    const int64_t row_off = head_off + static_cast<int64_t>(tl.r0) * d;
    T* kd = ring + (i % kRing) * 2 * kTileElems;
    if constexpr (kMulti) {
      for (int v = threadIdx.x; v < tl.np * per_page; v += kThreads) {
        const int j = tl.np > 1 ? div_by(v, vec_div) : 0;
        const int64_t off = phys_of(tl.first + j) * page_stride + row_off +
                            static_cast<int64_t>(v - j * per_page) * E;
        copy_vec<VB>(kd + v * E, kp + off);
        copy_vec<VB>(kd + kTileElems + v * E, vp + off);
      }
    } else {
      const int64_t off = phys_of(tl.first) * page_stride + row_off;
      for (int v = threadIdx.x; v < per_page; v += kThreads) {
        copy_vec<VB>(kd + v * E, kp + off + v * E);
        copy_vec<VB>(kd + kTileElems + v * E, vp + off + v * E);
      }
    }
    if constexpr (kQuant) {
      float* ksd = sring + (i % kRing) * 2 * kScaleRows;
      const int64_t s_off = static_cast<int64_t>(h) * page + tl.r0;
      const int per = svec ? tl.nr / 4 : tl.nr;  // copies of a page
      for (int v = threadIdx.x; v < tl.np * per; v += kThreads) {
        const int j = tl.np > 1 ? div_by(v, sc_div) : 0;
        const int c = v - j * per;
        const int64_t soff = phys_of(tl.first + j) * scale_stride + s_off;
        if (svec) {
          copy_vec<16>(ksd + 4 * v, ks + soff + 4 * c);
          copy_vec<16>(ksd + kScaleRows + 4 * v, vs + soff + 4 * c);
        } else {
          copy_vec<4>(ksd + v, ks + soff + c);
          copy_vec<4>(ksd + kScaleRows + v, vs + soff + c);
        }
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

    const Tile tl = tile_of(i, p0, p1, ppt, tpp, tile_rows, page);
    const int rows = tl.np * tl.nr;
    const int pos0 = live.page(tl.first) * page + tl.r0;
    const T* kt = ring + (i % kRing) * 2 * kTileElems;
    const T* vt = kt + kTileElems;
    const float* kst = sring + (i % kRing) * 2 * kScaleRows;
    for (int kb = warp * GK; kb < rows; kb += kWarps * GK) {
      const int r = kb + grp;
      const bool valid = r < rows;
      // The row's scales (int8 pages; 1 and unread otherwise), applied
      // once: to the key's score and to its weight p on V.
      float sk = 1.f, sv = 1.f;
      if constexpr (kQuant) {
        if (valid) {
          sk = kst[r];
          sv = kst[kScaleRows + r];
        }
      }
      // Two partial sums halve the FMA chain: even and odd vectors, or
      // for int8 (one vector of 16 a lane) even and odd values.
      float sp[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int v = li + LK * n;
        if (valid && v < nvec) {
          float x[E];
          load_vec<T, E>(kt + r * d + v * E, x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int c = kQuant ? (e & 1) : (n & 1);
            sp[c] = fmaf(qr[n][e], x[e], sp[c]);
          }
        }
      }
      float s = sp[0] + sp[1];
#pragma unroll
      for (int off = LK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (!valid) continue;
      if constexpr (kQuant) s *= sk;
      s *= scale;
      // The key's position, from its own page of the tile.
      int pos = pos0 + r;
      if (kMulti && tl.np > 1) {
        const int j = div_by(r, row_div);
        pos = live.page(tl.first + j) * page + r - j * page;
      }
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
      const float pv = kQuant ? p * sv : p;
      if constexpr (kMulti) {
        // Narrow rows rescale the sums only when the max grows (alpha is
        // 1 else: the same bits as multiplying by it).
        if (grows) {
#pragma unroll
          for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[n][e] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int v = li + LK * n;
          if (v < nvec) {
            float x[E];
            load_vec<T, E>(vt + r * d + v * E, x);
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[n][e] = fmaf(pv, x[e], acc[n][e]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int v = li + LK * n;
          if (v < nvec) {
            float x[E];
            load_vec<T, E>(vt + r * d + v * E, x);
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[n][e] = fmaf(pv, x[e], acc[n][e] * alpha);
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
  if (u1 > u0) {
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
  merge_splits(part + bh * splits * stride, stride, d, d, splits, n_units,
               o + bh * d);
  if (threadIdx.x == 0) g_tickets[bh] = 0;
  PROF_MARK(3);
}

// The wide instances' merge of a (slot, head)'s split partials, as
// merge_splits merges them (each column the same operations in the same
// order), but a thread takes all of its columns (c, c + kThreads, ...) at
// once: a group of 8 splits' (m, l) is loaded once for them, and every
// load of the group is in flight together.
__device__ __forceinline__ void merge_wide(const float* all, int d,
                                           int splits, int n_units,
                                           float* out) {
  const int stride = d + 2;
  float gm = kNegInf;
  float sum = 0.f;
  float sum_o[kWideCols];
#pragma unroll
  for (int k = 0; k < kWideCols; ++k) sum_o[k] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float pm[8], pl[8], pa[8][kWideCols];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sj = s0 + j;
      const bool some = sj < splits &&
                        static_cast<int64_t>(sj) * n_units / splits <
                            static_cast<int64_t>(sj + 1) * n_units / splits;
      const float* ps = all + sj * stride;
      pm[j] = some ? __ldcg(ps + d) : -INFINITY;
      pl[j] = some ? __ldcg(ps + d + 1) : 0.f;
#pragma unroll
      for (int k = 0; k < kWideCols; ++k) {
        const int c = threadIdx.x + k * kThreads;
        pa[j][k] = some && c < d ? __ldcg(ps + c) : 0.f;
      }
    }
    float cm = gm;
#pragma unroll
    for (int j = 0; j < 8; ++j) cm = fmaxf(cm, pm[j]);
    const float r = expf(gm - cm);
    sum *= r;
#pragma unroll
    for (int k = 0; k < kWideCols; ++k) sum_o[k] *= r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (pm[j] == -INFINITY) continue;
      const float a = expf(pm[j] - cm);
      sum += pl[j] * a;
#pragma unroll
      for (int k = 0; k < kWideCols; ++k) sum_o[k] += pa[j][k] * a;
    }
    gm = cm;
  }
#pragma unroll
  for (int k = 0; k < kWideCols; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < d) out[c] = sum_o[k] / sum;
  }
}

// The wide instances (kMaxD < d <= kMaxWideD): the tiled kernel's design
// at rows of 1-2 KB, with tiles of WideRing<T>::kTileBytes in a ring of
// WideRing<T>::kTiles in dynamic shared memory. Every tile takes the
// multi-page path: its pages are found by a multiply-high and each key's
// position from its own page. E values a vector (16 bytes, or 1 in the narrow-row
// instance); LK lanes hold a key row; NV vectors a lane.
template <typename T, int E, int LK, int NV>
__global__ void __launch_bounds__(kThreads, WideRing<T>::kCtasPerSm)
paged_wide_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ ptab,
                  const int* __restrict__ lengths,
                  const int* __restrict__ tstep, float* __restrict__ o,
                  float* __restrict__ part, int heads, int n_pages, int page,
                  int d, int64_t page_stride, int64_t scale_stride,
                  int n_phys, int bucket, float scale, int splits,
                  int tile_rows, int ppt, int svec) {
  using Ring = WideRing<T>;
  constexpr int GK = 32 / LK;                  // keys a warp scores at once
  constexpr int VB = E * static_cast<int>(sizeof(T));
  constexpr int kTiles = Ring::kTiles;
  constexpr int kTileElems = Ring::kTileBytes / static_cast<int>(sizeof(T));
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char wide_raw[];
  __shared__ int row[kRowCap];
  __shared__ int last;
  T* ring = reinterpret_cast<T*>(wide_raw);
  float* sring = reinterpret_cast<float*>(wide_raw + kTiles * 2 *
                                                         Ring::kTileBytes);

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

  // The mask scalars, the page-table row and the lane's query columns.
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
  // The split's share: whole units of ppt live pages, so no tile crosses
  // a split.
  const int n_units = (n_live + ppt - 1) / ppt;
  const int u0 = static_cast<int>(static_cast<int64_t>(split) * n_units /
                                  splits);
  const int u1 = static_cast<int>(static_cast<int64_t>(split + 1) * n_units /
                                  splits);
  const int p0 = min(u0 * ppt, n_live);
  const int p1 = min(u1 * ppt, n_live);
  const int tpp = (page + tile_rows - 1) / tile_rows;   // tiles a page
  const int n_tiles = (u1 - u0) * tpp;
  const int64_t head_off = static_cast<int64_t>(h) * page * d;
  const uint32_t row_div = div_mul(page);
  const uint32_t vec_div = div_mul(page * nvec);
  const uint32_t sc_div = div_mul(svec ? page / 4 : page);
  __syncthreads();
  PROF_MARK(1);

  auto phys_of = [&](int k) {
    const int j = live.page(k);
    return row_s ? row[j] : min(max(prow[j], 0), n_phys - 1);
  };

  // Tile i into its ring slot, each page of it from its own physical page;
  // an int8 tile's K and V scales by 16-byte copies where svec, else 4
  // bytes a row.
  auto issue = [&](int i) {
    const Tile tl = tile_of(i, p0, p1, ppt, tpp, tile_rows, page);
    const int per_page = tl.nr * nvec;
    const int64_t row_off = head_off + static_cast<int64_t>(tl.r0) * d;
    T* kd = ring + (i % kTiles) * 2 * kTileElems;
    for (int v = threadIdx.x; v < tl.np * per_page; v += kThreads) {
      const int j = tl.np > 1 ? div_by(v, vec_div) : 0;
      const int64_t off = phys_of(tl.first + j) * page_stride + row_off +
                          static_cast<int64_t>(v - j * per_page) * E;
      copy_vec<VB>(kd + v * E, kp + off);
      copy_vec<VB>(kd + kTileElems + v * E, vp + off);
    }
    if constexpr (kQuant) {
      float* ksd = sring + (i % kTiles) * 2 * kWideScaleRows;
      const int64_t s_off = static_cast<int64_t>(h) * page + tl.r0;
      const int per = svec ? tl.nr / 4 : tl.nr;
      for (int v = threadIdx.x; v < tl.np * per; v += kThreads) {
        const int j = tl.np > 1 ? div_by(v, sc_div) : 0;
        const int c = v - j * per;
        const int64_t soff = phys_of(tl.first + j) * scale_stride + s_off;
        if (svec) {
          copy_vec<16>(ksd + 4 * v, ks + soff + 4 * c);
          copy_vec<16>(ksd + kWideScaleRows + 4 * v, vs + soff + 4 * c);
        } else {
          copy_vec<4>(ksd + v, ks + soff + c);
          copy_vec<4>(ksd + kWideScaleRows + v, vs + soff + c);
        }
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

#pragma unroll
  for (int i = 0; i < kTiles - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kTiles - 2>();
    __syncthreads();        // tile i landed; every warp is done with i - 1
    const int nx = i + kTiles - 1;
    if (nx < n_tiles) issue(nx);
    cp_async_commit();

    const Tile tl = tile_of(i, p0, p1, ppt, tpp, tile_rows, page);
    const int rows = tl.np * tl.nr;
    const int pos0 = live.page(tl.first) * page + tl.r0;
    const T* kt = ring + (i % kTiles) * 2 * kTileElems;
    const T* vt = kt + kTileElems;
    const float* kst = sring + (i % kTiles) * 2 * kWideScaleRows;
    for (int kb = warp * GK; kb < rows; kb += kWarps * GK) {
      const int r = kb + grp;
      const bool valid = r < rows;
      float sk = 1.f, sv = 1.f;
      if constexpr (kQuant) {
        if (valid) {
          sk = kst[r];
          sv = kst[kWideScaleRows + r];
        }
      }
      float sp[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int v = li + LK * n;
        if (valid && v < nvec) {
          float x[E];
          load_vec<T, E>(kt + r * d + v * E, x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int c = kQuant ? (e & 1) : (n & 1);
            sp[c] = fmaf(qr[n][e], x[e], sp[c]);
          }
        }
      }
      float s = sp[0] + sp[1];
#pragma unroll
      for (int off = LK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (!valid) continue;
      if constexpr (kQuant) s *= sk;
      s *= scale;
      int pos = pos0 + r;
      if (tl.np > 1) {
        const int j = div_by(r, row_div);
        pos = live.page(tl.first + j) * page + r - j * page;
      }
      s += (pos < length || (pos >= bucket && pos <= bucket + t)) ? 0.f
                                                                  : kNegInf;
      const bool grows = s > m;
      const float e = expf(grows ? m - s : s - m);
      const float alpha = grows ? e : 1.f;
      const float p = grows ? 1.f : e;
      m = grows ? s : m;
      l = l * alpha + p;
      const float pv = kQuant ? p * sv : p;
      if (grows) {
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int e2 = 0; e2 < E; ++e2) acc[n][e2] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int v = li + LK * n;
        if (v < nvec) {
          float x[E];
          load_vec<T, E>(vt + r * d + v * E, x);
#pragma unroll
          for (int e2 = 0; e2 < E; ++e2)
            acc[n][e2] = fmaf(pv, x[e2], acc[n][e2]);
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
  float* wacc = reinterpret_cast<float*>(wide_raw);
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

  // Split: this CTA's partial, a ticket, and the last CTA of the (slot,
  // head) merges every non-empty split's partial in split order.
  const int stride = d + 2;
  float* mine = part + (bh * splits + split) * stride;
  if (u1 > u0) {
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
  merge_wide(part + bh * splits * stride, d, splits, n_units, o + bh * d);
  if (threadIdx.x == 0) g_tickets[bh] = 0;
  PROF_MARK(3);
}

// The column-chunked instance (d > kMaxWideD): CTA (blockIdx.x,
// blockIdx.y) takes split blockIdx.x % splits of (slot, head) blockIdx.x /
// splits and the output columns [kMaxD y, kMaxD y + kMaxD) of d. A warp
// scores one live key at a time, its lanes striding over the whole row in
// global memory, and keeps the online softmax and its lanes' columns of
// the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_chunked_kernel(const float* __restrict__ q,
                         const T* __restrict__ kp, const T* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ ptab,
                         const int* __restrict__ lengths,
                         const int* __restrict__ tstep, float* __restrict__ o,
                         float* __restrict__ part, int heads, int n_pages,
                         int page, int d, int64_t page_stride,
                         int64_t scale_stride, int n_phys, int bucket,
                         float scale, int splits) {
  constexpr int kCols = kMaxD / 32;            // chunk columns a lane holds
  constexpr bool kQuant = sizeof(T) == 1;
  __shared__ float wacc[kWarps * kMaxD];
  __shared__ float wm[kWarps];
  __shared__ float wl[kWarps];
  __shared__ int last;

  const int64_t bh = blockIdx.x / splits;
  const int split = static_cast<int>(blockIdx.x - bh * splits);
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh - static_cast<int64_t>(b) * heads);
  const int chunk = static_cast<int>(blockIdx.y);
  const int n_chunks = static_cast<int>(gridDim.y);
  const int c0 = chunk * kMaxD;
  const int cw = min(kMaxD, d - c0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int length = lengths[b];
  const int t = tstep[b];
  const int* prow = ptab + static_cast<int64_t>(b) * n_pages;
  const float* qr = q + bh * d;
  const Live live = live_runs(length, t, bucket, page, n_pages);
  const int n_live = live.count();
  const int k0 = static_cast<int>(static_cast<int64_t>(split) * n_live /
                                  splits);
  const int k1 = static_cast<int>(static_cast<int64_t>(split + 1) * n_live /
                                  splits);
  const int64_t head_off = static_cast<int64_t>(h) * page * d;

  float m = kNegInf;
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int n = 0; n < kCols; ++n) acc[n] = 0.f;
  const int n_keys = (k1 - k0) * page;
  for (int kk = warp; kk < n_keys; kk += kWarps) {
    const int pi = kk / page;
    const int r = kk - pi * page;
    const int j = live.page(k0 + pi);
    const int phys = min(max(prow[j], 0), n_phys - 1);
    const int64_t off = phys * page_stride + head_off +
                        static_cast<int64_t>(r) * d;
    float sk = 1.f, sv = 1.f;
    if constexpr (kQuant) {
      const int64_t so = phys * scale_stride +
                         static_cast<int64_t>(h) * page + r;
      sk = ks[so];
      sv = vs[so];
    }
    float sp = 0.f;
    for (int c = lane; c < d; c += 32) {
      float x = to_f(kp[off + c]);
      if constexpr (kQuant) x *= sk;
      sp = fmaf(qr[c], x, sp);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      sp += __shfl_xor_sync(0xffffffffu, sp, sh);
    float s = sp * scale;
    const int pos = j * page + r;
    s += (pos < length || (pos >= bucket && pos <= bucket + t)) ? 0.f
                                                                : kNegInf;
    const bool grows = s > m;
    const float e = expf(grows ? m - s : s - m);
    const float alpha = grows ? e : 1.f;
    const float p = grows ? 1.f : e;
    m = grows ? s : m;
    l = l * alpha + p;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int c = lane + 32 * n;
      if (c < cw) {
        float x = to_f(vp[off + c0 + c]);
        if constexpr (kQuant) x *= sv;
        acc[n] = fmaf(p, x, acc[n] * alpha);
      }
    }
  }

  // The warps, in order, through shared memory.
#pragma unroll
  for (int n = 0; n < kCols; ++n) wacc[warp * kMaxD + lane + 32 * n] = acc[n];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
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
    for (int c = threadIdx.x; c < cw; c += kThreads) {
      float sum_o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum_o += wacc[w * kMaxD + c] * aw[w];
      o[bh * d + c0 + c] = sum_o / sum_l;
    }
    return;
  }

  // Split: this CTA's partial of its chunk and the chunk's own (m, l);
  // the last CTA of the (slot, head, chunk) merges them in split order.
  const int stride = d + 2 * n_chunks;
  const int ml = d + 2 * chunk;
  float* mine = part + (bh * splits + split) * stride;
  if (k1 > k0) {
    for (int c = threadIdx.x; c < cw; c += kThreads) {
      float sum_o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum_o += wacc[w * kMaxD + c] * aw[w];
      mine[c0 + c] = sum_o;
    }
    if (threadIdx.x == 0) {
      mine[ml] = mx;
      mine[ml + 1] = sum_l;
    }
  }
  const int64_t ticket = bh * n_chunks + chunk;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&g_tickets[ticket], 1) == splits - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  merge_splits(part + bh * splits * stride + c0, stride, ml - c0, cw, splits,
               n_live, o + bh * d + c0);
  if (threadIdx.x == 0) g_tickets[ticket] = 0;
}

template <typename T>
int launch_chunked(const float* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* ptab,
                   const int* lengths, const int* t, float* o, float* part,
                   int64_t bh, int heads, int n_pages, int page, int d,
                   int64_t page_stride, int64_t scale_stride, int n_phys,
                   int bucket, float scale, int splits, cudaStream_t st) {
  const int n_chunks = (d + kMaxD - 1) / kMaxD;
  if (splits > 1 && bh * n_chunks > kMaxTickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bh * splits),
                  static_cast<unsigned>(n_chunks));
  paged_decode_chunked_kernel<T><<<grid, kThreads, 0, st>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ks, vs, ptab,
      lengths, t, o, part, heads, n_pages, page, d, page_stride,
      scale_stride, n_phys, bucket, scale, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, int LK, int NV>
int launch(const float* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* ptab, const int* lengths,
           const int* t, float* o, float* part, int64_t bh, int heads,
           int n_pages, int page, int d, int64_t page_stride,
           int64_t scale_stride, int n_phys, int bucket, float scale,
           int splits, cudaStream_t st) {
  // A tile holds up to kTileBytes of K rows (and as many of V): ppt whole
  // pages where pages fit and rows are narrower than float32's
  // (ops/attention.py::paged_tile_pages), else tile_rows rows of one
  // page.
  const int row_bytes = d * static_cast<int>(sizeof(T));
  int tile_rows = max(1, kTileBytes / row_bytes);
  if (sizeof(T) == 1) tile_rows = min(tile_rows, kMaxScaleRows);
  const int ppt = sizeof(T) < 4 ? max(1, tile_rows / page) : 1;
  tile_rows = min(tile_rows, page);
  const bool svec = sizeof(T) == 1 && page % 4 == 0 && tile_rows % 4 == 0 &&
                    scale_stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(ks) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(vs) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(bh * splits);
  paged_decode_kernel<T, E, LK, NV><<<grid, kThreads, 0, st>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ks, vs, ptab,
      lengths, t, o, part, heads, n_pages, page, d, page_stride,
      scale_stride, n_phys, bucket, scale, splits, tile_rows, ppt,
      static_cast<int>(svec));
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

// One wide instance: its dynamic shared memory opted into once per card
// (before any launch: a launch captured in a CUDA graph makes no call),
// then its launch, or with `desc` its resources into desc[5] (see
// mv_paged_decode_describe) and no launch. A tile holds up to
// WideRing<T>::kTileBytes of K rows (and as many of V): ppt whole pages
// where a page fits (ops/attention.py::paged_tile_pages), else a page in
// tpp tiles of equal rows.
template <typename T, int E, int LK, int NV>
int launch_wide(MV_PAGED_PARAMS, int* desc) {
  const auto kernel = paged_wide_kernel<T, E, LK, NV>;
  constexpr int smem = WideRing<T>::kSmem;
  constexpr int64_t tile_bytes = WideRing<T>::kTileBytes;
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit, std::memory_order_acq_rel);
  }
  if (desc != nullptr) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    desc[0] = kThreads;
    desc[1] = smem + static_cast<int>(a.sharedSizeBytes);
    desc[2] = a.numRegs;
    desc[3] = static_cast<int>(a.localSizeBytes);
    desc[4] = ctas;
    return 0;
  }
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  const int64_t page_bytes = row_bytes * page;
  int ppt = 1;
  int tile_rows = page;
  if (page_bytes <= tile_bytes) {
    ppt = static_cast<int>(tile_bytes / page_bytes);
  } else {
    const int64_t tpp = (page_bytes + tile_bytes - 1) / tile_bytes;
    const int64_t even = (page + tpp - 1) / tpp;
    const int64_t fit = tile_bytes / row_bytes;
    tile_rows = static_cast<int>(even < fit ? even : fit);
  }
  const bool svec = sizeof(T) == 1 && page % 4 == 0 && tile_rows % 4 == 0 &&
                    scale_stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(ks) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(vs) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(bh * splits);
  kernel<<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ks, vs, ptab,
      lengths, t, o, part, heads, n_pages, page, d, page_stride,
      scale_stride, n_phys, bucket, scale, splits, tile_rows, ppt,
      static_cast<int>(svec));
  return static_cast<int>(cudaGetLastError());
}

// The wide instances (kMaxD < d <= kMaxWideD): 16 lanes a key row of
// 16-byte vectors, NV of them a lane (at most 32 values), int8 up to dh
// 384 8 lanes of 3 (48 values); the narrow-row one (vec false) 32 lanes a
// row, 16 values a lane.
template <typename T>
int dispatch_wide(MV_PAGED_PARAMS, bool vec, int* desc) {
  if (!vec) return launch_wide<T, 1, 32, 16>(MV_PAGED_ARGS, desc);
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  if constexpr (E == 4) {
    if (nvec <= 16 * 5) return launch_wide<T, E, 16, 5>(MV_PAGED_ARGS, desc);
    if (nvec <= 16 * 6) return launch_wide<T, E, 16, 6>(MV_PAGED_ARGS, desc);
    return launch_wide<T, E, 16, 8>(MV_PAGED_ARGS, desc);
  } else if constexpr (E == 8) {
    if (nvec <= 16 * 3) return launch_wide<T, E, 16, 3>(MV_PAGED_ARGS, desc);
    return launch_wide<T, E, 16, 4>(MV_PAGED_ARGS, desc);
  } else {
    if (nvec <= 8 * 3) return launch_wide<T, E, 8, 3>(MV_PAGED_ARGS, desc);
    return launch_wide<T, E, 16, 2>(MV_PAGED_ARGS, desc);
  }
}

// Whether the rows are whole 16-byte vectors on 16-byte boundaries.
template <typename T>
bool vec_rows(int d, int64_t page_stride, const void* kp, const void* vp) {
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  return row_bytes % 16 == 0 &&
         (page_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(vp) % 16 == 0;
}

// The instance a launch takes, by its index in
// ops/attention.py::B7_INSTANCE_NAMES, into *instance.
template <typename T>
int dispatch(MV_PAGED_PARAMS, int* instance) {
  if (d > kMaxWideD) {
    *instance = kInstChunked;
    return launch_chunked<T>(MV_PAGED_ARGS);
  }
  const bool vec = vec_rows<T>(d, page_stride, kp, vp);
  if (d > kMaxD) {
    *instance = vec ? kInstWideVec : kInstWideNarrow;
    return dispatch_wide<T>(MV_PAGED_ARGS, vec, nullptr);
  }
  *instance = kInstTiled;
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
// (d + 2) floats of scratch (d <= 512). Writes o [batch, heads, d]
// float32. Returns cudaGetLastError() after the launch (0 = launched);
// shapes the kernel does not take return cudaErrorInvalidValue and launch
// nothing. A head wider than 512 (d > kMaxWideD) is split into
// ceil(d / 256) column chunks: part then holds batch * heads * splits *
// (d + 2 * chunks) floats, and batch * heads * chunks must not pass
// kMaxTickets when splits > 1. Where `instance` is not null, the index
// of the instance that took the launch (Instance: 0 tiled, 1 wide of
// 16-byte vectors, 2 wide narrow-row, 3 column-chunked) goes there, -1
// where nothing was dispatched.
int mv_paged_decode_attn(const float* q, const void* kp, const void* vp,
                         const float* ks, const float* vs, const int* ptab,
                         const int* lengths, const int* t, float* o,
                         float* part, int batch, int heads, int n_pages,
                         int page, int d, int64_t page_stride,
                         int64_t scale_stride, int n_phys, int bucket,
                         float scale, int kind, int splits, void* stream,
                         int* instance) {
  int taken = -1;
  if (instance == nullptr) instance = &taken;
  *instance = -1;
  if (batch <= 0 || heads <= 0) return 0;
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  if (n_pages <= 0 || page <= 0 || d <= 0 || n_phys <= 0 ||
      splits <= 0 || splits > n_pages || bh * splits > 0x7fffffffLL ||
      (splits > 1 && (part == nullptr || bh > kMaxTickets)) || kind < 0 ||
      kind > 2 ||
      (kind == 2 && (ks == nullptr || vs == nullptr || scale_stride <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 1) return dispatch<__nv_bfloat16>(MV_ENTRY_ARGS, instance);
  if (kind == 2) return dispatch<int8_t>(MV_ENTRY_ARGS, instance);
  return dispatch<float>(MV_ENTRY_ARGS, instance);
}

// The resources of the wide instance that takes heads of width d (256 <
// d <= 512) of page kind `kind` with rows of 16-byte vectors (vec 1) or
// not (vec 0), read from the runtime, into out[5]: threads a CTA, shared
// memory bytes a CTA (dynamic and static), registers and local (spill)
// bytes a thread, CTAs an SM. Returns a CUDA error code (0 = read).
int mv_paged_decode_describe(int d, int kind, int vec, int* out) {
  if (d <= kMaxD || d > kMaxWideD || kind < 0 || kind > 2 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = nullptr;
  const void *kp = nullptr, *vp = nullptr;
  const float *ks = nullptr, *vs = nullptr;
  const int *ptab = nullptr, *lengths = nullptr, *t = nullptr;
  float *o = nullptr, *part = nullptr;
  const int64_t bh = 1, page_stride = 0, scale_stride = 0;
  const int heads = 1, n_pages = 1, page = 1, n_phys = 1, bucket = 0;
  const int splits = 1;
  const float scale = 1.f;
  const cudaStream_t st = nullptr;
  if (kind == 1)
    return dispatch_wide<__nv_bfloat16>(MV_ENTRY_ARGS, vec != 0, out);
  if (kind == 2) return dispatch_wide<int8_t>(MV_ENTRY_ARGS, vec != 0, out);
  return dispatch_wide<float>(MV_ENTRY_ARGS, vec != 0, out);
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
