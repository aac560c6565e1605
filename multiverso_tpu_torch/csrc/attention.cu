// Flash block attention for Hopper (sm_90a).
//
// mv_flash_block_attn replaces multiverso_tpu/ops/pallas_attention.py::
// flash_block_attn (B6), the local block step of ring and Ulysses
// attention. For q [BH, Sq, D] and k, v [BH, Sk, D] it returns the
// un-normalised streaming-softmax result of the TPU kernel (_kernel,
// pallas_attention.py:41-94): for each (bh, q row), over the k tiles in
// order,
//
//   s     = (q . k) * scale  [+ (k_pos > q_pos ? -1e30 : 0) if causal]
//                            [+ bias[q row, k col]]
//   m_new = max(m, rowmax(s));  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l     = alpha * l + sum(p); o = alpha * o + p . v
//
// with m starting at -1e30 (not -inf, so a fully masked row keeps finite
// o, m, l), l and o at 0, q_pos = q_off + row and k_pos = k_off + col.
// Inputs are float32 or bfloat16; the softmax is float32 with expf (no
// fast math).
//
// What bounds it on this card: operations. The function needs 4*D flops
// for each (q, k) pair whose score counts (all BH*Sq*Sk of them without a
// mask; with the causal mask at equal offsets only the ~Sq*Sk/2 pairs on
// or below the diagonal) and moves (2*Sq + 2*Sk)*BH*D floats: at the LM's
// GPT-2-small eval step (BH 96, S 1024, D 64, causal) 12.9 GFLOP against
// ~101 MB. Both products run on the tensor cores as three TF32 products
// each (below), so the bound of this route is 3 x 12.9 GFLOP at 495
// TFLOP/s, ~0.078 ms; the same work on the float32 CUDA cores (67 TFLOP/s)
// needs ~0.192 ms, and the bytes ~0.030 ms of HBM time.
//
// Design. The TPU kernel walks a sequential grid whose innermost k
// dimension carries (o, m, l) in VMEM scratch. Here one CTA of 4 warps
// owns one 64-row q tile of one bh and walks the 64-row k tiles itself,
// in the FlashAttention-2 shape:
//   * each warp owns 16 q rows. S = Q K^T and P V are mma.sync.m16n8k8
//     TF32 products with float32 accumulators. A float32 operand x is
//     split into TF32 parts hi and lo (split() below) and each product is
//     taken as hi*hi + hi*lo + lo*hi ("3xTF32"): every term is exact in
//     the tensor core and what is dropped is ~2^-21 of the product, about
//     float32 rounding (one TF32 pass, ~1e-3, would miss the tolerances).
//     bfloat16 inputs are exact in TF32 (lo = 0): one path for both;
//   * S stays in the accumulator registers. Thread (g, t) = (lane / 4,
//     lane % 4) holds rows g and g + 8, keys 2t and 2t + 1 of each 8-key
//     slice, so a row's max and sum are two xor shuffles within the quad.
//     P feeds the P.V product straight from those registers: inside each
//     8-key slice the product's k index t stands for key 2t and t + 4 for
//     key 2t + 1, and V's fragment rows are read in that order. For Q.K^T
//     the head dim is permuted the same way inside each 8-column slice, so
//     a thread's two values of a fragment row are one 8-byte load;
//   * the tensor cores truncate their sums, so the tile's P.V is summed
//     from 0 and added to O in float32 (o = alpha o + pv, rounded): the
//     truncation does not build up over a long k walk. Likewise each
//     64-column chunk of Q.K^T is summed from 0 and added to S in float32
//     (one chain over D = 128 missed the tolerance at the LM's eval shape,
//     1.08 of the o allowance): the first chunk goes straight into S, so
//     at D = 64 the product is the one chain it was;
//   * the row max m is exact. The tensor-core scores carry ~1e-7 of
//     absolute error, a large relative error of m for a row whose largest
//     score is near 0 (a causal row seeing one key). So each row keeps the
//     key of its running max, and at the end one thread rescores that key
//     as a float32 FMA chain over d in order (the plain dot product); o
//     and l are rescaled by exp(m_tc - m);
//   * K and V tiles are staged in turn with 16-byte cp.async.cg: K of
//     tile j + 1 lands while tile j's softmax and P.V run, V of tile j + 1
//     while its Q.K^T runs. One buffer each, so at D = 64 a CTA takes
//     54,272 bytes of shared memory and, at 167 registers a thread, three
//     CTAs run on an SM (two buffers each, 90,112 bytes, leave two, which
//     measured slower). bfloat16 tiles are converted to float32 on the way
//     in, synchronously;
//   * rows are 64 NC + 8 floats (Q, K: a warp's 8-byte loads of 8 rows x 4
//     columns fall on distinct banks) and 64 NC + 4 (V: 4-byte loads),
//     NC = ceil(D / 64), and the loops over D run to 64 NC, through zero
//     columns of Q and K, so they unroll with no runtime bound inside: a
//     bound test inside the P.V loop cut it into one basic block per
//     fragment, which serialized its loads (a third of the time at D = 128);
//   * masked tiles are skipped, exactly. A causal call with no bias, where
//     every row of the CTA sees the first key (k_off <= q_off + q0), stops
//     the k walk after the last tile holding a key its last row sees. A
//     later tile's scores are all x*scale - 1e30 = -1e30 in float32, and a
//     row that has seen an unmasked key has m > -1e30, so such a tile
//     gives m_new = m, alpha = 1 and p = exp(-1e30 - m) = 0: it changes
//     nothing, bit for bit, and its K and V are never read. Without that
//     condition (a row that saw no key yet, or a bias that may mask a
//     whole row) every tile is walked. The grid launches the q tiles with
//     the most k tiles first, so the long CTAs do not come last.
// These narrow instances take D <= 128: 54,272 bytes of shared memory at
// D = 64 and 103,424 at D = 128 (above 48 KB it needs the opt-in
// attribute, set at an instance's first launch). The registers and
// spills of each instance (-Xptxas -v) are printed by chip_smoke.py and
// kept in PERF.md.
//
// D > 128 (any D % 8 == 0): the wide instances (flash_wide_kernel). What
// bounds them is the same: operations, 3xTF32 on the tensor cores (at the
// LM's eval shape, causal, 0.235 ms at D = 192, 0.313 ms at D = 256,
// 0.391 ms at D = 320 and 0.625 ms at D = 512). D in (128, 256] took
// narrow instances of three and four chunks before: 152,576 and 201,728
// bytes of shared memory left one CTA of 4 warps an SM, one chain over D
// missed the tolerance, and at D = 256 it read slower than SDPA. As the
// wide instance with O of 2 chunks a warpgroup it runs 8 warps an SM; the
// narrow instance of three chunks with its chunks summed apart needed
// 255 registers and spilled, and read 6% slower than before at D = 192
// where the wide one reads 8% faster.
// A 64-row O of such widths does not fit one warpgroup's registers, so
// one CTA of two warpgroups (8 warps) owns a 64-row q tile: warp w of
// each warpgroup holds rows 16 w .. 16 w + 15, and the two split the
// work of every k tile:
//   * S once per (q tile, k tile). Each warpgroup takes a partial Q.K^T
//     over its own span of D, each 64 columns summed from 0 in the
//     tensor cores and added in float32 (the tensor cores truncate their
//     sums; one chain over a wide head's columns misses the tolerance).
//     The two warps that hold the same 16 rows swap their partials
//     through shared memory (one float4 a lane a fragment, so a lane
//     reads only what the same lane of the other warp wrote; two named
//     barriers of 64 threads) and both add them as p0 + p1: both hold
//     bit-identical S, so m, l and P agree bit for bit, and warpgroup 0
//     writes m and l. The softmax is taken by both (32 expf a thread a
//     tile, against ~1,000 tensor-core products);
//   * the output columns are split by 64-column chunks, the first half
//     (rounded up) to warpgroup 0; the score columns are split so that
//     each warpgroup's scores plus its P.V come to the same work (at D =
//     320: 128 + 192 and 192 + 128 columns; at D = 192 64 + 128 and 128
//     + 64; at D = 256 128 + 128 each),
//     so between two exchanges both do the same number of products. O
//     stays in registers: 2, 3 or 4 chunks of 16 x 64 a warp (64, 96 or
//     128 floats a thread);
//   * loads run during the products: each warpgroup walks its own ring of
//     2 stages of 64 rows x 64 columns (K chunks for its scores, then V
//     chunks for its columns, tile after tile), the next chunk's 16-byte
//     cp.async group issued before the products of the current one, one
//     named barrier of its 128 threads a step (a third stage measured no
//     faster at D = 320). bfloat16 tiles land as bfloat16 and are
//     converted as the fragments are read, so the ring never waits on a
//     conversion;
//   * Q is staged once per CTA up to D = 512: its 64 rows (51,200 bytes
//     at D = 192, 67,584 at D = 256, 133,120 at D = 512) beside the rings
//     (73,728) and the exchange (16,384).
//     Wider heads stream Q's chunks with K's through the ring (a stage
//     holds both), and split the output columns over CTAs in spans of
//     512 (gridDim.y), each walking the scores of all of D;
//   * kept from the narrow instances: the 3xTF32 products, each P.V tile
//     added to O in float32, the exact row max rescored as an FMA chain
//     over d, the exact masked-tile skip, the longest q tiles first, the
//     opt-in attribute set once per instance. Every loop over D ends at
//     the chunk's live columns, so a last chunk of 8 (D = 264) adds
//     nothing of other columns.
// One CTA an SM: 256 threads at up to 255 registers (-Xptxas -v in
// chip_smoke.py's log; a few dozen bytes of spill at D > 384; 157,696
// bytes of shared memory at D = 256 leave no room for a second). With two
// warps a scheduler, the products wait on their operands' latency: the
// instance reaches about a quarter of its bound, as the narrow ones do.
// Per-fragment float32 sums (shorter tensor-core chains) measured 5-20%
// slower for a few percent less error, and unmasked TF32 low parts gave
// the same bits (the tensor cores ignore the low 13 bits) at the same
// speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;               // q rows and k rows per tile
constexpr int kQKPad = 8;               // floats of padding per Q, K row
constexpr int kVPad = 4;                // floats of padding per V row
constexpr float kNegInf = -1e30f;       // pallas_attention.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// x = hi + lo, both TF32 (the top 19 bits of a float32): hi rounded to
// nearest (ties away, as cvt.rna.tf32) and lo = x - hi, exact in float32,
// truncated, so |x - hi - lo| < 2^-21 |x|; a NaN x gives a NaN lo. Four
// integer and float ops: two cvt.rna.tf32 per split measured ~15% slower
// for the whole kernel on an H100.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// c += a * b, one m16n8k8 TF32 product.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two neighbouring elements as float32 (one 8- or 4-byte load).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier of n threads (whole warps) on barrier id (1-15; 0 is
// __syncthreads's).
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A thread's 16-byte chunks of a 64-row tile of d columns: chunk (r, c)
// from (r0, c0), each next one kThreads chunks on (dr rows and dc chunks,
// carried), so the staging loops divide by d only once per kernel.
struct Chunks {
  int r0, c0, dr, dc, d4;
};

__device__ __forceinline__ Chunks chunks_of(int d) {
  const int d4 = d / 4;
  const int tid = threadIdx.x;
  return {tid / d4, tid % d4, kThreads / d4, kThreads % d4, d4};
}

// Rows [0, 64) of a row-major matrix with rows ld elements apart, w.d4
// 16-byte chunks of each, into shared rows of stride ds: float32 by
// cp.async (landed after the next wait), bfloat16 converted to float32 by
// plain loads and stores.
__device__ __forceinline__ void stage(float* dst, const float* src, int ld,
                                      int ds, const Chunks& w) {
  for (int r = w.r0, c = w.c0; r < kTile;) {
    cp_async16(dst + r * ds + 4 * c,
               src + static_cast<int64_t>(r) * ld + 4 * c);
    r += w.dr;
    c += w.dc;
    if (c >= w.d4) {
      c -= w.d4;
      ++r;
    }
  }
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int ld, int ds, const Chunks& w) {
  for (int r = w.r0, c = w.c0; r < kTile;) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        src + static_cast<int64_t>(r) * ld + 4 * c);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    *reinterpret_cast<float4*>(dst + r * ds + 4 * c) =
        make_float4(a.x, a.y, b.x, b.y);
    r += w.dr;
    c += w.dc;
    if (c >= w.d4) {
      c -= w.d4;
      ++r;
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x;
}

// One Q, one K and one V tile, rows as wide as the instance's widest d.
size_t smem_bytes(int nc) {
  return (2 * kTile * (64 * nc + kQKPad) + kTile * (64 * nc + kVPad)) *
         sizeof(float);
}

// S += Q K^T for rows r0, r0 + 8 and the tile's 64 keys, 8 per fragment,
// over columns [c0, c1) of the staged Q and K (c0, c1 multiples of 8).
template <int NC>
__device__ __forceinline__ void qk_cols(float (&s)[8][4], const float* qs,
                                        const float* ks, int r0, int g,
                                        int t, int c0, int c1) {
  constexpr int qk_ds = 64 * NC + kQKPad;
#pragma unroll
  for (int c = c0; c < c1; c += 8) {
    const float2 qa =
        *reinterpret_cast<const float2*>(qs + r0 * qk_ds + c + 2 * t);
    const float2 qb =
        *reinterpret_cast<const float2*>(qs + (r0 + 8) * qk_ds + c + 2 * t);
    const float a[4] = {qa.x, qb.x, qa.y, qb.y};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 kk = *reinterpret_cast<const float2*>(
          ks + (n * 8 + g) * qk_ds + c + 2 * t);
      mma3(s[n], ah, al, kk.x, kk.y);
    }
  }
}

// Columns [w, 64 NC) of the 2 * 64 staged Q and K rows set to 0, so the
// products over them add exactly 0.
template <int NC>
__device__ __forceinline__ void zero_qk_tail(float* qs, int w) {
  constexpr int qk_ds = 64 * NC + kQKPad;
  for (int i = threadIdx.x; i < 2 * kTile * qk_ds; i += kThreads)
    if (i % qk_ds >= w) qs[i] = 0.0f;  // qs and ks are adjacent
}

// The streaming softmax of one tile, for rows r0, r0 + 8 (q0 + r0 in the
// block) and keys k0 .. k0 + 63: scale, mask and bias S; each row's max,
// and its key when the max grows (best); alpha = exp(m_old - m_new); S
// becomes P = exp(S - m) and l = alpha l + rowsum(P). Masked: col - row >
// q_off + q0 - k_off - k0 (clamped, as |col - row| < 64); a tile below
// the diagonal has no masked score.
__device__ __forceinline__ void softmax_tile(
    float (&s)[8][4], float (&m_i)[2], float (&l_i)[2], int (&best)[2],
    float (&alpha)[2], const float* __restrict__ bias, float scale,
    int causal, int64_t q_off, int64_t k_off, int q0, int k0, int r0,
    int t, int lane, int sk) {
  int64_t lim64 = q_off + q0 - k_off - k0;
  lim64 = lim64 < -kTile ? -kTile : (lim64 > kTile ? kTile : lim64);
  const int lim = static_cast<int>(lim64);
  const bool mask = causal && lim < kTile - 1;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int row = r0 + 8 * h;
      const int col = n * 8 + 2 * t + (e & 1);
      float x = s[n][e] * scale;
      if (mask) x = x + ((col - row > lim) ? kNegInf : 0.0f);
      if (bias != nullptr)
        x = x + bias[static_cast<int64_t>(q0 + row) * sk + k0 + col];
      s[n][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    if (mx[h] > m_i[h]) {  // the quad agrees; the lowest key of the max
      int ix = kTile;
#pragma unroll
      for (int n = 7; n >= 0; --n)
#pragma unroll
        for (int e = 2 * h + 1; e >= 2 * h; --e)
          if (s[n][e] == mx[h]) ix = n * 8 + 2 * t + (e & 1);
      ix = min(ix, __shfl_xor_sync(0xfu << (lane & ~3), ix, 1));
      ix = min(ix, __shfl_xor_sync(0xfu << (lane & ~3), ix, 2));
      best[h] = k0 + ix;
    }
    const float m_new = fmaxf(m_i[h], mx[h]);
    alpha[h] = expf(m_i[h] - m_new);
    m_i[h] = m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - m_i[e >> 1]);
      rs[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_i[h] = alpha[h] * l_i[h] + quad_sum(rs[h]);
}

// pv = P V over the tile's 64 keys and 64 columns of V from vs (rows vds
// elements apart), summed from 0. Inside each 8-key slice the product's k
// index t stands for key 2t and t + 4 for key 2t + 1, as P's registers
// hold them.
template <typename T>
__device__ __forceinline__ void pv_tile(float (&pv)[8][4],
                                        const float (&p)[8][4], const T* vs,
                                        int vds, int g, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[i][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float a[4] = {p[n][0], p[n][2], p[n][1], p[n][3]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
    const T* v0 = vs + (n * 8 + 2 * t) * vds + g;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mma3(pv[i], ah, al, to_float(v0[i * 8]), to_float(v0[vds + i * 8]));
  }
}

// The score of one (q row, key) pair as the plain dot product: a float32
// FMA chain over d in order.
template <typename TQ, typename TK>
__device__ __forceinline__ float dot_chain(const TQ* qr, const TK* kr,
                                           int d) {
  float dot = 0.0f;
  for (int c = 0; c < d; ++c)
    dot = fmaf(to_float(qr[c]), to_float(kr[c]), dot);
  return dot;
}

// m exactly: the running max's key (best) rescored by thread t = h of
// the quad for row r0 + 8h, then o and l rescaled by f = exp(m_tc - m).
template <typename TQ, typename TK>
__device__ __forceinline__ void exact_max(float (&mf)[2], float (&f)[2],
                                          const float (&m_i)[2],
                                          const int (&best)[2],
                                          const TQ* qrows, int qds,
                                          const TK* kb, const float* bias,
                                          float scale, int causal,
                                          int64_t q_off, int64_t k_off,
                                          int q0, int r0, int t, int lane,
                                          int sk, int d) {
  float m_exact = kNegInf;
  if (t < 2) {
    const int row = r0 + 8 * t;
    const int key = t == 0 ? best[0] : best[1];
    m_exact = t == 0 ? m_i[0] : m_i[1];
    if (key >= 0) {
      float x = dot_chain(qrows + static_cast<int64_t>(row) * qds,
                          kb + static_cast<int64_t>(key) * d, d) *
                scale;
      if (causal) x = x + ((k_off + key > q_off + q0 + row) ? kNegInf : 0.0f);
      if (bias != nullptr)
        x = x + bias[static_cast<int64_t>(q0 + row) * sk + key];
      m_exact = x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mf[h] = __shfl_sync(kFull, m_exact, (lane & ~3) | h);
    f[h] = expf(m_i[h] - mf[h]);
  }
}

// The causal k walk: a causal call with no bias, where every row of the
// q tile sees the first key, stops after the last tile holding a key its
// last row sees (see the note above).
__device__ __forceinline__ int k_tiles(int sk, const float* bias, int causal,
                                       int64_t q_off, int64_t k_off,
                                       int q0) {
  int n_kt = sk / kTile;
  if (causal && bias == nullptr && k_off <= q_off + q0) {
    const int64_t seen = q_off + q0 + kTile - k_off;  // keys the last row sees
    const int64_t walk = (seen + kTile - 1) / kTile;
    if (walk < n_kt) n_kt = static_cast<int>(walk);
  }
  return n_kt;
}

// NC: 64-column chunks of o, ceil(d / 64); each warp holds NC * 8 column
// fragments of its 16 rows.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, int n_bh, int sq, int sk,
                   int d, float scale, int causal, int64_t q_off,
                   int64_t k_off) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // Rows are as wide as the instance's widest d, so the loops over d run
  // a fixed count: Q and K columns d .. 64 NC - 1 hold zeros (their
  // products add exactly 0), and V's hold what they hold (the output
  // columns they feed are not written).
  constexpr int kW = 64 * NC;
  constexpr int qk_ds = kW + kQKPad;
  constexpr int v_ds = kW + kVPad;
  float* qs = smem;
  float* ks = qs + kTile * qk_ds;
  float* vs = ks + kTile * qk_ds;

  // The q tiles with the most k tiles launch first.
  const int n_qt = sq / kTile;
  const int64_t bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * kTile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this thread's rows r0, r0+8
  const T* qb = q + (bh * sq + q0) * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  const int n_kt = k_tiles(sk, bias, causal, q_off, k_off, q0);

  // K and V are staged in turn: K of tile j + 1 lands while tile j's
  // softmax and P.V run, V of tile j + 1 while its Q.K^T runs. Every step
  // commits one cp.async group (empty at the end), so "all but the newest
  // group" is always the tile about to be read.
  const Chunks w = chunks_of(d);
  if (d < kW) zero_qk_tail<NC>(qs, d);
  stage(qs, qb, d, qk_ds, w);
  stage(ks, kb, d, qk_ds, w);
  cp_async_commit();
  stage(vs, vb, d, v_ds, w);
  cp_async_commit();

  float acc[NC * 8][4];
#pragma unroll
  for (int j = 0; j < NC * 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.0f, 0.0f};
  int best[2] = {-1, -1};  // the key of each row's running max

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    const int64_t next = static_cast<int64_t>(k0 + kTile) * d;

    // S = Q K^T for rows r0, r0 + 8 and the tile's 64 keys, 8 per fragment.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    cp_async_wait<1>();
    __syncthreads();  // K of tile j has landed
    // Each 64-column chunk summed from 0 in the tensor cores and added in
    // float32 (the first straight into S, so NC = 1 is one chain as it
    // was).
    qk_cols<NC>(s, qs, ks, r0, g, t, 0, 64);
#pragma unroll
    for (int cb = 1; cb < NC; ++cb) {
      float part[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
      qk_cols<NC>(part, qs, ks, r0, g, t, 64 * cb, 64 * cb + 64);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
    }
    __syncthreads();  // every warp is done with K
    if (j + 1 < n_kt) stage(ks, kb + next, d, qk_ds, w);
    cp_async_commit();

    float alpha[2];
    softmax_tile(s, m_i, l_i, best, alpha, bias, scale, causal, q_off, k_off,
                 q0, k0, r0, t, lane, sk);

    cp_async_wait<1>();
    __syncthreads();  // V of tile j has landed
#pragma unroll
    for (int cb = 0; cb < NC; ++cb) {
      float pv[8][4];
      pv_tile(pv, s, vs + cb * 64, v_ds, g, t);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[cb * 8 + i][e] =
              fmaf(alpha[e >> 1], acc[cb * 8 + i][e], pv[i][e]);
    }
    __syncthreads();  // every warp is done with V
    if (j + 1 < n_kt) stage(vs, vb + next, d, v_ds, w);
    cp_async_commit();
  }

  float mf[2], f[2];
  exact_max(mf, f, m_i, best, qs, qk_ds, kb, bias, scale, causal, q_off,
            k_off, q0, r0, t, lane, sk, d);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = bh * sq + q0 + r0 + 8 * h;
    float* orow = o + r * d + 2 * t;
#pragma unroll
    for (int jj = 0; jj < NC * 8; ++jj)
      if (jj * 8 < d)
        *reinterpret_cast<float2*>(orow + jj * 8) =
            make_float2(acc[jj][2 * h] * f[h], acc[jj][2 * h + 1] * f[h]);
    if (t == 0) {
      m_out[r] = mf[h];
      l_out[r] = l_i[h] * f[h];
    }
  }
}

// ---------------------------------------------------------------------------
// The wide instances (D > 128): two warpgroups a 64-row q tile.
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 256;
constexpr int kWg = 128;                       // threads a warpgroup
constexpr int kXchFloats = 4 * 8 * 32 * 4;     // [warp][fragment][lane][4]
constexpr int kStages = 2;                     // each warpgroup's ring

// Shared rows, in elements: a stage's K chunk (and streamed Q chunk) and
// V chunk, and the resident Q. A warp's fragment loads of 8 rows then
// fall on distinct banks: 8-byte float loads with rows 8 banks apart,
// 4-byte bfloat16 loads with rows 4 banks apart, V's 4-byte float loads
// of rows 2t and 2t + 1 with rows 4 banks apart.
template <typename T>
struct WideRows;
template <>
struct WideRows<float> {
  static constexpr int kK = 64 + 8, kV = 64 + 4;
  static __host__ __device__ int q(int d) { return (d + 31) / 32 * 32 + 8; }
};
template <>
struct WideRows<__nv_bfloat16> {
  static constexpr int kK = 64 + 8, kV = 64 + 8;
  static __host__ __device__ int q(int d) { return (d + 63) / 64 * 64 + 8; }
};

template <typename T, bool STREAM_Q>
__host__ __device__ constexpr int stage_elems() {
  return (STREAM_Q ? 2 : 1) * kTile * WideRows<T>::kK;
}

// The S exchange, each warpgroup's ring and, unless Q is streamed, the
// resident Q of d columns.
template <typename T, bool STREAM_Q>
size_t wide_smem_bytes(int d) {
  size_t n = kXchFloats * sizeof(float) +
             size_t(2) * kStages * stage_elems<T, STREAM_Q>() * sizeof(T);
  if (!STREAM_Q) n += size_t(kTile) * WideRows<T>::q(d) * sizeof(T);
  return n;
}

// A 64-row chunk of w columns (w <= 64, w % 8 == 0) of a row-major matrix
// with rows ld elements apart into shared rows ds apart, by the 128
// threads of a warpgroup (tid its thread), as 16-byte cp.async: a thread
// copies the same 16 bytes of every 8th (float) or 16th (bfloat16) row.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, int ds, const T* src,
                                           int ld, int w, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  constexpr int kPerRow = kTile / kPer;
  constexpr int kRows = kWg / kPerRow;  // rows a pass
  const int c = (tid % kPerRow) * kPer;
  if (c >= w) return;
  const int r = tid / kPerRow;
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i)
    cp_async16(dst + (r + kRows * i) * ds + c,
               src + static_cast<int64_t>(r + kRows * i) * ld + c);
}

// S += Q K^T over the w live columns of a chunk (w <= 64, w % 8 == 0):
// Q rows qds apart, K rows WideRows<T>::kK apart. The loop ends at w, so
// no other column adds anything.
template <typename T>
__device__ __forceinline__ void qk_chunk(float (&s)[8][4], const T* qs,
                                         int qds, const T* ks, int r0,
                                         int g, int t, int w) {
#pragma unroll
  for (int c = 0; c < kTile; c += 8) {
    if (c >= w) break;
    const float2 qa = ld2(qs + r0 * qds + c + 2 * t);
    const float2 qb = ld2(qs + (r0 + 8) * qds + c + 2 * t);
    const float a[4] = {qa.x, qb.x, qa.y, qb.y};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 kk = ld2(ks + (n * 8 + g) * WideRows<T>::kK + c + 2 * t);
      mma3(s[n], ah, al, kk.x, kk.y);
    }
  }
}

// NVC: 64-column chunks of O a warpgroup holds (2, 3 or 4; a warp keeps
// NVC * 8 fragments of its 16 rows); STREAM_Q: Q's chunks come through
// the ring with K's (heads wider than 512, whose output columns then
// split over CTAs in spans of 2 NVC * 64).
template <typename T, int NVC, bool STREAM_Q>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int n_bh, int sq, int sk, int d,
                  float scale, int causal, int64_t q_off, int64_t k_off) {
  using Rows = WideRows<T>;
  constexpr int kStage = stage_elems<T, STREAM_Q>();
  extern __shared__ float4 smem4[];
  float* xch = reinterpret_cast<float*>(smem4);
  T* ring = reinterpret_cast<T*>(xch + kXchFloats);
  T* qs = ring + 2 * kStages * kStage;  // the resident Q, unless streamed
  const int qds = STREAM_Q ? Rows::kK : Rows::q(d);

  // The q tiles with the most k tiles launch first.
  const int n_qt = sq / kTile;
  const int64_t bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * kTile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = threadIdx.x / kWg;           // warpgroup
  const int warp = (threadIdx.x >> 5) & 3;    // warp within it
  const int tid = threadIdx.x & (kWg - 1);
  const int r0 = warp * 16 + g;               // rows r0, r0 + 8
  const T* qb = q + (bh * sq + q0) * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  const int n_kt = k_tiles(sk, bias, causal, q_off, k_off, q0);

  // The CTA's output columns [c_lo, c_hi), n_oc chunks of 64: the first
  // half (rounded up) to warpgroup 0. The score columns split at s_mid so
  // that each warpgroup's score columns plus its P.V chunks' come to the
  // same work.
  const int c_lo = static_cast<int>(blockIdx.y) * 2 * NVC * 64;
  const int c_hi = min(d, c_lo + 2 * NVC * 64);
  const int n_oc = (c_hi - c_lo + 63) / 64;
  const int nv0 = (n_oc + 1) / 2;
  const int nvs = wg ? n_oc - nv0 : nv0;
  const int v_lo = c_lo + (wg ? 64 * nv0 : 0);
  const int v_hi = wg ? c_hi : min(c_hi, v_lo + 64 * nv0);
  const int s_mid = min(d, max(0, (d + 64 * (n_oc - 2 * nv0)) / 16 * 8));
  const int s_lo = wg ? s_mid : 0;
  const int s_hi = wg ? d : s_mid;
  const int nks = (s_hi - s_lo + 63) / 64;
  const int per_tile = nks + nvs;

  // This warpgroup's ring: step i holds, for k tile i / per_tile, its
  // score chunks and then its V chunks, issued kStages - 1 steps ahead;
  // every step commits one group (empty past the end), so "all but the
  // newest kStages - 2 groups" is always the step about to be read.
  T* my_ring = ring + wg * kStages * kStage;
  const int total = n_kt * per_tile;
  int issued = 0, iss_j = 0, iss_r = 0, iss_st = 0;
  auto issue = [&]() {
    if (issued < total) {
      T* dst = my_ring + iss_st * kStage;
      const int64_t row0 = static_cast<int64_t>(iss_j) * kTile * d;
      if (iss_r < nks) {
        const int c = s_lo + 64 * iss_r;
        const int w = min(64, s_hi - c);
        load_chunk(dst, Rows::kK, kb + row0 + c, d, w, tid);
        if constexpr (STREAM_Q)
          load_chunk(dst + kTile * Rows::kK, Rows::kK, qb + c, d, w, tid);
      } else {
        const int c = v_lo + 64 * (iss_r - nks);
        load_chunk(dst, Rows::kV, vb + row0 + c, d, min(64, v_hi - c), tid);
      }
      if (++iss_r == per_tile) {
        iss_r = 0;
        ++iss_j;
      }
    }
    cp_async_commit();
    ++issued;
    iss_st = iss_st + 1 == kStages ? 0 : iss_st + 1;
  };

  if constexpr (!STREAM_Q) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = d / kPer;
    for (int i = threadIdx.x; i < kTile * per_row; i += kWideThreads) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * kPer;
      cp_async16(qs + r * qds + c, qb + static_cast<int64_t>(r) * d + c);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();
  cp_async_wait<kStages - 2>();
  __syncthreads();  // Q (read by both warpgroups) has landed

  float acc[NVC * 8][4];
#pragma unroll
  for (int j = 0; j < NVC * 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.0f, 0.0f};
  int best[2] = {-1, -1};  // the key of each row's running max
  int st = 0;              // the stage about to be read
  float* xw = xch + warp * (8 * 32 * 4) + lane * 4;  // + 128 n: fragment n
  const int bar_wg = 1 + wg;
  const int bar_pair = 3 + warp;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;

    // This warpgroup's partial S over [s_lo, s_hi): each chunk summed
    // from 0 and added in float32.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    for (int r = 0; r < nks; ++r) {
      cp_async_wait<kStages - 2>();
      named_bar(bar_wg, kWg);  // the step's chunk has landed; the oldest
      issue();                 // stage is free
      const T* ks = my_ring + st * kStage;
      const int c = s_lo + 64 * r;
      float part[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
      if constexpr (STREAM_Q)
        qk_chunk(part, ks + kTile * Rows::kK, Rows::kK, ks, r0, g, t,
                 min(64, s_hi - c));
      else
        qk_chunk(part, qs + c, qds, ks, r0, g, t, min(64, s_hi - c));
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
      st = st + 1 == kStages ? 0 : st + 1;
    }

    // S = p0 + p1: warpgroup 1 posts its partial, warpgroup 0 takes it and
    // posts its own in the same slots, warpgroup 1 takes that.
    if (wg == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float4*>(xw + n * 128) =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    }
    named_bar(bar_pair, 64);
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(xw + n * 128);
        *reinterpret_cast<float4*>(xw + n * 128) =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        s[n][0] = s[n][0] + x.x;
        s[n][1] = s[n][1] + x.y;
        s[n][2] = s[n][2] + x.z;
        s[n][3] = s[n][3] + x.w;
      }
    }
    named_bar(bar_pair, 64);
    if (wg == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(xw + n * 128);
        s[n][0] = x.x + s[n][0];
        s[n][1] = x.y + s[n][1];
        s[n][2] = x.z + s[n][2];
        s[n][3] = x.w + s[n][3];
      }
    }

    float alpha[2];
    softmax_tile(s, m_i, l_i, best, alpha, bias, scale, causal, q_off, k_off,
                 q0, k0, r0, t, lane, sk);

    // O += P V over this warpgroup's chunks of columns.
#pragma unroll
    for (int vc = 0; vc < NVC; ++vc) {
      if (vc >= nvs) break;
      cp_async_wait<kStages - 2>();
      named_bar(bar_wg, kWg);
      issue();
      float pv[8][4];
      pv_tile(pv, s, my_ring + st * kStage, Rows::kV, g, t);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[vc * 8 + i][e] =
              fmaf(alpha[e >> 1], acc[vc * 8 + i][e], pv[i][e]);
      st = st + 1 == kStages ? 0 : st + 1;
    }
  }
  cp_async_wait<0>();  // nothing left in flight (the empty groups)

  float mf[2], f[2];
  if constexpr (STREAM_Q)
    exact_max(mf, f, m_i, best, qb, d, kb, bias, scale, causal, q_off, k_off,
              q0, r0, t, lane, sk, d);
  else
    exact_max(mf, f, m_i, best, static_cast<const T*>(qs), qds, kb, bias,
              scale, causal, q_off, k_off, q0, r0, t, lane, sk, d);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = bh * sq + q0 + r0 + 8 * h;
    float* orow = o + r * d + 2 * t;
#pragma unroll
    for (int vc = 0; vc < NVC; ++vc) {
      if (vc >= nvs) break;
      const int c = v_lo + 64 * vc;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + 8 * i < v_hi)
          *reinterpret_cast<float2*>(orow + c + 8 * i) =
              make_float2(acc[vc * 8 + i][2 * h] * f[h],
                          acc[vc * 8 + i][2 * h + 1] * f[h]);
    }
    if (t == 0 && wg == 0 && blockIdx.y == 0) {
      m_out[r] = mf[h];
      l_out[r] = l_i[h] * f[h];
    }
  }
}

// The instances: each names its kernel, threads a CTA, shared memory for
// heads of width d and the most it takes (set as the opt-in), and CTAs a
// q tile.
// kIndex: the instance's index in ops/attention.py::B6_INSTANCE_NAMES,
// which mv_flash_block_attn reports for every launch.
template <typename T, int NC>
struct Narrow {
  using Elem = T;
  static constexpr int kIndex = NC - 1;
  static constexpr int kCtaThreads = kThreads;
  static auto kernel() { return flash_block_kernel<T, NC>; }
  static size_t smem(int) { return smem_bytes(NC); }
  static size_t max_smem() { return smem_bytes(NC); }
  static unsigned spans(int) { return 1; }
};

template <typename T, int NVC, bool STREAM_Q>
struct Wide {
  using Elem = T;
  static constexpr int kIndex = STREAM_Q ? 5 : NVC;
  static constexpr int kCtaThreads = kWideThreads;
  static constexpr int kSpan = 2 * NVC * 64;  // output columns a CTA
  static auto kernel() { return flash_wide_kernel<T, NVC, STREAM_Q>; }
  static size_t smem(int d) { return wide_smem_bytes<T, STREAM_Q>(d); }
  static size_t max_smem() { return smem(kSpan); }
  static unsigned spans(int d) { return (d + kSpan - 1) / kSpan; }
};

// fn(instance) for the instance that takes heads of width d.
template <typename T, typename Fn>
int with_instance(int d, Fn fn) {
  switch ((d + 63) / 64) {
    case 1:
      return fn(Narrow<T, 1>());
    case 2:
      return fn(Narrow<T, 2>());
    case 3:
    case 4:
      return fn(Wide<T, 2, false>());
    case 5:
    case 6:
      return fn(Wide<T, 3, false>());
    case 7:
    case 8:
      return fn(Wide<T, 4, false>());
    default:
      return fn(Wide<T, 4, true>());
  }
}

// The opt-in to more than 48 KB of shared memory is set once per instance
// (the attribute is per device: one card per process), so no launch
// captured in a CUDA graph makes the call.
template <typename I>
int opt_in() {
  static bool done = false;
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      I::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(I::max_smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <typename I>
int launch(const void* q, const void* k, const void* v, const float* bias,
           float* o, float* m, float* l, int64_t bh, int sq, int sk, int d,
           float scale, int causal, int64_t q_off, int64_t k_off,
           cudaStream_t st) {
  using T = typename I::Elem;
  if (const int err = opt_in<I>()) return err;
  const dim3 grid(static_cast<unsigned>(bh * (sq / kTile)), I::spans(d));
  const auto kernel = I::kernel();
  kernel<<<grid, I::kCtaThreads, I::smem(d), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, o, m, l, static_cast<int>(bh), sq, sk,
      d, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

// out = {threads a CTA, shared memory bytes, registers a thread, local
// (spill) bytes a thread, CTAs an SM} of the instance for heads of width
// d, read from the runtime.
template <typename I>
int describe(int d, int* out) {
  if (const int err = opt_in<I>()) return err;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, I::kernel());
  if (err != cudaSuccess) return static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, I::kernel(), I::kCtaThreads, I::smem(d));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = I::kCtaThreads;
  out[1] = static_cast<int>(I::smem(d));
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = ctas;
  return 0;
}

}  // namespace

extern "C" {

// q [bh, sq, d], k and v [bh, sk, d], all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1), contiguous and 16-byte aligned; bias [sq, sk]
// float32 or null. Writes o [bh, sq, d], m and l [bh, sq], float32.
// Returns cudaGetLastError() after the launch (0 = launched); shapes the
// kernel does not take return cudaErrorInvalidValue and launch nothing.
// Where `instance` is not null, the index of the instance that took the
// launch (its kIndex: 0-1 narrow, 2-5 wide) goes there, -1 where nothing
// was dispatched.
int mv_flash_block_attn(const void* q, const void* k, const void* v,
                        const float* bias, float* o, float* m, float* l,
                        int64_t bh, int sq, int sk, int d, float scale,
                        int causal, int64_t q_off, int64_t k_off, int bf16,
                        void* stream, int* instance) {
  int taken = -1;
  if (instance == nullptr) instance = &taken;
  *instance = -1;
  if (bh <= 0 || sq <= 0) return 0;
  if (sq % kTile != 0 || sk <= 0 || sk % kTile != 0 || d <= 0 ||
      d % 8 != 0 || bh * (sq / kTile) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto go = [&](auto inst) {
    *instance = decltype(inst)::kIndex;
    return launch<decltype(inst)>(q, k, v, bias, o, m, l, bh, sq, sk, d,
                                  scale, causal, q_off, k_off, st);
  };
  return bf16 ? with_instance<__nv_bfloat16>(d, go)
              : with_instance<float>(d, go);
}

// The launch shape and resources of the instance that takes heads of
// width d (d > 0, d % 8 == 0) into out[5] (see describe); returns a CUDA
// error code (0 = read).
int mv_flash_block_attn_describe(int d, int bf16, int* out) {
  if (d <= 0 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto inst) { return describe<decltype(inst)>(d, out); };
  return bf16 ? with_instance<__nv_bfloat16>(d, go)
              : with_instance<float>(d, go);
}

}  // extern "C"
