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
//     truncation does not build up over a long k walk;
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
// Shared memory: 54,272 bytes at D = 64, 103,424 at D = 128 and 201,728 at
// D = 256 (above 48 KB it needs the opt-in attribute, set at an
// instance's first launch). The registers and spills of each instance
// (-Xptxas -v) are printed by chip_smoke.py and kept in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;               // q rows and k rows per tile
constexpr int kQKPad = 8;               // floats of padding per Q, K row
constexpr int kVPad = 4;                // floats of padding per V row
constexpr int kMaxD = 256;
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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

// Rows [0, 64) of a row-major [*, d] matrix into shared rows of stride ds:
// float32 by cp.async (landed after the next wait), bfloat16 converted to
// float32 by plain loads and stores.
__device__ __forceinline__ void stage(float* dst, const float* src, int d,
                                      int ds, const Chunks& w) {
  for (int r = w.r0, c = w.c0; r < kTile;) {
    cp_async16(dst + r * ds + 4 * c, src + static_cast<int64_t>(r) * d + 4 * c);
    r += w.dr;
    c += w.dc;
    if (c >= w.d4) {
      c -= w.d4;
      ++r;
    }
  }
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int d, int ds, const Chunks& w) {
  for (int r = w.r0, c = w.c0; r < kTile;) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        src + static_cast<int64_t>(r) * d + 4 * c);
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
  constexpr int qk_ds = 64 * NC + kQKPad;
  constexpr int v_ds = 64 * NC + kVPad;
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
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  int n_kt = sk / kTile;
  if (causal && bias == nullptr && k_off <= q_off + q0) {
    const int64_t seen = q_off + q0 + kTile - k_off;  // keys the last row sees
    const int64_t walk = (seen + kTile - 1) / kTile;
    if (walk < n_kt) n_kt = static_cast<int>(walk);
  }

  // K and V are staged in turn: K of tile j + 1 lands while tile j's
  // softmax and P.V run, V of tile j + 1 while its Q.K^T runs. Every step
  // commits one cp.async group (empty at the end), so "all but the newest
  // group" is always the tile about to be read.
  if (d < 64 * NC)
    for (int i = threadIdx.x; i < 2 * kTile * qk_ds; i += kThreads)
      if (i % qk_ds >= d) qs[i] = 0.0f;  // qs and ks are adjacent
  const Chunks w = chunks_of(d);
  stage(qs, q + (bh * sq + q0) * d, d, qk_ds, w);
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
    cp_async_wait<1>();
    __syncthreads();  // K of tile j has landed

    // S = Q K^T for rows r0, r0 + 8 and the tile's 64 keys, 8 per fragment.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < 64 * NC; c += 8) {
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

    __syncthreads();  // every warp is done with K
    if (j + 1 < n_kt) stage(ks, kb + next, d, qk_ds, w);
    cp_async_commit();

    // Scale, mask and bias; each row's max, and its key when the max
    // grows. Masked: col - row > q_off + q0 - k_off - k0 (clamped, as
    // |col - row| < 64); a tile below the diagonal has no masked score.
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
    float alpha[2];
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

    cp_async_wait<1>();
    __syncthreads();  // V of tile j has landed
#pragma unroll
    for (int cb = 0; cb < NC; ++cb) {
      float pv[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float a[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        const float* v0 = vs + (n * 8 + 2 * t) * v_ds + cb * 64 + g;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mma3(pv[i], ah, al, v0[i * 8], v0[v_ds + i * 8]);
      }
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

  // m exactly: the running max's key rescored as a float32 FMA chain over
  // d in order, by thread t = h of the quad for row r0 + 8h.
  float m_exact = kNegInf;
  if (t < 2) {
    const int row = r0 + 8 * t;
    const int key = t == 0 ? best[0] : best[1];
    m_exact = t == 0 ? m_i[0] : m_i[1];
    if (key >= 0) {
      const float* qr = qs + row * qk_ds;
      const T* kr = kb + static_cast<int64_t>(key) * d;
      float dot = 0.0f;
      for (int c = 0; c < d; ++c) dot = fmaf(qr[c], to_float(kr[c]), dot);
      float x = dot * scale;
      if (causal) x = x + ((k_off + key > q_off + q0 + row) ? kNegInf : 0.0f);
      if (bias != nullptr)
        x = x + bias[static_cast<int64_t>(q0 + row) * sk + key];
      m_exact = x;
    }
  }
  float mf[2], f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mf[h] = __shfl_sync(kFull, m_exact, (lane & ~3) | h);
    f[h] = expf(m_i[h] - mf[h]);
  }

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

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const float* bias,
           float* o, float* m, float* l, int64_t bh, int sq, int sk, int d,
           float scale, int causal, int64_t q_off, int64_t k_off,
           cudaStream_t st) {
  // The opt-in is set once per instance (the attribute is per device: one
  // card per process), so no launch captured in a CUDA graph makes the
  // call.
  const size_t smem = smem_bytes(NC);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const unsigned grid = static_cast<unsigned>(bh * (sq / kTile));
  flash_block_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, o, m, l, static_cast<int>(bh), sq, sk,
      d, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* bias,
             float* o, float* m, float* l, int64_t bh, int sq, int sk, int d,
             float scale, int causal, int64_t q_off, int64_t k_off,
             cudaStream_t st) {
  switch ((d + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                          causal, q_off, k_off, st);
    case 2:
      return launch<T, 2>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                          causal, q_off, k_off, st);
    case 3:
      return launch<T, 3>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                          causal, q_off, k_off, st);
    default:
      return launch<T, 4>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                          causal, q_off, k_off, st);
  }
}

}  // namespace

extern "C" {

// q [bh, sq, d], k and v [bh, sk, d], all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1), contiguous and 16-byte aligned; bias [sq, sk]
// float32 or null. Writes o [bh, sq, d], m and l [bh, sq], float32.
// Returns cudaGetLastError() after the launch (0 = launched); shapes the
// kernel does not take return cudaErrorInvalidValue and launch nothing.
int mv_flash_block_attn(const void* q, const void* k, const void* v,
                        const float* bias, float* o, float* m, float* l,
                        int64_t bh, int sq, int sk, int d, float scale,
                        int causal, int64_t q_off, int64_t k_off, int bf16,
                        void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (sq % kTile != 0 || sk <= 0 || sk % kTile != 0 || d <= 0 ||
      d % 8 != 0 || d > kMaxD || bh * (sq / kTile) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, bias, o, m, l, bh, sq, sk, d,
                                   scale, causal, q_off, k_off, st);
  return dispatch<float>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                         causal, q_off, k_off, st);
}

}  // extern "C"
