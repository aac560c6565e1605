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
// Inputs are float32 or bfloat16 and every operation is float32 (expf, no
// fast math, no TF32 and no tensor cores), so the result is held to the
// plain float32 version within float32 rounding.
//
// What bounds it on this card: operations. The function needs 4*D flops
// for each (q, k) pair whose score counts (all BH*Sq*Sk of them without a
// mask; with the causal mask at equal offsets, only the ~Sq*Sk/2 pairs on
// or below the diagonal, as a masked score adds exactly 0 to a row that
// sees any key) and moves (2*Sq + 2*Sk)*BH*D floats: at the LM's
// GPT-2-small eval step (BH 96, S 1024, D 64, causal) that is 12.9 GFLOP
// against ~101 MB, ~0.192 ms at the 67 TFLOP/s float32 peak against
// ~0.030 ms of HBM time. This version computes every tile, so it does
// twice that work at the causal shape.
//
// Design, a simple first version. The TPU kernel walks a sequential grid
// whose innermost k dimension carries (o, m, l) in VMEM scratch. Here one
// CTA of 256 threads owns one 64-row q tile of one bh and loops over the
// 64-row k tiles itself, keeping (o, m, l) in registers:
//   * the q tile, and per step one K and one V tile, are staged into
//     dynamic shared memory as float32 rows padded by 4 floats, so the
//     16-byte loads of 8 neighbouring rows fall on distinct banks;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 16 i and k
//     columns tx + 16 j (i, j < 4): a 4 x 4 block of scores by float32 FMA
//     on the CUDA cores;
//   * a row's 64 scores live on the 16 threads of one half-warp, so its
//     max and sum are taken with four xor shuffles;
//   * p goes through shared memory, and the same thread then owns rows
//     ty + 16 i of o, columns 4 (tx + 16 jj) .. +3, in registers.
// Every tile is computed, masked or not, as on the TPU. Up to D = 256 the
// tiles fit in 220,160 bytes of shared memory (above 48 KB it needs the
// opt-in attribute, set at an instance's first launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // q rows and k rows per tile
constexpr int kPad = 4;                 // floats of padding per staged row
constexpr int kPStride = kTile + 16;    // row stride of the p tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;       // pallas_attention.py NEG_INF

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [0, 64) of a row-major [*, d] matrix into shared [64][d + kPad],
// as float32.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int d) {
  const int d4 = d / 4;
  const int ds = d + kPad;
  for (int i = threadIdx.x; i < kTile * d4; i += kThreads) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    *reinterpret_cast<float4*>(dst + r * ds + c) =
        load4(src + static_cast<int64_t>(r) * d + c);
  }
}

// NC: float4 column chunks of o per thread, ceil(d / 64).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out, int sq, int sk, int d,
                   float scale, int causal, int64_t q_off, int64_t k_off) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ds = d + kPad;
  float* qs = smem;
  float* ks = qs + kTile * ds;
  float* vs = ks + kTile * ds;
  float* ps = vs + kTile * ds;

  const int n_qt = sq / kTile;
  const int64_t bh = blockIdx.x / n_qt;
  const int q0 = static_cast<int>(blockIdx.x - bh * n_qt) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  stage(qs, q + (bh * sq + q0) * d, d);

  float acc[4][NC][4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0f;
  }

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    __syncthreads();  // the last tile's K, V and p are read
    stage(ks, kb + static_cast<int64_t>(k0) * d, d);
    stage(vs, vb + static_cast<int64_t>(k0) * d, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; c += 4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(qs + (ty + 16 * i) * ds + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = load4(ks + (tx + 16 * j) * ds + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qa[i].x * kc[j].x;
          s[i][j] += qa[i].y * kc[j].y;
          s[i][j] += qa[i].z * kc[j].z;
          s[i][j] += qa[i].w * kc[j].w;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int64_t q_pos = q_off + q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal) x = x + ((k_off + k0 + col > q_pos) ? kNegInf : 0.0f);
        if (bias != nullptr)
          x = x + bias[static_cast<int64_t>(q0 + row) * sk + k0 + col];
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[row * kPStride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncthreads();  // p is written

    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const int col = 4 * (tx + 16 * jj);
        if (col < d) {
          const float4 vv = load4(vs + c * ds + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj][0] += p[i] * vv.x;
            acc[i][jj][1] += p[i] * vv.y;
            acc[i][jj][2] += p[i] * vv.z;
            acc[i][jj][3] += p[i] * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = bh * sq + q0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = 4 * (tx + 16 * jj);
      if (col < d)
        *reinterpret_cast<float4*>(o + r * d + col) =
            make_float4(acc[i][jj][0], acc[i][jj][1], acc[i][jj][2],
                        acc[i][jj][3]);
    }
    if (tx == 0) {
      m_out[r] = m_i[i];
      l_out[r] = l_i[i];
    }
  }
}

size_t smem_bytes(int d) {
  return (3 * kTile * (d + kPad) + kTile * kPStride) * sizeof(float);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const float* bias,
           float* o, float* m, float* l, int64_t bh, int sq, int sk, int d,
           float scale, int causal, int64_t q_off, int64_t k_off,
           cudaStream_t st) {
  // The opt-in is set once per instance to the most any D of the
  // instance needs (the attribute is per device: one card per process),
  // so no launch captured in a CUDA graph makes the call.
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(64 * NC)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const size_t smem = smem_bytes(d);
  const unsigned grid = static_cast<unsigned>(bh * (sq / kTile));
  flash_block_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, o, m, l, sq, sk, d, scale, causal,
      q_off, k_off);
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
