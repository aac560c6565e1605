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
// pallas_attention.py:201-245): per page, m_new = max(m, pagemax(s)),
// alpha = exp(m - m_new), l = alpha * l + sum(exp(s - m_new)),
// acc = alpha * acc + exp(s - m_new) . V, with m starting at -1e30 (not
// -inf: a fully masked page before a valid one is wiped by
// alpha = exp(-1e30 - m) = 0, and -inf - -inf would give NaN). The
// output is normalised, o = acc / l, float32. Pages are float32 or
// bfloat16 and every operation is float32 (expf, no fast math, no tensor
// cores). Page-table entries are clamped into [0, n_phys) as the JAX
// step's mode="clip" gather does, so an idle slot whose row points at
// the garbage page 0 computes a finite row and never reads outside the
// pool.
//
// What bounds it on this card: bytes. The function needs the K and V row
// of each key the mask admits (a masked key adds exactly 0) for 4 * dh
// flops per key, about 0.5 flop per byte in float32, far below the
// card's ~20 flops per byte of float32 HBM balance. At the serving shape
// (8 slots, 12 heads, dh 64, page 16, G 36) this kernel reads every row
// of all G pages, 28.3 MB of float32 pages a step, while the admitted
// keys of chip_smoke.py's serving inputs need 8.4 MB, ~2.5 us at
// 3.35 TB/s.
//
// Design, a simple first version. The TPU kernel walks a sequential
// (slot, page) grid whose page axis carries (acc, m, l) in VMEM scratch.
// Here one CTA of 4 warps owns one (slot, head); warp w takes logical
// pages j = w, w + 4, ... and keeps its own (acc, m, l):
//   * it stages the page's K and V rows [P, dh] into its shared memory as
//     float32, rows padded to dh + 1 floats so that lanes reading
//     different rows at one column fall on distinct banks;
//   * lane p computes key p's score (a sequential dot over dh), the warp
//     takes the page max and sum by xor shuffles, and writes exp(s - m)
//     to shared memory;
//   * lane owns output columns lane + 32 c and accumulates p . V there.
// The four warps then merge their (acc, m, l) through shared memory and
// write acc / l. Every page is read, masked or not, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;        // H100: 227 KB a block may opt in
constexpr float kNegInf = -1e30f;       // pallas_attention.py NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Floats of dynamic shared memory: q, each warp's K, V and p tiles, and
// the merge area (m, l and acc of each warp).
size_t smem_floats(int page, int d) {
  return static_cast<size_t>(d) +
         static_cast<size_t>(kWarps) * (2 * page * (d + 1) + page) +
         2 * kWarps + static_cast<size_t>(kWarps) * d;
}

// NC: output columns per lane, ceil(d / 32).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ ptab,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tstep, float* __restrict__ o,
                    int heads, int n_pages, int page, int d,
                    int64_t page_stride, int n_phys, int bucket,
                    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rs = d + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qs = smem;
  float* ks = qs + d + warp * (2 * page * rs + page);
  float* vs = ks + page * rs;
  float* ps = vs + page * rs;
  float* wm = qs + d + kWarps * (2 * page * rs + page);
  float* wl = wm + kWarps;
  float* wacc = wl + kWarps;

  const int64_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh - static_cast<int64_t>(b) * heads);
  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = q[bh * d + i];
  __syncthreads();

  const int length = lengths[b];
  const int t = tstep[b];
  const int64_t head_off = static_cast<int64_t>(h) * page * d;
  const int pd = page * d;
  float m = kNegInf;
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int j = warp; j < n_pages; j += kWarps) {
    int phys = ptab[static_cast<int64_t>(b) * n_pages + j];
    phys = min(max(phys, 0), n_phys - 1);
    const T* kb = kp + phys * page_stride + head_off;
    const T* vb = vp + phys * page_stride + head_off;
    for (int i = lane; i < pd; i += 32) {
      const int r = i / d;
      const int c = i - r * d;
      ks[r * rs + c] = to_f(kb[i]);
      vs[r * rs + c] = to_f(vb[i]);
    }
    __syncwarp();
    float lmax = -INFINITY;
    for (int p = lane; p < page; p += 32) {
      const float* kr = ks + p * rs;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qs[c], kr[c], s);
      s *= scale;
      const int pos = j * page + p;
      const bool valid =
          pos < length || (pos >= bucket && pos <= bucket + t);
      s += valid ? 0.f : kNegInf;
      ps[p] = s;
      lmax = fmaxf(lmax, s);
    }
    const float m_new = fmaxf(m, warp_max(lmax));
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
    for (int p = lane; p < page; p += 32) {
      const float e = expf(ps[p] - m_new);
      ps[p] = e;
      lsum += e;
    }
    l = alpha * l + warp_sum(lsum);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        float a = 0.f;
        for (int p = 0; p < page; ++p) a = fmaf(ps[p], vs[p * rs + col], a);
        acc[c] = acc[c] * alpha + a;
      }
    }
    m = m_new;
    __syncwarp();       // the next page overwrites this warp's tiles
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = lane + 32 * c;
    if (col < d) wacc[warp * d + col] = acc[c];
  }
  __syncthreads();
  float mx = wm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wm[w]);
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float sum_l = 0.f;
    float sum_o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(wm[w] - mx);
      sum_l += wl[w] * a;
      sum_o += wacc[w * d + col] * a;
    }
    o[bh * d + col] = sum_o / sum_l;
  }
}

template <typename T, int NC>
int launch(const float* q, const void* kp, const void* vp, const int* ptab,
           const int* lengths, const int* t, float* o, int batch, int heads,
           int n_pages, int page, int d, int64_t page_stride, int n_phys,
           int bucket, float scale, cudaStream_t st) {
  // Set once per instance, to the most any launch may use (the attribute
  // is per device: one card per process), so that no launch captured in
  // a CUDA graph makes the call.
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const size_t smem = smem_floats(page, d) * sizeof(float);
  const unsigned grid = static_cast<unsigned>(batch) * heads;
  paged_decode_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ptab, lengths,
      t, o, heads, n_pages, page, d, page_stride, n_phys, bucket, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const float* q, const void* kp, const void* vp, const int* ptab,
             const int* lengths, const int* t, float* o, int batch,
             int heads, int n_pages, int page, int d, int64_t page_stride,
             int n_phys, int bucket, float scale, cudaStream_t st) {
#define MV_PAGED_CASE(NC)                                                   \
  return launch<T, NC>(q, kp, vp, ptab, lengths, t, o, batch, heads,        \
                       n_pages, page, d, page_stride, n_phys, bucket, scale, \
                       st)
  switch ((d + 31) / 32) {
    case 1: MV_PAGED_CASE(1);
    case 2: MV_PAGED_CASE(2);
    case 3:
    case 4: MV_PAGED_CASE(4);
    default: MV_PAGED_CASE(8);
  }
#undef MV_PAGED_CASE
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one launch takes at this page and head
// size (the wrapper refuses what the card cannot give a block).
int64_t mv_paged_decode_attn_smem_bytes(int page, int d) {
  return static_cast<int64_t>(smem_floats(page, d) * sizeof(float));
}

// q [batch, heads, d] float32; kp and vp one layer of the page pool,
// [n_phys, heads, page, d] with rows of a page contiguous per head and
// page_stride elements between pages, float32 (bf16 == 0) or bfloat16
// (bf16 == 1); ptab [batch, n_pages], lengths and t [batch], int32.
// Writes o [batch, heads, d] float32. Returns cudaGetLastError() after the
// launch (0 = launched); shapes the kernel does not take return
// cudaErrorInvalidValue and launch nothing.
int mv_paged_decode_attn(const float* q, const void* kp, const void* vp,
                         const int* ptab, const int* lengths, const int* t,
                         float* o, int batch, int heads, int n_pages,
                         int page, int d, int64_t page_stride, int n_phys,
                         int bucket, float scale, int bf16, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (n_pages <= 0 || page <= 0 || d <= 0 || d > kMaxD || n_phys <= 0 ||
      static_cast<int64_t>(batch) * heads > 0x7fffffffLL ||
      mv_paged_decode_attn_smem_bytes(page, d) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, kp, vp, ptab, lengths, t, o, batch,
                                   heads, n_pages, page, d, page_stride,
                                   n_phys, bucket, scale, st);
  return dispatch<float>(q, kp, vp, ptab, lengths, t, o, batch, heads,
                         n_pages, page, d, page_stride, n_phys, bucket,
                         scale, st);
}

}  // extern "C"
