// Stateful row updates of the parameter-server table plane, for Hopper
// (sm_90a).
//
// mv_fused_stateful_rows replaces
// multiverso_tpu/ops/pallas_rows.py::fused_stateful_rows (B3): one
// in-place gather -> updater math -> scatter over the table AND every
// state leaf of a momentum_sgd, adagrad or ftrl updater. The ids come
// duplicate-combined (unique, dropped lanes hold the sentinel num_rows),
// so no two lanes touch one row and the lanes need no ordering.
//
// mv_fold_sorted_runs_{f32,f64} is the fold of that combine
// (multiverso_tpu_torch/core/updater.py::combine_duplicate_rows; an XLA
// segment_sum in the JAX package, no Pallas kernel): each run of equal
// sorted ids sums its deltas in lane order, 0 + d0 + d1 + ..., and every
// lane of the run gets the run's total. The CPU's index_add_ adds in that
// order; the card's adds with atomics in no fixed order, so this kernel
// takes its place there and gives the CPU's bits.
//
// What bounds them on this card: bytes. B3 reads and writes a row of the
// table and of each leaf and reads a delta row per unique id, with a dozen
// float operations per element at most; the fold reads and writes each
// delta row once. Both are far below the ~20 flop/byte at which an H100's
// arithmetic would matter.
//
// Design. The TPU kernel moves 8 lanes per grid step by per-row DMA. Here
// one warp owns one lane (B3) or one run (fold), its threads striding over
// the row's columns so that neighbouring threads read neighbouring
// addresses (B3 with the widest vector loads the width and alignment
// allow), and the grid strides over the lanes so any N fills the card. A lane whose id is out
// of range (the sentinel) is skipped: the TPU kernel loads it clamped and
// writes nothing, which leaves memory the same. No float atomics.
//
// Rounding. The math is written with the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), one rounding
// per torch op in the order of the updater's rows_math
// (multiverso_tpu_torch/core/updater.py), and the file is built with
// --fmad=false as well: nvcc would otherwise contract a*b + c into one
// fused multiply-add, which torch's eager ops never do. So the kernel is
// bitwise-equal to the plain version on the card and on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Kind { kMomentum = 0, kAdaGrad = 1, kFtrl = 2 };

// The option scalars, already float32 (AddOption.scalars() through
// np.float32, as the plain version's _f32 makes them).
struct Opts {
  float p0, p1, p2, p3;
};

// momentum_sgd: smooth = m*smooth + (1-m)*delta; data -= smooth.
// p0 = momentum.
__device__ __forceinline__ void momentum(float& w, float& smooth, float g,
                                         const Opts& o) {
  const float one_minus_m = __fsub_rn(1.f, o.p0);
  smooth = __fadd_rn(__fmul_rn(o.p0, smooth), __fmul_rn(one_minus_m, g));
  w = __fsub_rn(w, smooth);
}

// adagrad: g = delta/lr (lr <= 0 reads as 1); g2 += g*g;
// data -= rho / sqrt(g2 + eps) * g. p0 = lr, p1 = rho, p2 = eps.
__device__ __forceinline__ void adagrad(float& w, float& g2, float delta,
                                        const Opts& o) {
  const float lr = o.p0 > 0.f ? o.p0 : 1.f;
  const float g = __fdiv_rn(delta, lr);
  g2 = __fadd_rn(g2, __fmul_rn(g, g));
  const float step =
      __fmul_rn(__fdiv_rn(o.p1, __fsqrt_rn(__fadd_rn(g2, o.p2))), g);
  w = __fsub_rn(w, step);
}

// ftrl: n' = n + g*g; sigma = (sqrt(n') - sqrt(n)) / alpha;
// z' = z + g - sigma*w; w' = |z'| > l1 ?
// -(z' - sign(z')*l1) / ((beta + sqrt(n'))/alpha + l2) : 0.
// p0 = l2 (momentum), p1 = alpha (lr), p2 = beta (rho), p3 = l1 (lambda).
// w, z and n are all read before any of them is written.
__device__ __forceinline__ void ftrl(float& w, float& z, float& n, float g,
                                     const Opts& o) {
  const float n_new = __fadd_rn(n, __fmul_rn(g, g));
  const float sq_new = __fsqrt_rn(n_new);
  const float sigma = __fdiv_rn(__fsub_rn(sq_new, __fsqrt_rn(n)), o.p1);
  const float z_new = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, w));
  const float sign = (float)((0.f < z_new) - (z_new < 0.f));
  const float num = -__fsub_rn(z_new, __fmul_rn(sign, o.p3));
  const float den =
      __fadd_rn(__fdiv_rn(__fadd_rn(o.p2, sq_new), o.p1), o.p0);
  w = fabsf(z_new) > o.p3 ? __fdiv_rn(num, den) : 0.f;
  z = z_new;
  n = n_new;
}

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int KIND, int VEC>
__device__ __forceinline__ void apply(float* w, float* a, float* b,
                                      const float* g, const Opts& o) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    if (KIND == kMomentum) momentum(w[q], a[q], g[q], o);
    if (KIND == kAdaGrad) adagrad(w[q], a[q], g[q], o);
    if (KIND == kFtrl) ftrl(w[q], a[q], b[q], g[q], o);
  }
}

// leaf_a: smooth (momentum), g2 (adagrad, [W, R, D], plane wid) or z
// (ftrl); leaf_b: n (ftrl) or unused.
template <int KIND, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_stateful_kernel(float* __restrict__ table, float* __restrict__ leaf_a,
                      float* __restrict__ leaf_b,
                      const int32_t* __restrict__ ids,
                      const float* __restrict__ deltas, int64_t n,
                      int64_t num_rows, int d, int64_t wid, Opts o) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int dv = d / VEC;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < n; i += nwarps) {
    const int64_t r = ids[i];
    if (r < 0 || r >= num_rows) continue;  // sentinel: writes nothing
    // AdaGrad's accumulator is per worker: row r of plane wid, in 64-bit
    // arithmetic (W * R * D passes 2^31 elements at W >= 43 for 1M x 50).
    const int64_t leaf_row = KIND == kAdaGrad ? wid * num_rows + r : r;
    V* wp = reinterpret_cast<V*>(table + r * d);
    V* ap = reinterpret_cast<V*>(leaf_a + leaf_row * d);
    V* bp = KIND == kFtrl ? reinterpret_cast<V*>(leaf_b + r * d) : nullptr;
    const V* gp = reinterpret_cast<const V*>(deltas + i * d);
    for (int c = lane; c < dv; c += 32) {
      V w = wp[c], a = ap[c], g = __ldg(gp + c), b = a;
      if (KIND == kFtrl) b = bp[c];
      apply<KIND, VEC>(reinterpret_cast<float*>(&w),
                       reinterpret_cast<float*>(&a),
                       reinterpret_cast<float*>(&b),
                       reinterpret_cast<const float*>(&g), o);
      wp[c] = w;
      ap[c] = a;
      if (KIND == kFtrl) bp[c] = b;
    }
  }
}

// One warp per run, one thread per column: a float32 or float64 table's
// deltas (the stateful updaters run on either).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_sorted_runs_kernel(const int64_t* __restrict__ ids,
                        const T* __restrict__ deltas, T* __restrict__ out,
                        int64_t n, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < n; s += nwarps) {
    const int64_t r = ids[s];
    if (s > 0 && ids[s - 1] == r) continue;  // not the start of a run
    int64_t e = s + 1;
    while (e < n && ids[e] == r) ++e;
    for (int c = lane; c < d; c += 32) {
      T acc = 0;
      for (int64_t j = s; j < e; ++j) acc = acc + __ldg(deltas + j * d + c);
      for (int64_t j = s; j < e; ++j) out[j * d + c] = acc;
    }
  }
}

int grid_for(int64_t warps_needed) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t per_block = kThreads / 32;
  int64_t blocks = (warps_needed + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sms * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

int vec_width(const void* const (&ptrs)[4], int d) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  if (d % 4 == 0 && bits % 16 == 0) return 4;
  if (d % 2 == 0 && bits % 8 == 0) return 2;
  return 1;
}

template <int KIND>
void launch_fused(int grid, cudaStream_t st, int vec, float* table,
                  float* leaf_a, float* leaf_b, const int32_t* ids,
                  const float* deltas, int64_t n, int64_t num_rows, int d,
                  int64_t wid, Opts o) {
  switch (vec) {
    case 4:
      fused_stateful_kernel<KIND, 4><<<grid, kThreads, 0, st>>>(
          table, leaf_a, leaf_b, ids, deltas, n, num_rows, d, wid, o);
      break;
    case 2:
      fused_stateful_kernel<KIND, 2><<<grid, kThreads, 0, st>>>(
          table, leaf_a, leaf_b, ids, deltas, n, num_rows, d, wid, o);
      break;
    default:
      fused_stateful_kernel<KIND, 1><<<grid, kThreads, 0, st>>>(
          table, leaf_a, leaf_b, ids, deltas, n, num_rows, d, wid, o);
  }
}

}  // namespace

extern "C" {

// kind: 0 momentum_sgd (leaf_a = smooth; p0 = momentum), 1 adagrad
// (leaf_a = g2 [W, R, D], plane wid; p0 = lr, p1 = rho, p2 = eps), 2 ftrl
// (leaf_a = z, leaf_b = n; p0 = l2, p1 = alpha, p2 = beta, p3 = l1).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue (1) for an unknown kind.
int mv_fused_stateful_rows(int kind, float* table, float* leaf_a,
                           float* leaf_b, const int32_t* ids,
                           const float* deltas, int64_t n, int64_t num_rows,
                           int d, int64_t wid, float p0, float p1, float p2,
                           float p3, void* stream) {
  if (kind < kMomentum || kind > kFtrl) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  const Opts o{p0, p1, p2, p3};
  const void* ptrs[] = {table, leaf_a, kind == kFtrl ? leaf_b : leaf_a,
                        deltas};
  const int vec = vec_width(ptrs, d);
  if (kind == kMomentum)
    launch_fused<kMomentum>(grid, st, vec, table, leaf_a, leaf_b, ids,
                            deltas, n, num_rows, d, wid, o);
  else if (kind == kAdaGrad)
    launch_fused<kAdaGrad>(grid, st, vec, table, leaf_a, leaf_b, ids, deltas,
                           n, num_rows, d, wid, o);
  else
    launch_fused<kFtrl>(grid, st, vec, table, leaf_a, leaf_b, ids, deltas,
                        n, num_rows, d, wid, o);
  return (int)cudaGetLastError();
}

// out[j] = the sum, in lane order from 0, of deltas[s..e) for the run
// [s, e) of equal sorted ids that holds lane j.
int mv_fold_sorted_runs_f32(const int64_t* ids, const float* deltas,
                            float* out, int64_t n, int d, void* stream) {
  if (n <= 0) return 0;
  fold_sorted_runs_kernel<float>
      <<<grid_for(n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          ids, deltas, out, n, d);
  return (int)cudaGetLastError();
}

int mv_fold_sorted_runs_f64(const int64_t* ids, const double* deltas,
                            double* out, int64_t n, int d, void* stream) {
  if (n <= 0) return 0;
  fold_sorted_runs_kernel<double>
      <<<grid_for(n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          ids, deltas, out, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
