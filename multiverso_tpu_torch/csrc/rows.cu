// Row kernels of the parameter-server table plane, for Hopper (sm_90a).
//
// mv_gather_rows replaces multiverso_tpu/ops/pallas_rows.py::gather_rows
// (B1): out[i] = table[ids[i]].
// mv_scatter_add_sorted_rows replaces
// multiverso_tpu/ops/pallas_rows.py::scatter_add_sorted_rows (B2):
// table[ids[i]] += sign * deltas[i] for ids sorted ascending, in place.
//
// What bounds them on this card: bytes. Both move whole rows (D floats)
// per id and do at most one add per element, far below the ~20 flop/byte
// an H100 needs before arithmetic matters, so the least time is the bytes
// over the 3.35 TB/s of HBM.
//
// Design. The TPU kernels move 8 rows per grid step by per-row DMA with
// the ids prefetched into scalar memory. Here one warp owns one row (B1)
// or one run of equal ids (B2); the row is moved with the widest vector
// loads its width and alignment allow (16 bytes when D % 4 == 0), so
// neighbouring threads read neighbouring addresses, and the grid strides
// over ids so any N fills the card. B2 uses no float atomics: a run is
// owned by one warp and folded in lane order, reproducing the TPU
// kernel's arithmetic exactly. The TPU kernel folds each aligned group of
// 8 lanes (acc = delta[k] + acc) and adds the group's partial sum to the
// row, group after group; the warp does the same group by group, so the
// result is bitwise-equal to the interpret-mode TPU kernel. The ids are
// padded there to a multiple of 8 with the last id and zero deltas; the
// last run's final group folds those zeros too.
//
// mv_tiled_scatter_add_sorted_rows replaces
// multiverso_tpu/ops/pallas_rows.py::tiled_scatter_add_sorted_rows (B4):
// the same update as B2, but each row takes its deltas one at a time in
// sorted order (row = row + sign*delta_j), the TPU kernel's rounding. The
// TPU kernel sweeps the whole table in 256-row tiles because a per-row DMA
// costs about a microsecond there; here that sweep would read and write
// the whole table to touch a few percent of it, so one warp owns each run
// of equal ids, as in B2, and walks its deltas in order. Bytes bound it
// too: one add per delta element.
//
// Ids outside [0, num_rows) are clamped (gather) or dropped (scatter) as
// a memory-safety guard; the table plane only passes in-range ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T neg(T a) { return -a; }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static T add(T a, T b) { return make_float2(a.x + b.x, a.y + b.y); }
  __device__ static T neg(T a) { return make_float2(-a.x, -a.y); }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  __device__ static T neg(T a) { return make_float4(-a.x, -a.y, -a.z, -a.w); }
};

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // the TPU kernel's sublane group of 4-byte rows

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ ids, float* __restrict__ out,
                   int64_t n, int64_t num_rows, int d) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int dv = d / VEC;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < n; i += nwarps) {
    int64_t r = ids[i];
    r = r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
    const V* src = reinterpret_cast<const V*>(table + r * d);
    V* dst = reinterpret_cast<V*>(out + i * d);
    for (int c = lane; c < dv; c += 32) dst[c] = __ldg(src + c);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_add_sorted_kernel(float* __restrict__ table,
                          const int32_t* __restrict__ ids,
                          const float* __restrict__ deltas, int64_t n,
                          int64_t num_rows, int d, float sign) {
  using V = typename Vec<VEC>::T;
  using O = Vec<VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int dv = d / VEC;
  const bool padded = (n % kGroup) != 0;
  for (int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < n; s += nwarps) {
    const int32_t r = ids[s];
    if (s > 0 && ids[s - 1] == r) continue;  // not the start of a run
    int64_t e = s + 1;
    while (e < n && ids[e] == r) ++e;
    if (r < 0 || r >= num_rows) continue;
    V* row = reinterpret_cast<V*>(table + (int64_t)r * d);
    for (int c = lane; c < dv; c += 32) {
      V v = row[c];
      int64_t j = s;
      while (j < e) {
        const int64_t group_end = (j / kGroup + 1) * kGroup;
        const int64_t stop = group_end < e ? group_end : e;
        V zero;
        float* z = reinterpret_cast<float*>(&zero);
        for (int q = 0; q < VEC; ++q) z[q] = 0.f;
        V acc = reinterpret_cast<const V*>(deltas + j * d)[c];
        // A run that starts inside a group folds onto the TPU kernel's
        // zero (delta + 0), which only differs from delta for -0.
        if (j % kGroup != 0) acc = O::add(acc, zero);
        for (int64_t k = j + 1; k < stop; ++k)
          acc = O::add(reinterpret_cast<const V*>(deltas + k * d)[c], acc);
        // The TPU kernel's zero-delta pad lanes continue the last run.
        if (padded && stop == n) acc = O::add(zero, acc);
        v = O::add(v, sign > 0.f ? acc : O::neg(acc));
        j = stop;
      }
      row[c] = v;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
tiled_scatter_add_sorted_kernel(float* __restrict__ table,
                                const int32_t* __restrict__ ids,
                                const float* __restrict__ deltas, int64_t n,
                                int64_t num_rows, int d, float sign) {
  using V = typename Vec<VEC>::T;
  using O = Vec<VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int dv = d / VEC;
  for (int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < n; s += nwarps) {
    const int32_t r = ids[s];
    if (s > 0 && ids[s - 1] == r) continue;  // not the start of a run
    if (r < 0 || r >= num_rows) continue;
    int64_t e = s + 1;
    while (e < n && ids[e] == r) ++e;
    V* row = reinterpret_cast<V*>(table + (int64_t)r * d);
    for (int c = lane; c < dv; c += 32) {
      V v = row[c];
      for (int64_t j = s; j < e; ++j) {
        const V step = reinterpret_cast<const V*>(deltas + j * d)[c];
        v = O::add(v, sign > 0.f ? step : O::neg(step));
      }
      row[c] = v;
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

int vec_width(const void* a, const void* b, int d) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b;
  if (d % 4 == 0 && bits % 16 == 0) return 4;
  if (d % 2 == 0 && bits % 8 == 0) return 2;
  return 1;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int mv_gather_rows(const float* table, const int32_t* ids, float* out,
                   int64_t n, int64_t num_rows, int d, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  switch (vec_width(table, out, d)) {
    case 4:
      gather_rows_kernel<4><<<grid, kThreads, 0, st>>>(table, ids, out, n,
                                                       num_rows, d);
      break;
    case 2:
      gather_rows_kernel<2><<<grid, kThreads, 0, st>>>(table, ids, out, n,
                                                       num_rows, d);
      break;
    default:
      gather_rows_kernel<1><<<grid, kThreads, 0, st>>>(table, ids, out, n,
                                                       num_rows, d);
  }
  return (int)cudaGetLastError();
}

int mv_scatter_add_sorted_rows(float* table, const int32_t* ids,
                               const float* deltas, int64_t n,
                               int64_t num_rows, int d, float sign,
                               void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  switch (vec_width(table, deltas, d)) {
    case 4:
      scatter_add_sorted_kernel<4><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, sign);
      break;
    case 2:
      scatter_add_sorted_kernel<2><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, sign);
      break;
    default:
      scatter_add_sorted_kernel<1><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, sign);
  }
  return (int)cudaGetLastError();
}

int mv_tiled_scatter_add_sorted_rows(float* table, const int32_t* ids,
                                     const float* deltas, int64_t n,
                                     int64_t num_rows, int d, float sign,
                                     void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  switch (vec_width(table, deltas, d)) {
    case 4:
      tiled_scatter_add_sorted_kernel<4><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, sign);
      break;
    case 2:
      tiled_scatter_add_sorted_kernel<2><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, sign);
      break;
    default:
      tiled_scatter_add_sorted_kernel<1><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, sign);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
