// Row kernels of the parameter-server table plane, for Hopper (sm_90a).
//
// mv_gather_rows replaces multiverso_tpu/ops/pallas_rows.py::gather_rows
// (B1): out[i] = table[ids[i]].
// mv_scatter_add_sorted_rows replaces
// multiverso_tpu/ops/pallas_rows.py::scatter_add_sorted_rows (B2):
// table[ids[i]] += sign * deltas[i] for ids sorted ascending, in place.
// mv_tiled_scatter_add_sorted_rows replaces
// multiverso_tpu/ops/pallas_rows.py::tiled_scatter_add_sorted_rows (B4):
// the same update, each row taking its deltas one at a time in sorted
// order (row = row + sign*delta_j), the TPU kernel's rounding. The
// scatters take int32 ids, and int64 ids through the _i64 entry points,
// so the table plane's int64 ids are read where they lie, with no cast.
//
// What bounds them on this card: bytes. Each moves whole rows (D floats)
// per id and does at most one add per element, far below the ~20
// flop/byte an H100 needs before arithmetic matters, so the least time is
// the bytes over the 3.35 TB/s of HBM. A bytes-bound kernel there needs
// about 18 KB of loads in flight per SM (3.35 TB/s over 132 SMs times
// ~0.7 us of DRAM latency).
//
// Gather (B1): one warp per row, moved with the widest vector loads its
// width and alignment allow (16 bytes when D % 4 == 0), the grid striding
// over ids.
//
// Scatters (B2, B4). The TPU kernels move 8 rows per grid step by
// per-row DMA with the ids prefetched into scalar memory. Here a warp
// owns a tile of 32 consecutive sorted id slots:
// - Finding runs (runs.cuh): ballots over the tile mark where ids change,
//   and the warp owns the runs of equal ids that START in its tile (a run
//   has exactly one owner, so no float atomics).
// - Runs in flight: the warp's lanes form groups of G lanes, sized to the
//   row (G = 8 at D = 50: 25 float2 per row, 4 per lane; G = 8 at D = 128:
//   32 float4), so one warp updates 32 / G runs at once. Every lane issues
//   its row chunks' loads and the run's first delta's loads together,
//   before any add; loads of chunks past the row's end are clamped onto
//   its last chunk (no bound test between the loads) and not stored.
//   Deltas are read once, with the streaming hint (__ldcs), so the table
//   rows keep the L2.
// - Grid: when the tiles alone would not give each SM 32 warps, up to G
//   warps share one tile, each taking every G-th round of runs, so small
//   calls (B4's 8,192 ids) still spread over all 132 SMs.
// - Bytes in flight per SM at the main path's shape (B2: 100,000 int64
//   ids into 1,000,000 x 50; 71 registers a thread, so 3 blocks of 256
//   threads = 24 warps resident per SM): each warp has 4 runs in flight,
//   each a 200-byte row and a 200-byte delta, 1.6 KB; 24 warps hold
//   38 KB per SM, twice the 18 KB the card needs. A 64-register cap (32
//   warps) measured slower. What is left is the DRAM's granularity on
//   random 200-byte rows: 7 sectors of 32 bytes each, read and written.
// - No TMA: a D = 50 float32 row is 200 bytes, not a multiple of 16, so
//   rows at 200-byte strides break TMA's 16-byte stride rule. Plain
//   vector loads of 8 bytes (16 when D % 4 == 0 and the pointers are
//   16-byte aligned) fit any row.
//
// - Long runs (B4): a run of more than kLong lanes (pad lanes and
//   frequent ids of a word2vec step: tens of thousands of lanes of one
//   row) would hold one lane group for a memory latency per delta. The
//   group skips it; after the block's warps finish their tiles, the whole
//   block streams each such run's deltas (contiguous rows) through a ring
//   of kStages stages in shared memory by cp.async, kStages - 1 stages in
//   flight, and one thread per column adds them in order from there: the
//   same chain row + sign*delta_j, so the same bits.
//
// B2's arithmetic is the TPU kernel's, bit for bit: it folds each aligned
// group of 8 lanes (acc = delta[k] + acc; a run that starts inside a
// group folds onto the kernel's zero, delta + 0) and adds each group's
// partial to the row, group after group. The ids are padded there to a
// multiple of 8 with the last id and zero deltas, so the last run's final
// group folds those zeros too (0 + acc). B4 adds one delta at a time.
//
// Ids outside [0, num_rows) are clamped (gather) or dropped (scatter) as
// a memory-safety guard; the table plane only passes in-range ids.

#include <cuda_runtime.h>
#include <stdint.h>

#include "runs.cuh"

namespace {

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T neg(T a) { return -a; }
  __device__ static T zero() { return 0.f; }
  __device__ static T stream(const T* p) { return __ldcs(p); }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static T add(T a, T b) { return make_float2(a.x + b.x, a.y + b.y); }
  __device__ static T neg(T a) { return make_float2(-a.x, -a.y); }
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static T stream(const T* p) { return __ldcs(p); }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  __device__ static T neg(T a) { return make_float4(-a.x, -a.y, -a.z, -a.w); }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T stream(const T* p) { return __ldcs(p); }
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;   // the TPU kernel's sublane group of 4-byte rows
constexpr int kChunks = 4;  // vector chunks of a row per lane and pass

enum Fold { kGroupFold = 0, kEachDelta = 1 };  // B2, B4

// B4's long runs: runs of more than kLong lanes go through the block's
// ring, kStages stages of up to kRingRows rows in kRingBytes of dynamic
// shared memory (under 48 KB with the static), one thread per column, at
// most kMaxCols columns a thread (wider rows keep the lane-group path).
constexpr int kLong = 32;
constexpr int kStages = 4;
constexpr int kRingRows = 32;
constexpr int kRingBytes = 40 << 10;
constexpr int kMaxCols = 4;

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

// One run [s, e) of row r, by one lane group of G lanes (lane gl of it):
// the row's chunks gl, gl + G, ... in passes of G * kChunks chunks. The
// loops over a run's further deltas stay rolled: unrolled they cost
// registers, and so resident warps, that runs of one or two ids never use.
template <int FOLD, int VEC, int G>
__device__ void add_run(float* __restrict__ table,
                        const float* __restrict__ deltas, int64_t r,
                        int64_t s, int64_t e, int64_t n, int d, bool negate,
                        int gl) {
  using V = typename Vec<VEC>::T;
  using O = Vec<VEC>;
  const int dv = d / VEC;
  V* row = reinterpret_cast<V*>(table + r * d);
  const V* del = reinterpret_cast<const V*>(deltas);
  for (int base = 0; base < dv; base += G * kChunks) {
    int c[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int want = base + gl + G * q;
      c[q] = want < dv ? want : dv - 1;
    }
    V v[kChunks], a[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) v[q] = row[c[q]];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) a[q] = O::stream(del + s * dv + c[q]);
    if (FOLD == kEachDelta) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        v[q] = O::add(v[q], negate ? O::neg(a[q]) : a[q]);
#pragma unroll 1
      for (int64_t j = s + 1; j < e; ++j) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const V x = O::stream(del + j * dv + c[q]);
          v[q] = O::add(v[q], negate ? O::neg(x) : x);
        }
      }
    } else {
      int64_t j = s;
#pragma unroll 1
      for (;;) {
        const int64_t group_end = (j / kGroup + 1) * kGroup;
        const int64_t stop = group_end < e ? group_end : e;
        // A run that starts inside a group folds onto the TPU kernel's
        // zero (delta + 0), which only differs from delta for -0.
        if (j % kGroup != 0) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q) a[q] = O::add(a[q], O::zero());
        }
#pragma unroll 1
        for (int64_t k = j + 1; k < stop; ++k) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q)
            a[q] = O::add(O::stream(del + k * dv + c[q]), a[q]);
        }
        // The TPU kernel's zero-delta pad lanes continue the last run.
        if (stop == n && n % kGroup != 0) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q) a[q] = O::add(O::zero(), a[q]);
        }
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
          v[q] = O::add(v[q], negate ? O::neg(a[q]) : a[q]);
        j = stop;
        if (j >= e) break;
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
          a[q] = O::stream(del + j * dv + c[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q)
      if (base + gl + G * q < dv) row[c[q]] = v[q];
  }
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Ring stage `slot` <- the delta rows [base, min(base + rows, e)), by the
// whole block; one commit group (empty past e).
template <int VEC>
__device__ void load_stage(float* ring, const float* __restrict__ deltas,
                           int64_t base, int64_t e, int rows, int d,
                           int slot) {
  const int dv = d / VEC;
  const int64_t left = e - base;
  const int live = left <= 0 ? 0 : (left < rows ? (int)left : rows);
  float* dst = ring + slot * rows * d;
  const float* src = deltas + base * d;
  for (int k = threadIdx.x; k < live * dv; k += kThreads) {
    const int i = k / dv, c = (k - i * dv) * VEC;
    cp_async<VEC * 4>(dst + i * d + c, src + (int64_t)i * d + c);
  }
  cp_async_commit();
}

// One long run [s, e) of row r by the whole block (B4's fold): thread t
// holds columns t, t + 256, ... of the row and adds each delta row of the
// ring to them in order.
template <int VEC>
__device__ void add_long_run(float* __restrict__ table,
                             const float* __restrict__ deltas, int64_t r,
                             int64_t s, int64_t e, int d, bool negate,
                             float* ring, int rows) {
  float* row = table + r * d;
  float acc[kMaxCols];
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) {
    const int c = threadIdx.x + q * kThreads;
    acc[q] = c < d ? row[c] : 0.f;
  }
  const int64_t stages = (e - s + rows - 1) / rows;
  for (int k = 0; k < kStages - 1; ++k)
    load_stage<VEC>(ring, deltas, s + (int64_t)k * rows, e, rows, d, k);
  for (int64_t k = 0; k < stages; ++k) {
    load_stage<VEC>(ring, deltas, s + (k + kStages - 1) * rows, e, rows, d,
                    (int)((k + kStages - 1) % kStages));
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* stage = ring + (int)(k % kStages) * rows * d;
    const int64_t left = e - (s + k * rows);
    const int live = left < rows ? (int)left : rows;
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) {
      const int c = threadIdx.x + q * kThreads;
      if (c < d) {
#pragma unroll 4
        for (int i = 0; i < live; ++i) {
          const float x = stage[i * d + c];
          acc[q] = acc[q] + (negate ? -x : x);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) {
    const int c = threadIdx.x + q * kThreads;
    if (c < d) row[c] = acc[q];
  }
}

// B2 (FOLD = kGroupFold) and B4 (kEachDelta). Global warp w works on tile
// w / wpt and takes the rounds sub, sub + wpt, ... of its runs (sub = w %
// wpt); a round is 32 / G runs, one per lane group. The block's warps
// step through the tiles together, so that B4's long runs (ring_rows > 0:
// at most one a tile, its last) can be taken by the whole block after
// each step.
template <int FOLD, int VEC, int G, typename IdT>
__global__ void __launch_bounds__(kThreads)
scatter_runs_kernel(float* __restrict__ table, const IdT* __restrict__ ids,
                    const float* __restrict__ deltas, int64_t n,
                    int64_t num_rows, int d, int wpt, bool negate,
                    int ring_rows) {
  constexpr int kPerRound = 32 / G;
  __shared__ Runs<IdT> runs[kWarps];
  __shared__ int64_t long_id[kWarps], long_s[kWarps], long_e[kWarps];
  __shared__ int n_long;
  extern __shared__ __align__(16) float ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / G, gl = lane % G;
  const int64_t total = (n + kTile - 1) / kTile * wpt;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  const bool defer = FOLD == kEachDelta && ring_rows > 0;
  Runs<IdT>& mine = runs[warp];
  for (int64_t w0 = (int64_t)blockIdx.x * kWarps; w0 < total; w0 += stride) {
    if (defer) {
      if (threadIdx.x == 0) n_long = 0;
      __syncthreads();
    }
    const int64_t w = w0 + warp;
    if (w < total) {
      const int64_t t0 = w / wpt * kTile;
      const int sub = (int)(w % wpt);
      const int count = find_runs(ids, n, t0, lane, mine);
      for (int k = sub * kPerRound + group; k < count;
           k += wpt * kPerRound) {
        const int64_t r = mine.id[k];
        if (r < 0 || r >= num_rows) continue;
        const int64_t s = t0 + mine.start[k], e = mine.end[k];
        if (defer && e - s > kLong) {
          if (gl == 0) {
            const int slot = atomicAdd(&n_long, 1);
            long_id[slot] = r;
            long_s[slot] = s;
            long_e[slot] = e;
          }
          continue;
        }
        add_run<FOLD, VEC, G>(table, deltas, r, s, e, n, d, negate, gl);
      }
      __syncwarp();
    }
    if (defer) {
      __syncthreads();
      for (int k = 0; k < n_long; ++k)
        add_long_run<VEC>(table, deltas, long_id[k], long_s[k], long_e[k],
                          d, negate, ring, ring_rows);
      __syncthreads();
    }
  }
}

int grid_for(int64_t warps_needed) {
  const int64_t per_block = kThreads / 32;
  int64_t blocks = (warps_needed + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

int vec_width(const void* a, const void* b, int d) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b;
  if (d % 4 == 0 && bits % 16 == 0) return 4;
  if (d % 2 == 0 && bits % 8 == 0) return 2;
  return 1;
}

// Lanes per row: enough that kChunks vector chunks a lane cover the row,
// up to the whole warp (which then takes the row in passes).
int lanes_per_row(int dv) {
  return dv <= 4 ? 1 : dv <= 16 ? 4 : dv <= 32 ? 8 : 32;
}

template <int FOLD, int VEC, typename IdT>
void launch_width(int g, int grid, cudaStream_t st, float* table,
                  const IdT* ids, const float* deltas, int64_t n,
                  int64_t num_rows, int d, int wpt, bool negate,
                  int ring_rows) {
  const size_t smem = (size_t)ring_rows * kStages * d * sizeof(float);
  switch (g) {
    case 1:
      scatter_runs_kernel<FOLD, VEC, 1, IdT><<<grid, kThreads, smem, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate, ring_rows);
      break;
    case 4:
      scatter_runs_kernel<FOLD, VEC, 4, IdT><<<grid, kThreads, smem, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate, ring_rows);
      break;
    case 8:
      scatter_runs_kernel<FOLD, VEC, 8, IdT><<<grid, kThreads, smem, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate, ring_rows);
      break;
    default:
      scatter_runs_kernel<FOLD, VEC, 32, IdT><<<grid, kThreads, smem, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate, ring_rows);
  }
}

template <int FOLD, typename IdT>
int scatter_sorted(float* table, const IdT* ids, const float* deltas,
                   int64_t n, int64_t num_rows, int d, float sign,
                   void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(table, deltas, d);
  const int g = lanes_per_row(d / vec);
  // Warps per tile: while the tiles do not give each SM 32 warps, split
  // each tile's rounds of runs over up to g warps.
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t fill = (int64_t)sm_count() * 32;
  int wpt = 1;
  while (wpt < g && tiles * wpt < fill) wpt *= 2;
  const int grid = grid_for(tiles * wpt);
  const bool negate = sign < 0.f;
  // B4's long runs go through the block's ring where a row fits it.
  int ring_rows = 0;
  if (FOLD == kEachDelta && d <= kThreads * kMaxCols) {
    ring_rows = kRingBytes / (kStages * d * (int)sizeof(float));
    if (ring_rows > kRingRows) ring_rows = kRingRows;
  }
  switch (vec) {
    case 4:
      launch_width<FOLD, 4>(g, grid, st, table, ids, deltas, n, num_rows, d,
                            wpt, negate, ring_rows);
      break;
    case 2:
      launch_width<FOLD, 2>(g, grid, st, table, ids, deltas, n, num_rows, d,
                            wpt, negate, ring_rows);
      break;
    default:
      launch_width<FOLD, 1>(g, grid, st, table, ids, deltas, n, num_rows, d,
                            wpt, negate, ring_rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
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
  return scatter_sorted<kGroupFold>(table, ids, deltas, n, num_rows, d, sign,
                                    stream);
}

int mv_scatter_add_sorted_rows_i64(float* table, const int64_t* ids,
                                   const float* deltas, int64_t n,
                                   int64_t num_rows, int d, float sign,
                                   void* stream) {
  return scatter_sorted<kGroupFold>(table, ids, deltas, n, num_rows, d, sign,
                                    stream);
}

int mv_tiled_scatter_add_sorted_rows(float* table, const int32_t* ids,
                                     const float* deltas, int64_t n,
                                     int64_t num_rows, int d, float sign,
                                     void* stream) {
  return scatter_sorted<kEachDelta>(table, ids, deltas, n, num_rows, d, sign,
                                    stream);
}

int mv_tiled_scatter_add_sorted_rows_i64(float* table, const int64_t* ids,
                                         const float* deltas, int64_t n,
                                         int64_t num_rows, int d, float sign,
                                         void* stream) {
  return scatter_sorted<kEachDelta>(table, ids, deltas, n, num_rows, d, sign,
                                    stream);
}

}  // extern "C"
