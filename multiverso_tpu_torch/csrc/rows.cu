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
// - Finding runs: lane l loads ids t0 + l and t0 + 32 + l, coalesced,
//   with the id before the tile, all at once; __shfl_up_sync and
//   __ballot_sync mark where ids change, and the warp owns the runs of
//   equal ids that START in its tile (a run has exactly one owner, so no
//   float atomics). A run that reaches past the 64 slots read is followed
//   32 ids at a time with one load and one ballot each. The runs go to a
//   small per-warp list in shared memory.
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
constexpr int kTile = 32;   // sorted id slots a warp owns: one per lane
constexpr int kChunks = 4;  // vector chunks of a row per lane and pass
constexpr unsigned kFull = 0xffffffffu;

enum Fold { kGroupFold = 0, kEachDelta = 1 };  // B2, B4

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

// The runs that start in one tile, in order (per warp, in shared memory).
template <typename IdT> struct Runs {
  IdT id[kTile];
  int64_t end[kTile];  // one past the run's last slot
  int start[kTile];    // the run's first slot, from the tile's start
};

// Finds the runs of equal ids that start in the tile [t0, t0 + 32),
// writes them to `runs` and returns how many. Warp-uniform: every lane
// calls it.
template <typename IdT>
__device__ int find_runs(const IdT* __restrict__ ids, int64_t n, int64_t t0,
                         int lane, Runs<IdT>& runs) {
  const int64_t s0 = t0 + lane, s1 = s0 + kTile;
  const IdT a = s0 < n ? ids[s0] : IdT(0);
  const IdT b = s1 < n ? ids[s1] : IdT(0);
  const IdT before = t0 > 0 ? ids[t0 - 1] : IdT(0);
  IdT pa = __shfl_up_sync(kFull, a, 1);
  IdT pb = __shfl_up_sync(kFull, b, 1);
  const IdT last_a = __shfl_sync(kFull, a, kTile - 1);
  if (lane == 0) {
    pa = before;
    pb = last_a;
  }
  // An edge is a slot that starts a run or lies past the ids' end.
  const bool edge_a = s0 >= n || s0 == 0 || a != pa;
  const bool edge_b = s1 >= n || b != pb;
  const bool starts_here = edge_a && s0 < n;
  const unsigned starts = __ballot_sync(kFull, starts_here);
  if (starts == 0) return 0;
  const uint64_t edges = (uint64_t)__ballot_sync(kFull, edge_a) |
                         ((uint64_t)__ballot_sync(kFull, edge_b) << kTile);
  // A run starting at this lane ends at the next edge after it.
  const uint64_t after = edges >> (lane + 1);
  int64_t end = s0 + __ffsll((long long)after);
  // Only the tile's last run can reach past the 64 slots read.
  const int last = 31 - __clz(starts);
  if ((edges >> (last + 1)) == 0) {
    const IdT r = __shfl_sync(kFull, a, last);
    int64_t e = t0 + 2 * kTile;
    for (;; e += kTile) {
      const int64_t s = e + lane;
      const unsigned hit = __ballot_sync(kFull, s >= n || ids[s] != r);
      if (hit) {
        e += __ffs(hit) - 1;
        break;
      }
    }
    if (lane == last) end = e;
  }
  if (starts_here) {
    const int k = __popc(starts & ((1u << lane) - 1));
    runs.id[k] = a;
    runs.end[k] = end;
    runs.start[k] = lane;
  }
  __syncwarp();
  return __popc(starts);
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

// B2 (FOLD = kGroupFold) and B4 (kEachDelta). Global warp w works on tile
// w / wpt and takes the rounds sub, sub + wpt, ... of its runs (sub = w %
// wpt); a round is 32 / G runs, one per lane group.
template <int FOLD, int VEC, int G, typename IdT>
__global__ void __launch_bounds__(kThreads)
scatter_runs_kernel(float* __restrict__ table, const IdT* __restrict__ ids,
                    const float* __restrict__ deltas, int64_t n,
                    int64_t num_rows, int d, int wpt, bool negate) {
  constexpr int kPerRound = 32 / G;
  __shared__ Runs<IdT> runs[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / G, gl = lane % G;
  const int64_t total = (n + kTile - 1) / kTile * wpt;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  Runs<IdT>& mine = runs[warp];
  for (int64_t w = (int64_t)blockIdx.x * kWarps + warp; w < total;
       w += stride) {
    const int64_t t0 = w / wpt * kTile;
    const int sub = (int)(w % wpt);
    const int count = find_runs(ids, n, t0, lane, mine);
    for (int k = sub * kPerRound + group; k < count; k += wpt * kPerRound) {
      const int64_t r = mine.id[k];
      if (r >= 0 && r < num_rows)
        add_run<FOLD, VEC, G>(table, deltas, r, t0 + mine.start[k],
                              mine.end[k], n, d, negate, gl);
    }
    __syncwarp();
  }
}

// Each device's SM count, read once.
int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 132;
  if (dev >= 0 && dev < 64) cached[dev] = sms;
  return sms;
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
                  int64_t num_rows, int d, int wpt, bool negate) {
  switch (g) {
    case 1:
      scatter_runs_kernel<FOLD, VEC, 1, IdT><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate);
      break;
    case 4:
      scatter_runs_kernel<FOLD, VEC, 4, IdT><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate);
      break;
    case 8:
      scatter_runs_kernel<FOLD, VEC, 8, IdT><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate);
      break;
    default:
      scatter_runs_kernel<FOLD, VEC, 32, IdT><<<grid, kThreads, 0, st>>>(
          table, ids, deltas, n, num_rows, d, wpt, negate);
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
  switch (vec) {
    case 4:
      launch_width<FOLD, 4>(g, grid, st, table, ids, deltas, n, num_rows, d,
                            wpt, negate);
      break;
    case 2:
      launch_width<FOLD, 2>(g, grid, st, table, ids, deltas, n, num_rows, d,
                            wpt, negate);
      break;
    default:
      launch_width<FOLD, 1>(g, grid, st, table, ids, deltas, n, num_rows, d,
                            wpt, negate);
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
