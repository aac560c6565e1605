// Stateful row updates of the parameter-server table plane, for Hopper
// (sm_90a).
//
// mv_fused_stateful_sorted_rows{,_i64} replaces
// multiverso_tpu/ops/pallas_rows.py::fused_stateful_rows (B3) together
// with the duplicate combine before it: one pass over the runs of equal
// ids of a stable sort, each run's deltas folded in lane order straight
// from the UNSORTED deltas through the sort's permutation (0 + d0 + d1 +
// ..., the combine's bits: multiverso_tpu_torch/core/updater.py::
// combine_duplicate_rows), then the updater's math on the table row and
// every state row of a momentum_sgd, adagrad or ftrl updater, each row
// read and written once. No sorted copy of the deltas, no folded copy,
// no id cast. mv_fused_stateful_rows launches the same kernel with the
// fold off, for B3's own signature: lanes already combined (unique ids,
// dropped lanes holding the sentinel num_rows), each lane its own run and
// its delta read as it is.
//
// mv_fold_sorted_runs_{f32,f64} is the fold of the combine alone (an XLA
// segment_sum in the JAX package, no Pallas kernel), for the paths that
// keep the combine: dcasgd, dcasgda, float64 tables and tables without
// the row kernels. Each run of equal sorted ids sums its deltas in lane
// order, 0 + d0 + d1 + ..., and every lane of the run gets the run's
// total. The CPU's index_add_ adds in that order; the card's adds with
// atomics in no fixed order, so this kernel takes its place there and
// gives the CPU's bits.
//
// What bounds them on this card: bytes. The fused kernel reads the ids,
// the permutation and every delta row once and reads and writes a row of
// the table and of each leaf per unique id, with a dozen float operations
// per element at most; the fold reads and writes each delta row once.
// Both are far below the ~20 flop/byte at which an H100's arithmetic
// would matter.
//
// Design. The TPU kernel moves 8 lanes per grid step by per-row DMA. Here
// a warp owns a tile of 32 sorted id slots and finds the runs that start
// in it by ballot (runs.cuh, as B2 does), so no thread spends time on a
// lane that does not start a run. Groups of G lanes (8 at D = 50 and
// D = 128) each take one run, so a warp has 32 / G runs in flight; a lane
// holds up to 4 vector chunks of a row (8 bytes at D = 50, 16 when D % 4
// == 0 and the rows are 16-byte aligned) and issues the loads of the
// table, every leaf and the run's first delta row before any math (the
// first delta's row comes from the permutation, read with the tile's ids).
// Further deltas of a run follow two at a time. Chunks past the row's end
// are clamped onto its last chunk (no bound test between the loads) and
// not stored. The grid gives each tile up to G warps, until it holds
// kFill warps per SM (32, 128 and 256 read no faster on an H100 at the
// table plane's shape), so the runs are not strided over a few resident
// warps. A run whose id lies outside [0, num_rows) is skipped:
// the TPU kernel loads it clamped and writes nothing. No float atomics,
// no host reads: the launch can be captured in a CUDA graph.
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

#include "runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFill = 64;   // warps per SM the grid aims at
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;  // vector chunks of a row per lane and pass

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

// VEC elements of a row moved by one vector load or store.
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void add_to(Pack<T, VEC>& acc,
                                       const Pack<T, VEC>& x) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.v[i] = acc.v[i] + x.v[i];
}

// The chunks a lane of a G-lane group takes in the pass at `base`,
// clamped onto the row's last chunk.
template <int G>
__device__ __forceinline__ void chunks(int base, int gl, int dv,
                                       int (&c)[kChunks]) {
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int want = base + gl + G * q;
    c[q] = want < dv ? want : dv - 1;
  }
}

// A warp's runs of one tile, with the delta row of each run's first lane.
template <typename IdT> struct Tile {
  Runs<IdT> runs;
  int64_t first[kTile];
};

// Fills `t` with the runs of the tile [t0, t0 + 32) and returns how many.
// fold: runs of equal sorted ids (find_runs), each first lane's delta row
// order[slot], read together with the ids; no fold: every lane its own
// run, its delta row its own. Warp-uniform.
template <typename IdT>
__device__ int tile_runs(const IdT* __restrict__ ids,
                         const int64_t* __restrict__ order, int64_t n,
                         int64_t t0, int lane, bool fold, Tile<IdT>& t) {
  const int64_t s = t0 + lane;
  if (!fold) {
    if (s < n) {
      t.runs.id[lane] = ids[s];
      t.runs.start[lane] = lane;
      t.runs.end[lane] = s + 1;
      t.first[lane] = s;
    }
    __syncwarp();
    return n - t0 < kTile ? (int)(n - t0) : kTile;
  }
  const int64_t o = s < n ? order[s] : 0;
  const int count = find_runs(ids, n, t0, lane, t.runs);
  const int from = lane < count ? t.runs.start[lane] : 0;
  const int64_t f = __shfl_sync(kFull, o, from);
  if (lane < count) t.first[lane] = f;
  __syncwarp();
  return count;
}

template <int KIND, int VEC>
__device__ __forceinline__ void apply(Pack<float, VEC>& w,
                                      Pack<float, VEC>& a,
                                      Pack<float, VEC>& b,
                                      const Pack<float, VEC>& g,
                                      const Opts& o) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (KIND == kMomentum) momentum(w.v[i], a.v[i], g.v[i], o);
    if (KIND == kAdaGrad) adagrad(w.v[i], a.v[i], g.v[i], o);
    if (KIND == kFtrl) ftrl(w.v[i], a.v[i], b.v[i], g.v[i], o);
  }
}

// One run [s, e) of row r by one group of G lanes (lane gl of it): fold
// its deltas (rows first, order[s + 1], ..., order[e - 1] of `deltas`)
// from 0 in lane order, or take the lane's delta as it is (no fold), then
// update the table row and its state rows in place. The loop over a run's
// further deltas stays rolled: unrolled it costs registers, and so
// resident warps, that runs of one or two ids never use.
template <int KIND, int VEC, int G>
__device__ void update_run(float* __restrict__ table,
                           float* __restrict__ leaf_a,
                           float* __restrict__ leaf_b,
                           const int64_t* __restrict__ order,
                           const float* __restrict__ deltas, int64_t r,
                           int64_t s, int64_t e, int64_t first,
                           int64_t num_rows, int d, int64_t wid, bool fold,
                           const Opts& o, int gl) {
  using P = Pack<float, VEC>;
  const int dv = d / VEC;
  // AdaGrad's accumulator is per worker: row r of plane wid, in 64-bit
  // arithmetic (W * R * D passes 2^31 elements at W >= 43 for 1M x 50).
  const int64_t leaf_row = KIND == kAdaGrad ? wid * num_rows + r : r;
  P* wp = reinterpret_cast<P*>(table + r * d);
  P* ap = reinterpret_cast<P*>(leaf_a + leaf_row * d);
  P* bp = reinterpret_cast<P*>((KIND == kFtrl ? leaf_b : leaf_a) +
                               leaf_row * d);
  const P* dp = reinterpret_cast<const P*>(deltas);
  for (int base = 0; base < dv; base += G * kChunks) {
    int c[kChunks];
    chunks<G>(base, gl, dv, c);
    P w[kChunks], a[kChunks], b[kChunks], g[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) w[q] = wp[c[q]];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) a[q] = ap[c[q]];
    if (KIND == kFtrl) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) b[q] = bp[c[q]];
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) g[q] = dp[first * dv + c[q]];
    if (fold) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) g[q].v[i] = __fadd_rn(0.f, g[q].v[i]);
      }
#pragma unroll 1
      for (int64_t j = s + 1; j < e; j += 2) {
        const bool two = j + 1 < e;
        const int64_t r0 = order[j], r1 = order[two ? j + 1 : j];
        P x0[kChunks], x1[kChunks];
#pragma unroll
        for (int q = 0; q < kChunks; ++q) x0[q] = dp[r0 * dv + c[q]];
#pragma unroll
        for (int q = 0; q < kChunks; ++q) x1[q] = dp[r1 * dv + c[q]];
#pragma unroll
        for (int q = 0; q < kChunks; ++q) add_to(g[q], x0[q]);
        if (two) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q) add_to(g[q], x1[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q)
      apply<KIND, VEC>(w[q], a[q], b[q], g[q], o);
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      if (base + gl + G * q < dv) {
        wp[c[q]] = w[q];
        ap[c[q]] = a[q];
        if (KIND == kFtrl) bp[c[q]] = b[q];
      }
    }
  }
}

// The fused kernel (fold on: sorted ids and their permutation; fold off:
// combined lanes). Global warp w works on tile w / wpt and takes the
// rounds sub, sub + wpt, ... of its runs (sub = w % wpt); a round is
// 32 / G runs, one per lane group. leaf_a: smooth (momentum), g2
// (adagrad, [W, R, D], plane wid) or z (ftrl); leaf_b: n (ftrl).
template <int KIND, int VEC, int G, typename IdT>
__global__ void __launch_bounds__(kThreads)
stateful_runs_kernel(float* __restrict__ table, float* __restrict__ leaf_a,
                     float* __restrict__ leaf_b, const IdT* __restrict__ ids,
                     const int64_t* __restrict__ order,
                     const float* __restrict__ deltas, int64_t n,
                     int64_t num_rows, int d, int64_t wid, int wpt,
                     bool fold, Opts o) {
  constexpr int kPerRound = 32 / G;
  __shared__ Tile<IdT> tiles[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / G, gl = lane % G;
  const int64_t total = (n + kTile - 1) / kTile * wpt;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  Tile<IdT>& mine = tiles[warp];
  for (int64_t w = (int64_t)blockIdx.x * kWarps + warp; w < total;
       w += stride) {
    const int64_t t0 = w / wpt * kTile;
    const int sub = (int)(w % wpt);
    const int count = tile_runs(ids, order, n, t0, lane, fold, mine);
    for (int k = sub * kPerRound + group; k < count; k += wpt * kPerRound) {
      const int64_t r = mine.runs.id[k];
      if (r >= 0 && r < num_rows)
        update_run<KIND, VEC, G>(table, leaf_a, leaf_b, order, deltas, r,
                                 t0 + mine.runs.start[k], mine.runs.end[k],
                                 mine.first[k], num_rows, d, wid, fold, o,
                                 gl);
    }
    __syncwarp();
  }
}

// The combine's fold alone: every lane of a run [s, e) of sorted ids gets
// the run's total, 0 + deltas[s] + ... + deltas[e - 1], in T.
template <typename T, int VEC, int G>
__device__ void fold_run(const T* __restrict__ deltas, T* __restrict__ out,
                         int64_t s, int64_t e, int d, int gl) {
  using P = Pack<T, VEC>;
  const int dv = d / VEC;
  const P* dp = reinterpret_cast<const P*>(deltas);
  P* op = reinterpret_cast<P*>(out);
  for (int base = 0; base < dv; base += G * kChunks) {
    int c[kChunks];
    chunks<G>(base, gl, dv, c);
    P acc[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q].v[i] = T(0);
    }
#pragma unroll 1
    for (int64_t j = s; j < e; j += 2) {
      const bool two = j + 1 < e;
      const int64_t j1 = two ? j + 1 : j;
      P x0[kChunks], x1[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) x0[q] = dp[j * dv + c[q]];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) x1[q] = dp[j1 * dv + c[q]];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) add_to(acc[q], x0[q]);
      if (two) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) add_to(acc[q], x1[q]);
      }
    }
#pragma unroll 1
    for (int64_t j = s; j < e; ++j) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        if (base + gl + G * q < dv) op[j * dv + c[q]] = acc[q];
    }
  }
}

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
fold_runs_kernel(const int64_t* __restrict__ ids, const T* __restrict__ deltas,
                 T* __restrict__ out, int64_t n, int d, int wpt) {
  constexpr int kPerRound = 32 / G;
  __shared__ Runs<int64_t> runs[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / G, gl = lane % G;
  const int64_t total = (n + kTile - 1) / kTile * wpt;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  Runs<int64_t>& mine = runs[warp];
  for (int64_t w = (int64_t)blockIdx.x * kWarps + warp; w < total;
       w += stride) {
    const int64_t t0 = w / wpt * kTile;
    const int sub = (int)(w % wpt);
    const int count = find_runs(ids, n, t0, lane, mine);
    for (int k = sub * kPerRound + group; k < count; k += wpt * kPerRound)
      fold_run<T, VEC, G>(deltas, out, t0 + mine.start[k], mine.end[k], d,
                          gl);
    __syncwarp();
  }
}

// The widest vector (1, 2 or 4 elements of `size` bytes) that the width d
// and every pointer's alignment allow.
int vec_width(const void* const (&ptrs)[4], int d, int size) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  if (size == 4 && d % 4 == 0 && bits % 16 == 0) return 4;
  if (d % 2 == 0 && bits % (2 * size) == 0 && 2 * size <= 16) return 2;
  return 1;
}

// Lanes per row: enough that kChunks vector chunks a lane cover the row,
// up to the whole warp (which then takes the row in passes).
int lanes_per_row(int dv) { return dv <= 16 ? 4 : dv <= 32 ? 8 : 32; }

// (grid, warps per tile): while the tiles do not give each SM kFill
// warps, split each tile's rounds of runs over up to g warps; the grid
// covers every warp (strided only past 512 blocks an SM).
void grid_for(int64_t n, int g, int& grid, int& wpt) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t fill = (int64_t)sm_count() * kFill;
  wpt = 1;
  while (wpt < g && tiles * wpt < fill) wpt *= 2;
  int64_t blocks = (tiles * wpt + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sm_count() * 512;
  if (blocks > cap) blocks = cap;
  grid = blocks < 1 ? 1 : (int)blocks;
}

struct Args {
  float* table;
  float* leaf_a;
  float* leaf_b;
  const void* ids;
  const int64_t* order;
  const float* deltas;
  int64_t n, num_rows;
  int d;
  int64_t wid;
  bool fold;
  Opts o;
};

template <int KIND, int VEC, int G, typename IdT>
void launch_stateful(const Args& a, cudaStream_t st) {
  int grid, wpt;
  grid_for(a.n, G, grid, wpt);
  stateful_runs_kernel<KIND, VEC, G, IdT><<<grid, kThreads, 0, st>>>(
      a.table, a.leaf_a, a.leaf_b, static_cast<const IdT*>(a.ids), a.order,
      a.deltas, a.n, a.num_rows, a.d, a.wid, wpt, a.fold, a.o);
}

template <int KIND, int VEC, typename IdT>
void launch_width(const Args& a, cudaStream_t st) {
  switch (lanes_per_row(a.d / VEC)) {
    case 4:
      launch_stateful<KIND, VEC, 4, IdT>(a, st);
      break;
    case 8:
      launch_stateful<KIND, VEC, 8, IdT>(a, st);
      break;
    default:
      launch_stateful<KIND, VEC, 32, IdT>(a, st);
  }
}

template <int KIND, typename IdT>
void launch_vec(const Args& a, int vec, cudaStream_t st) {
  switch (vec) {
    case 4:
      launch_width<KIND, 4, IdT>(a, st);
      break;
    case 2:
      launch_width<KIND, 2, IdT>(a, st);
      break;
    default:
      launch_width<KIND, 1, IdT>(a, st);
  }
}

template <typename IdT>
int fused(int kind, const Args& a, void* stream) {
  if (kind < kMomentum || kind > kFtrl) return (int)cudaErrorInvalidValue;
  if (a.n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* ptrs[] = {a.table, a.leaf_a,
                        kind == kFtrl ? a.leaf_b : a.leaf_a, a.deltas};
  const int vec = vec_width(ptrs, a.d, 4);
  if (kind == kMomentum)
    launch_vec<kMomentum, IdT>(a, vec, st);
  else if (kind == kAdaGrad)
    launch_vec<kAdaGrad, IdT>(a, vec, st);
  else
    launch_vec<kFtrl, IdT>(a, vec, st);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
void launch_fold_width(const int64_t* ids, const T* deltas, T* out,
                       int64_t n, int d, cudaStream_t st) {
  int grid, wpt;
  switch (lanes_per_row(d / VEC)) {
    case 4:
      grid_for(n, 4, grid, wpt);
      fold_runs_kernel<T, VEC, 4><<<grid, kThreads, 0, st>>>(ids, deltas,
                                                             out, n, d, wpt);
      break;
    case 8:
      grid_for(n, 8, grid, wpt);
      fold_runs_kernel<T, VEC, 8><<<grid, kThreads, 0, st>>>(ids, deltas,
                                                             out, n, d, wpt);
      break;
    default:
      grid_for(n, 32, grid, wpt);
      fold_runs_kernel<T, VEC, 32><<<grid, kThreads, 0, st>>>(
          ids, deltas, out, n, d, wpt);
  }
}

template <typename T>
int fold(const int64_t* ids, const T* deltas, T* out, int64_t n, int d,
         void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* ptrs[] = {deltas, out, deltas, out};
  switch (vec_width(ptrs, d, sizeof(T))) {
    case 4:  // float only: 16 bytes
      if constexpr (sizeof(T) == 4)
        launch_fold_width<T, 4>(ids, deltas, out, n, d, st);
      break;
    case 2:
      launch_fold_width<T, 2>(ids, deltas, out, n, d, st);
      break;
    default:
      launch_fold_width<T, 1>(ids, deltas, out, n, d, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 momentum_sgd (leaf_a = smooth; p0 = momentum), 1 adagrad
// (leaf_a = g2 [W, R, D], plane wid; p0 = lr, p1 = rho, p2 = eps), 2 ftrl
// (leaf_a = z, leaf_b = n; p0 = l2, p1 = alpha, p2 = beta, p3 = l1).
// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue (1) for an unknown kind.

// B3's signature: n combined lanes (unique ids, the sentinel num_rows
// for dropped lanes), deltas[i] the lane's combined delta.
int mv_fused_stateful_rows(int kind, float* table, float* leaf_a,
                           float* leaf_b, const int64_t* ids,
                           const float* deltas, int64_t n, int64_t num_rows,
                           int d, int64_t wid, float p0, float p1, float p2,
                           float p3, void* stream) {
  const Args a{table, leaf_a, leaf_b,   ids, nullptr, deltas, n,
               num_rows, d,  wid,       false, {p0, p1, p2, p3}};
  return fused<int64_t>(kind, a, stream);
}

// The fused route: ids sorted (stable) and order the sort's permutation,
// so deltas[order[j]] is sorted lane j's delta (deltas unsorted).
int mv_fused_stateful_sorted_rows(int kind, float* table, float* leaf_a,
                                  float* leaf_b, const int32_t* ids,
                                  const int64_t* order, const float* deltas,
                                  int64_t n, int64_t num_rows, int d,
                                  int64_t wid, float p0, float p1, float p2,
                                  float p3, void* stream) {
  const Args a{table, leaf_a, leaf_b, ids,  order, deltas, n,
               num_rows, d,  wid,     true, {p0, p1, p2, p3}};
  return fused<int32_t>(kind, a, stream);
}

int mv_fused_stateful_sorted_rows_i64(int kind, float* table, float* leaf_a,
                                      float* leaf_b, const int64_t* ids,
                                      const int64_t* order,
                                      const float* deltas, int64_t n,
                                      int64_t num_rows, int d, int64_t wid,
                                      float p0, float p1, float p2, float p3,
                                      void* stream) {
  const Args a{table, leaf_a, leaf_b, ids,  order, deltas, n,
               num_rows, d,  wid,     true, {p0, p1, p2, p3}};
  return fused<int64_t>(kind, a, stream);
}

// out[j] = the sum, in lane order from 0, of deltas[s..e) for the run
// [s, e) of equal sorted ids that holds lane j.
int mv_fold_sorted_runs_f32(const int64_t* ids, const float* deltas,
                            float* out, int64_t n, int d, void* stream) {
  return fold<float>(ids, deltas, out, n, d, stream);
}

int mv_fold_sorted_runs_f64(const int64_t* ids, const double* deltas,
                            double* out, int64_t n, int d, void* stream) {
  return fold<double>(ids, deltas, out, n, d, stream);
}

}  // extern "C"
