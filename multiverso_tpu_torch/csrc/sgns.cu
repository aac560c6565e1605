// Whole-block skip-gram / negative-sampling trainer for Hopper (sm_90a).
//
// Built for two embedding element types, as the TPU kernel takes either:
// float tables (mv_sgns_block) and bfloat16 tables (mv_sgns_block_bf16);
// the AdaGrad sums g_in/g_out, the scratch and all the math are float in
// both. A bfloat16 instance widens every gathered row to float, rounds
// each lane's step to bfloat16 (__float2bfloat16_rn, as the JAX step's
// astype) and adds it to its row in lane order with a rounding to
// bfloat16 after every add, which is what XLA's scatter-add does on a
// bfloat16 table; in every run class the terms may be made ahead, but
// they are never summed in float and rounded once. A bfloat16 row of
// D % 4 == 0 is read 4 elements (8 bytes) a lane; other widths take the
// narrow instance, as float rows do. The float instance is the code below
// with the rounding hooks (Elt<float>) the identity.
//
// mv_sgns_block replaces multiverso_tpu/ops/pallas_sgns.py::
// build_sgns_grid_step (B5, its pl.pallas_call at :170): one launch trains
// every live chunk of a block, in order, each chunk being raw_sg_ns_step
// (multiverso_tpu/models/word2vec/model.py:288-305): gather u, v_pos and
// v_neg (ids clipped), the sigmoid negative-sampling loss and gradients
// (_ns_grads), then the AdaGrad (or SGD) update of w_in by centers and of
// w_out by contexts followed by negatives (_apply_update), with the lanes
// past n_pairs masked and the loss summed over the chunks.
//
// Why the chunks cannot overlap. Chunk i+1 gathers the rows that chunk i
// updates, and a row's AdaGrad step reads the sum of squares of every one
// of its lanes in the chunk. So ONE persistent cooperative launch walks the
// chunks, with grid.sync() in place of the TPU's sequential grid step: the
// grid is sized by occupancy so that every CTA is resident, and each live
// chunk i < ceil(n_pairs/C) (n_pairs is read on the device) takes two
// barriers. Dead chunks (all lanes masked) are skipped: in JAX they are
// bitwise no-ops.
//
// What bounds it per chunk, at the flagship's V=50,000, D=128, C=8192,
// K=5: the rows it touches in the four tables (~26 MB read and ~26 MB
// written; the tables are 102 MB, twice the 50 MB L2), ~29 MB of gathered
// rows (mostly L2 hits), the chain of dependent loads of the longest run
// of one row (Zipf negatives: up to ~900 lanes of one id), and the two grid
// barriers. At ~10 flops per byte moved, arithmetic never bounds it. On an
// H100 a chunk with uniform ids takes ~57 us (phase 1 ~15, the tiles of
// phase 2 ~25-40, barriers); with the flagship's Zipf ids the CTA that
// applies the longest run (~820 lanes) holds the second barrier longer
// (scripts/torch_sgns_steps.py --phases reads each phase).
//
// Phase 1 (one warp per pair, 16-byte loads): the pair's ids come in one
// load spread over the warp's lanes, fetched one pair ahead; the warp
// gathers its rows, reduces the 1+K dot products with shuffles and writes
// the chunk's scratch: grad_u [C, D], a snapshot of u [C, D] and the
// C*(1+K) coefficients (g_pos, then g_neg in the order of
// concat(contexts, negatives.flatten())). An out-lane's gradient row
// g*u is one rounded product of that coefficient and the center's row, so
// phase 2 rebuilds it bitwise from the snapshot instead of reading a
// [C*(1+K), D] gradient array (8.6 MB of scratch a chunk instead of
// 29.4). The snapshot is needed because phase 2 updates w_in while the
// out-runs still read the old u. The warps also list the chunk's long
// runs (below), one ballot and at most one atomic per 32 sorted slots.
//
// Phase 2 (after grid.sync()): the updates, run by run over each chunk's
// ids stable-sorted by the glue (in slots: the C centers; out slots: the
// C*(1+K) contexts then negatives). Each run of equal ids has exactly one
// owner, so there are no float atomics and two launches give bitwise-equal
// results. g2[r] takes the squares of all of the run's lanes before any
// step of the run reads it; the denominator sqrt(g2 + 1e-6) is computed
// once per column after that, which is bitwise what the per-lane form
// gives since g2 no longer changes.
//   - Short and medium runs (< kLongRun lanes): a warp owns a tile of 32
//     sorted slots (split over 2 warps when the grid has warps to spare),
//     reads 64 ids and permutation entries in two coalesced loads and
//     finds its runs by ballot. Runs of at most kHeld lanes go to lane
//     groups of kRunLanes, 2 runs a warp at once, each lane holding 8
//     floats of the row: the row's w and g2 and the lanes' gradient rows
//     all load in one round trip and stay in registers for both passes.
//     Longer runs take the whole warp: their gradient rows go out kStaged
//     a round trip (cp.async) into the warp's rows of shared memory,
//     beside the row's w and g2; a run of at most kStaged lanes keeps them
//     for both passes.
//   - Long runs (>= kLongRun lanes, listed in phase 1): one CTA each. A
//     k-ary search with one probe a thread finds the run's end in one or
//     two round trips. The run's gradient rows then stream through a ring
//     of kRing tiles of kRingLanes rows in shared memory (cp.async, so
//     kRing - 1 tiles are in flight without holding registers). One
//     thread per column reads its column of a landed tile into registers
//     and turns all 32 values into terms (squares, or steps against the
//     column's denominator) before it adds them in lane order, so only
//     the adds form a chain: the 4 warps that fold hide no latency behind
//     other warps, and a fold that read, scaled and added lane by lane
//     held a chunk's longest run to ~135-140 ns a lane. A run that fits
//     the ring keeps its tiles for the second pass. The CTAs that hold a
//     long run take no tiles while the other warps suffice; tiles beyond
//     those go to any warp that asks the chunk's counter.
//   Every run, long runs included, folds in lane order onto the row's own
//   g2 and w, as the earlier one-warp-per-run design of this kernel did,
//   so the tables come out bitwise as from it (scripts/torch_sgns_steps.py
//   compares two trees' tables on the card). The order
//   is held because the tolerance needs it, not only for determinism: the
//   plain version adds a run's lanes one by one onto g2 (in no fixed
//   order, with atomics), and adding small squares one by one onto a large
//   sum rounds with a bias that other orders do not share. A version that
//   summed each long run in 8 segments from zero drifted 1.9e-5 of g_out's
//   largest value from the plain version over the flagship block, twice
//   the tolerance chip_smoke.py holds the kernel to; one that folded 32-
//   or 128-lane segments onto the row's g2 and w across the whole grid and
//   added the increments in segment order moved g_in by 1.2x and 1.4x the
//   tolerance where one id fills every out-lane.
// The glue sorts the masked lanes (exact zero gradients) to the end as an
// out-of-range id, which is dropped like any other (mode="drop"). The
// w_in runs and the w_out runs touch different tables, so they share one
// phase. Registers bound the occupancy (every CTA must be resident for the
// grid barrier), so phase 1 is built for at most 8 negatives and for at
// most 16, and launched with the smaller variant that fits. The update
// arithmetic uses explicitly rounded operations (__fmul_rn, __fadd_rn,
// ...) so no multiply-add is contracted and each element rounds as the
// plain torch chain does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Phase marks, for scripts/torch_sgns_steps.py --phases, which builds this
// file with -DMV_SGNS_PROFILE: at each mark thread 0 of every CTA adds the
// clock64() cycles since its last mark to g_prof[k] and keeps the largest
// in g_prof[8 + k] (mv_sgns_profile reads and clears them). Without the
// define the marks are empty.
#ifdef MV_SGNS_PROFILE
__device__ unsigned long long g_prof[16];
#define PROF_START long long prof_t = clock64()
#define PROF_MARK(k)                                               \
  do {                                                             \
    if (threadIdx.x == 0) {                                        \
      const long long now_ = clock64();                            \
      const auto dt_ = (unsigned long long)(now_ - prof_t);        \
      atomicAdd(&g_prof[k], dt_);                                  \
      atomicMax(&g_prof[8 + (k)], dt_);                            \
      prof_t = now_;                                               \
    }                                                              \
  } while (0)
#else
#define PROF_START
#define PROF_MARK(k)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;     // CTAs an SM the registers are sized for
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNeg = 16;
constexpr int kSmallNeg = 8;      // the variant for negative <= 8
constexpr float kEps = 1e-7f;     // model.py _EPS
constexpr float kAdaEps = 1e-6f;  // _apply_update's sqrt(g2 + 1e-6)
constexpr int kLongRun = 32;      // runs this long or longer: a whole CTA
constexpr int kRunLanes = 16;     // lanes of a group that applies a short run
constexpr int kGroups = 32 / kRunLanes;
constexpr int kHeld = 2;          // a short run's lanes held in registers
constexpr int kBlock = 128;       // floats of a row per pass over a run
constexpr int kQuads = kBlock / (4 * kRunLanes);  // a group lane's float4s
constexpr int kStaged = 16;       // rows a warp stages at once
constexpr int kRingLanes = 32;    // lanes of a long run per ring tile
constexpr int kRing = 4;          // ring tiles (kRing - 1 in flight)
constexpr int kPermBlock = 1024;  // lanes whose rows and coefficients a
                                  // long run holds in shared memory at once
constexpr unsigned kFull = 0xffffffffu;

struct SgnsArgs {
  void* w_in;                // [v_in, D] float or __nv_bfloat16
  void* w_out;               // [v_out, D] of the same type
  float* g_in;
  float* g_out;
  int64_t v_in;
  int64_t v_out;
  const int32_t* centers;    // [n_chunks, C]
  const int32_t* contexts;   // [n_chunks, C]
  const int32_t* negatives;  // [n_chunks, C, K]
  const int32_t* in_ids;     // [n_chunks, C] centers sorted (stable)
  const int32_t* in_perm;    // [n_chunks, C] lane of each sorted center
  const int32_t* out_ids;    // [n_chunks, C*(1+K)] out rows sorted
  const int32_t* out_perm;   // [n_chunks, C*(1+K)]
  const int32_t* n_pairs;    // device scalar
  float* grad_u;             // scratch [C, D]
  float* u_snap;             // scratch [C, D]: the chunk's gathered u
  float* coef;               // scratch [C*(1+K)]: g_pos, then g_neg
  float* loss_partials;      // scratch [2 * gridDim.x]
  float* loss_out;           // [1]
  int64_t n_chunks;
  int chunk;
  int k;
  int d;
  float lr;
  int adagrad;
  int32_t* long_runs;        // [cap]: the chunk's long runs' first slots
  int32_t* counts;           // [2, n_chunks], zero at launch: long runs
                             // listed, tiles taken from the counter
};

__device__ __forceinline__ int64_t clip(int64_t r, int64_t n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// An embedding row's elements, read as float (a bfloat16 widens exactly)
// and written from float values the update has already rounded to the
// element type; rnd() rounds a float to it, add() is what the table holds
// after a step is added to a value it held.
template <typename E> struct Elt;
template <> struct Elt<float> {
  // Vector c (4 elements) of a row.
  __device__ static float4 vec4(const float* row, int c) {
    return reinterpret_cast<const float4*>(row)[c];
  }
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store1(float* p, float v) { *p = v; }
  __device__ static float rnd(float x) { return x; }
  __device__ static float add(float w, float s) { return __fadd_rn(w, s); }
};
template <> struct Elt<__nv_bfloat16> {
  __device__ static float4 widen(uint2 r) {
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ static float4 vec4(const __nv_bfloat16* row, int c) {
    return widen(reinterpret_cast<const uint2*>(row)[c]);
  }
  __device__ static float4 load4(const __nv_bfloat16* p) {
    return widen(*reinterpret_cast<const uint2*>(p));
  }
  __device__ static void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 r;
    r.x = *reinterpret_cast<const unsigned*>(&lo);
    r.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
  __device__ static float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static float add(float w, float s) {
    return rnd(__fadd_rn(w, rnd(s)));
  }
};

// Phase 1's row access: 4 elements a load where D % 4 == 0, else 1.
template <int VEC> struct Ld;
template <> struct Ld<4> {
  using T = float4;
  template <typename E>
  __device__ static T at(const E* row, int c) {
    return Elt<E>::vec4(row, c);
  }
  __device__ static float dot(T a, T b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ static T scale(float s, T a) {
    return make_float4(__fmul_rn(s, a.x), __fmul_rn(s, a.y),
                       __fmul_rn(s, a.z), __fmul_rn(s, a.w));
  }
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Ld<1> {
  using T = float;
  template <typename E>
  __device__ static T at(const E* row, int c) {
    return Elt<E>::load1(row + c);
  }
  __device__ static float dot(T a, T b) { return a * b; }
  __device__ static T scale(float s, T a) { return __fmul_rn(s, a); }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ static T zero() { return 0.f; }
};

// Phase 2 works on 4 floats at a time, each operation rounded once.
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
// A row's 4 values after 4 steps are added (add4 for float rows).
template <typename E>
__device__ __forceinline__ float4 addw4(float4 w, float4 s) {
  return make_float4(Elt<E>::add(w.x, s.x), Elt<E>::add(w.y, s.y),
                     Elt<E>::add(w.z, s.z), Elt<E>::add(w.w, s.w));
}
__device__ __forceinline__ float4 mul4(float s, float4 a) {
  return make_float4(__fmul_rn(s, a.x), __fmul_rn(s, a.y),
                     __fmul_rn(s, a.z), __fmul_rn(s, a.w));
}
__device__ __forceinline__ float4 sq_acc4(float4 acc, float4 g) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(g.x, g.x)),
                     __fadd_rn(acc.y, __fmul_rn(g.y, g.y)),
                     __fadd_rn(acc.z, __fmul_rn(g.z, g.z)),
                     __fadd_rn(acc.w, __fmul_rn(g.w, g.w)));
}
// sqrt(g2 + 1e-6), once per column of a run.
__device__ __forceinline__ float4 den4(float4 g2) {
  return make_float4(__fsqrt_rn(__fadd_rn(g2.x, kAdaEps)),
                     __fsqrt_rn(__fadd_rn(g2.y, kAdaEps)),
                     __fsqrt_rn(__fadd_rn(g2.z, kAdaEps)),
                     __fsqrt_rn(__fadd_rn(g2.w, kAdaEps)));
}
// -lr*grad/den (AdaGrad) or -lr*grad (SGD), one element.
__device__ __forceinline__ float step1(float neg_lr, float g, float den,
                                       bool adagrad) {
  const float s = __fmul_rn(neg_lr, g);
  return adagrad ? __fdiv_rn(s, den) : s;
}
__device__ __forceinline__ float4 step4(float neg_lr, float4 g, float4 den,
                                        bool adagrad) {
  return make_float4(step1(neg_lr, g.x, den.x, adagrad),
                     step1(neg_lr, g.y, den.y, adagrad),
                     step1(neg_lr, g.z, den.z, adagrad),
                     step1(neg_lr, g.w, den.w, adagrad));
}

// A warp's share of a 128-float block [cb, cb + 128) of a row: 4 floats a
// lane, cb + 4*lane .. + 3 (VEC 4) or cb + lane + 32*j (VEC 1). Columns
// past d load a valid element and are never stored.
template <int VEC> struct WarpCols;
template <> struct WarpCols<4> {
  template <typename E>
  __device__ static float4 load(const E* row, int cb, int lane, int d) {
    const int o = cb + 4 * lane;
    return Elt<E>::load4(row + (o < d ? o : d - 4));
  }
  template <typename E>
  __device__ static void store(E* row, int cb, int lane, int d, float4 v) {
    const int o = cb + 4 * lane;
    if (o < d) Elt<E>::store4(row + o, v);
  }
};
template <> struct WarpCols<1> {
  template <typename E>
  __device__ static float at(const E* row, int o, int d) {
    return Elt<E>::load1(row + (o < d ? o : d - 1));
  }
  template <typename E>
  __device__ static float4 load(const E* row, int cb, int lane, int d) {
    const int o = cb + lane;
    return make_float4(at(row, o, d), at(row, o + 32, d), at(row, o + 64, d),
                       at(row, o + 96, d));
  }
  template <typename E>
  __device__ static void store(E* row, int cb, int lane, int d, float4 v) {
    const int o = cb + lane;
    if (o < d) Elt<E>::store1(row + o, v.x);
    if (o + 32 < d) Elt<E>::store1(row + o + 32, v.y);
    if (o + 64 < d) Elt<E>::store1(row + o + 64, v.z);
    if (o + 96 < d) Elt<E>::store1(row + o + 96, v.w);
  }
};

// A lane group's share of the same block: lane gl of kRunLanes (G) holds
// kQuads quads of 4 floats; quad q is cb + 4*(gl + G*q) .. + 3 (VEC 4) or
// cb + gl + G*(4q + m), m < 4 (VEC 1).
template <int VEC> struct GroupCols;
template <> struct GroupCols<4> {
  template <typename E>
  __device__ static float4 load(const E* row, int cb, int gl, int q, int d) {
    const int o = cb + 4 * (gl + kRunLanes * q);
    return Elt<E>::load4(row + (o < d ? o : d - 4));
  }
  template <typename E>
  __device__ static void store(E* row, int cb, int gl, int q, int d,
                               float4 v) {
    const int o = cb + 4 * (gl + kRunLanes * q);
    if (o < d) Elt<E>::store4(row + o, v);
  }
};
template <> struct GroupCols<1> {
  template <typename E>
  __device__ static float4 load(const E* row, int cb, int gl, int q, int d) {
    const int o = cb + gl + 4 * kRunLanes * q;
    return make_float4(WarpCols<1>::at(row, o, d),
                       WarpCols<1>::at(row, o + kRunLanes, d),
                       WarpCols<1>::at(row, o + 2 * kRunLanes, d),
                       WarpCols<1>::at(row, o + 3 * kRunLanes, d));
  }
  template <typename E>
  __device__ static void store(E* row, int cb, int gl, int q, int d,
                               float4 v) {
    const int o = cb + gl + 4 * kRunLanes * q;
    if (o < d) Elt<E>::store1(row + o, v.x);
    if (o + kRunLanes < d) Elt<E>::store1(row + o + kRunLanes, v.y);
    if (o + 2 * kRunLanes < d) Elt<E>::store1(row + o + 2 * kRunLanes, v.z);
    if (o + 3 * kRunLanes < d) Elt<E>::store1(row + o + 3 * kRunLanes, v.w);
  }
};

// One table's side of a chunk: its sorted ids, the lane each came from,
// the table and its AdaGrad sums, and where a lane's gradient row comes
// from (grad_u for centers; the center's u snapshot for out-lanes, scaled
// by the lane's coefficient).
template <typename E>
struct Side {
  const int32_t* ids;
  const int32_t* perm;
  int64_t n;
  E* w;
  float* g2;
  int64_t rows;
  const float* src;
  bool out;
};

template <typename E>
__device__ __forceinline__ Side<E> side_of(const SgnsArgs& a, int64_t ci,
                                           bool out) {
  const int64_t C = a.chunk, n_out = C * (1 + a.k);
  Side<E> s;
  s.out = out;
  if (out) {
    s.ids = a.out_ids + ci * n_out;
    s.perm = a.out_perm + ci * n_out;
    s.n = n_out;
    s.w = static_cast<E*>(a.w_out);
    s.g2 = a.g_out;
    s.rows = a.v_out;
    s.src = a.u_snap;
  } else {
    s.ids = a.in_ids + ci * C;
    s.perm = a.in_perm + ci * C;
    s.n = C;
    s.w = static_cast<E*>(a.w_in);
    s.g2 = a.g_in;
    s.rows = a.v_in;
    s.src = a.grad_u;
  }
  return s;
}

// The pair an out-lane belongs to: lanes [0, C) are the contexts, lane
// C + b*K + k the k-th negative of pair b.
__device__ __forceinline__ int32_t pair_of(int32_t lane, int C, int K) {
  return lane < C ? lane : (lane - C) / K;
}

// The position of the k-th set bit of m (k from 0).
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  for (int i = 0; i < k; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// A short run of row `row` (len <= kHeld lanes, permutation entries pi),
// by one lane group, lane gl of it. Every load of the run goes out in one
// round trip; both passes read the held rows.
template <typename E, int VEC>
__device__ void apply_short(const Side<E>& sd, const float* coef, int C,
                            int K, int d, int32_t row,
                            const int32_t (&pi)[kHeld], int len,
                            float neg_lr, bool adagrad, int gl) {
  using Cols = GroupCols<VEC>;
  E* w = sd.w + (int64_t)row * d;
  float* g2 = sd.g2 + (int64_t)row * d;
  const float* src[kHeld];
  float cf[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int32_t p = i < len ? pi[i] : pi[0];
    src[i] = sd.src + (int64_t)(sd.out ? pair_of(p, C, K) : p) * d;
    cf[i] = sd.out ? coef[p] : 1.f;
  }
  for (int cb = 0; cb < d; cb += kBlock) {
    float4 wv[kQuads], acc[kQuads], g[kHeld][kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      wv[q] = Cols::load(w, cb, gl, q, d);
      acc[q] = adagrad ? Cols::load(g2, cb, gl, q, d) : zero4();
    }
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (i < len) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q)
          g[i][q] = Cols::load(src[i], cb, gl, q, d);
      }
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (i < len) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) g[i][q] = mul4(cf[i], g[i][q]);
      }
    if (adagrad) {
#pragma unroll
      for (int i = 0; i < kHeld; ++i)
        if (i < len) {
#pragma unroll
          for (int q = 0; q < kQuads; ++q)
            acc[q] = sq_acc4(acc[q], g[i][q]);
        }
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        Cols::store(g2, cb, gl, q, d, acc[q]);
        acc[q] = den4(acc[q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (i < len) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q)
          wv[q] = addw4<E>(wv[q], step4(neg_lr, g[i][q], acc[q], adagrad));
      }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) Cols::store(w, cb, gl, q, d, wv[q]);
  }
}

// Shared memory of the run paths (dynamic: it can be more than 48 KB): a
// ring of tiles of a long run's gradient rows, or, in the tile path, each
// warp's staged rows of a medium run; and the row indices and
// coefficients of a block of a long run's lanes.
struct LongShared {
  union {
    float stage[kRing][kRingLanes][kBlock];
    float med[kWarps][kStaged][kBlock];
  };
  int32_t rb[kPermBlock];  // the row of u_snap (out) or grad_u (in)
  float cf[kPermBlock];    // the lane's coefficient (out) or 1 (in)
};
constexpr int kLongSmem = (int)sizeof(LongShared);

// One 4- or 16-byte copy from global to shared memory, asynchronous.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kRing - 2 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// This lane's 4 floats of block cb of a global row, copied asynchronously
// to the same places of a 128-float row in shared memory (WarpCols'
// layout), and read back.
template <int VEC>
__device__ __forceinline__ void stage_row(float* dst, const float* row,
                                          int cb, int lane, int d) {
  if (VEC == 4) {
    const int o = cb + 4 * lane;
    cp_async<16>(dst + 4 * lane, row + (o < d ? o : d - 4));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = cb + lane + 32 * j;
      cp_async<4>(dst + lane + 32 * j, row + (o < d ? o : d - 1));
    }
  }
}
template <int VEC>
__device__ __forceinline__ float4 staged(const float* src, int lane) {
  if (VEC == 4) return *reinterpret_cast<const float4*>(src + 4 * lane);
  return make_float4(src[lane], src[lane + 32], src[lane + 64],
                     src[lane + 96]);
}

// The run's lanes [i0, i1) (at most kStaged; lane l of the warp holds
// lane l's row of src and coefficient): every row goes out in one round
// trip into the warp's rows of shared memory (each lane copies, and later
// reads back, only its own 4 floats of each, so no barrier).
template <int VEC>
__device__ __forceinline__ void stage_rows(const float* src, int32_t rb_l,
                                           int i0, int i1, int cb, int d,
                                           int lane, float (*rows)[kBlock]) {
  for (int i = i0; i < i1; ++i) {
    const int32_t rb = __shfl_sync(kFull, rb_l, i);
    stage_row<VEC>(rows[i - i0], src + (int64_t)rb * d, cb, lane, d);
  }
  cp_commit();
}

// Fold staged lanes [i0, i1) into acc in lane order: squares (pass 0) or
// steps against den (pass 1).
template <typename E, int VEC>
__device__ __forceinline__ float4 fold_rows(float4 acc, float cf_l, int i0,
                                            int i1, int pass, float4 den,
                                            float neg_lr, bool adagrad,
                                            int lane,
                                            float (*rows)[kBlock]) {
  for (int i = i0; i < i1; ++i) {
    const float cf = __shfl_sync(kFull, cf_l, i);
    const float4 x = mul4(cf, staged<VEC>(rows[i - i0], lane));
    acc = pass == 0 ? sq_acc4(acc, x)
                    : addw4<E>(acc, step4(neg_lr, x, den, adagrad));
  }
  return acc;
}

// A run of kHeld < len < kLongRun lanes by the whole warp; lane l holds
// the permutation entry of the run's lane l. Its gradient rows go out
// beside the row's w and g2, kStaged a round trip; a run of at most
// kStaged lanes keeps them for both passes. Lane order, as apply_short.
template <typename E, int VEC>
__device__ void apply_medium(const Side<E>& sd, const float* coef, int C,
                             int K, int d, int32_t row, int32_t pl, int len,
                             float neg_lr, bool adagrad, int lane,
                             float (*rows)[kBlock]) {
  using Cols = WarpCols<VEC>;
  const bool mine = lane < len;
  const int32_t p = mine ? pl : 0;
  const int32_t rb_l = sd.out ? pair_of(p, C, K) : p;
  const float cf_l = (mine && sd.out) ? coef[p] : 1.f;
  E* w = sd.w + (int64_t)row * d;
  float* g2 = sd.g2 + (int64_t)row * d;
  const bool kept = len <= kStaged;
  for (int cb = 0; cb < d; cb += kBlock) {
    if (kept) stage_rows<VEC>(sd.src, rb_l, 0, len, cb, d, lane, rows);
    float4 wv = Cols::load(w, cb, lane, d);
    float4 acc = adagrad ? Cols::load(g2, cb, lane, d) : zero4();
    for (int pass = adagrad ? 0 : 1; pass < 2; ++pass) {
      for (int i0 = 0; i0 < len; i0 += kStaged) {
        const int i1 = i0 + kStaged < len ? i0 + kStaged : len;
        if (!kept) stage_rows<VEC>(sd.src, rb_l, i0, i1, cb, d, lane, rows);
        cp_wait_all();
        if (pass == 0)
          acc = fold_rows<E, VEC>(acc, cf_l, i0, i1, 0, acc, neg_lr,
                                  adagrad, lane, rows);
        else
          wv = fold_rows<E, VEC>(wv, cf_l, i0, i1, 1, acc, neg_lr, adagrad,
                                 lane, rows);
      }
      if (pass == 0) {
        Cols::store(g2, cb, lane, d, acc);
        acc = den4(acc);
      }
    }
    Cols::store(w, cb, lane, d, wv);
  }
}

// Copy the rows of tile q of the lane block (block lanes
// [q * kRingLanes, ...) < n) into ring slot q % kRing: warp wib takes
// kRingLanes / kWarps of the tile's lanes.
template <int VEC>
__device__ __forceinline__ void ring_issue(LongShared& sh, const float* src,
                                           int q, int n, int cb, int d,
                                           int lane, int wib) {
  constexpr int kPerWarp = kRingLanes / kWarps;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int tl = kPerWarp * wib + i;  // lane of the tile
    const int l = q * kRingLanes + tl;  // lane of the block
    if (l < n)
      stage_row<VEC>(sh.stage[q % kRing][tl], src + (int64_t)sh.rb[l] * d,
                     cb, lane, d);
  }
}

// A long run (first sorted slot `slot`: in slots, then C + out slots) by
// the whole CTA, folded in lane order as the other runs are. The run's
// gradient rows stream through a ring of kRing tiles of kRingLanes rows
// (cp.async: kRing - 1 tiles in flight, no registers held); one thread per
// column turns each landed tile into its terms (squares, or steps against
// the column's denominator) and adds them in lane order. A run that fits
// the ring keeps its tiles for the second pass.
template <typename E, int VEC>
__device__ void apply_long(const SgnsArgs& a, int64_t ci, int32_t slot,
                           float neg_lr, bool adagrad, int lane, int wib,
                           LongShared& sh) {
  using El = Elt<E>;
  const int C = a.chunk, K = a.k, d = a.d;
  const bool out = slot >= C;
  const Side<E> sd = side_of<E>(a, ci, out);
  const int64_t s = out ? slot - C : slot;
  const int32_t row = sd.ids[s];
  // The run's end, by a k-ary search over [s + kLongRun, n): every thread
  // probes one slot a step (the ids are sorted, so the probes that still
  // hold `row` are a prefix), which narrows the span kThreads-fold.
  int64_t lo = s + kLongRun, hi = sd.n;
  while (lo < hi) {
    const int64_t stride = (hi - lo + kThreads - 1) / kThreads;
    const int64_t q = lo + (int64_t)threadIdx.x * stride;
    const int cnt = __syncthreads_count(q < hi && sd.ids[q] == row);
    if (cnt == 0) {
      hi = lo;
      break;
    }
    const int64_t next = lo + (int64_t)cnt * stride;
    if (next < hi) hi = next;
    if (stride == 1) break;
    lo += (int64_t)(cnt - 1) * stride + 1;
  }
  const int64_t e = hi;
  const int t = threadIdx.x;
  // The row index and coefficient of each lane of a block of the run.
  // Each thread's permutation loads go out together, then its
  // coefficient loads: two round trips a block.
  auto index_block = [&](int64_t pb, int n) {
    constexpr int kEach = kPermBlock / kThreads;
    __syncthreads();  // the previous block's are done with
    int32_t p[kEach];
    float cf[kEach];
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      const int i = t + j * kThreads;
      p[j] = i < n ? sd.perm[pb + i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kEach; ++j)
      cf[j] = (out && t + j * kThreads < n) ? a.coef[p[j]] : 1.f;
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      const int i = t + j * kThreads;
      if (i < n) {
        sh.rb[i] = out ? pair_of(p[j], C, K) : p[j];
        sh.cf[i] = cf[j];
      }
    }
    __syncthreads();
  };
  const bool one_block = e - s <= kPermBlock;
  const bool resident = e - s <= kRing * kRingLanes;
  if (one_block) index_block(s, (int)(e - s));
  E* w = sd.w + (int64_t)row * d;
  float* g2 = sd.g2 + (int64_t)row * d;
  for (int cb = 0; cb < d; cb += kBlock) {
    const bool folder = t < kBlock && cb + t < d;
    float acc = (folder && adagrad) ? g2[cb + t] : 0.f;
    float wv = folder ? El::load1(w + cb + t) : 0.f;
    for (int pass = adagrad ? 0 : 1; pass < 2; ++pass) {
      const float den = __fsqrt_rn(__fadd_rn(acc, kAdaEps));
      const bool kept = resident && pass == 1 && adagrad;
      for (int64_t pb = s; pb < e; pb += kPermBlock) {
        const int n = e - pb < kPermBlock ? (int)(e - pb) : kPermBlock;
        if (!one_block) index_block(pb, n);
        const int tiles = (n + kRingLanes - 1) / kRingLanes;
        if (!kept) {
          __syncthreads();  // the ring's last tiles are folded
#pragma unroll
          for (int q = 0; q < kRing - 1; ++q) {
            if (q < tiles)
              ring_issue<VEC>(sh, sd.src, q, n, cb, d, lane, wib);
            cp_commit();
          }
        }
        for (int q = 0; q < tiles; ++q) {
          if (!kept) {
            cp_wait_ring();  // tile q has landed (this thread's copies)
            __syncthreads();  // everyone's copies; tile q - 1 is folded
            if (q + kRing - 1 < tiles)
              ring_issue<VEC>(sh, sd.src, q + kRing - 1, n, cb, d, lane,
                              wib);
            cp_commit();
          }
          if (folder) {
            float(*tile)[kBlock] = sh.stage[q % kRing];
            const float* cf = sh.cf + q * kRingLanes;
            const int m = n - q * kRingLanes < kRingLanes ? n - q * kRingLanes
                                                            : kRingLanes;
            if (m == kRingLanes) {
              // A whole tile: every load and every term first, so only
              // the adds form a chain.
              float x[kRingLanes];
#pragma unroll
              for (int l = 0; l < kRingLanes; ++l) x[l] = tile[l][t];
              if (pass == 0) {
#pragma unroll
                for (int l = 0; l < kRingLanes; ++l) {
                  const float v = __fmul_rn(cf[l], x[l]);
                  x[l] = __fmul_rn(v, v);
                }
#pragma unroll
                for (int l = 0; l < kRingLanes; ++l)
                  acc = __fadd_rn(acc, x[l]);
              } else {
#pragma unroll
                for (int l = 0; l < kRingLanes; ++l)
                  x[l] = El::rnd(
                      step1(neg_lr, __fmul_rn(cf[l], x[l]), den, adagrad));
#pragma unroll
                for (int l = 0; l < kRingLanes; ++l)
                  wv = El::rnd(__fadd_rn(wv, x[l]));
              }
            } else {
              for (int l = 0; l < m; ++l) {
                const float v = __fmul_rn(cf[l], tile[l][t]);
                if (pass == 0)
                  acc = __fadd_rn(acc, __fmul_rn(v, v));
                else
                  wv = El::add(wv, step1(neg_lr, v, den, adagrad));
              }
            }
          }
        }
        if (!kept) cp_wait_all();
      }
    }
    if (folder) {
      if (adagrad) g2[cb + t] = acc;
      El::store1(w + cb + t, wv);
    }
    __syncthreads();  // the ring is free for the next block or run
  }
}

// One tile of 32 sorted slots (tiles [0, tiles_in) are the in slots, the
// rest the out slots): the runs that START there and are shorter than
// kLongRun; this warp takes rounds sub, sub + wpt, ... of its short runs
// and its medium runs sub, sub + wpt, ... A run shorter than kLongRun
// that starts in the tile ends within the 64 slots read.
static_assert(kLongRun >= kHeld + 1 && kLongRun <= 33,
              "a run shorter than kLongRun that starts in a tile of 32 "
              "slots must end within the 64 slots apply_tile reads");
template <typename E, int VEC>
__device__ void apply_tile(const SgnsArgs& a, int64_t ci, int64_t tile,
                           int sub, int wpt, int64_t tiles_in, float neg_lr,
                           bool adagrad, int lane, float (*rows)[kBlock]) {
  const int C = a.chunk, K = a.k, d = a.d;
  const bool out = tile >= tiles_in;
  const Side<E> sd = side_of<E>(a, ci, out);
  const int64_t s0 = (out ? tile - tiles_in : tile) * 32 + lane;
  const int64_t s1 = s0 + 32;
  const bool in0 = s0 < sd.n, in1 = s1 < sd.n;
  const int32_t id0 = in0 ? sd.ids[s0] : 0;
  const int32_t id1 = in1 ? sd.ids[s1] : 0;
  const int32_t pm0 = in0 ? sd.perm[s0] : 0;
  const int32_t pm1 = in1 ? sd.perm[s1] : 0;
  const int32_t before = (lane == 0 && in0 && s0 > 0) ? sd.ids[s0 - 1] : 0;
  const int32_t last0 = __shfl_sync(kFull, id0, 31);
  int32_t prev0 = __shfl_up_sync(kFull, id0, 1);
  int32_t prev1 = __shfl_up_sync(kFull, id1, 1);
  if (lane == 0) {
    prev0 = before;
    prev1 = last0;
  }
  const bool start = in0 && (s0 == 0 || id0 != prev0);
  const unsigned starts = __ballot_sync(kFull, start);
  if (starts == 0) return;
  // An edge is a slot that starts a run or lies past the side's end; a
  // run starting at this lane ends at the next edge after it.
  const bool edge0 = !in0 || s0 == 0 || id0 != prev0;
  const bool edge1 = !in1 || id1 != prev1;
  const uint64_t edges = (uint64_t)__ballot_sync(kFull, edge0) |
                         ((uint64_t)__ballot_sync(kFull, edge1) << 32);
  const uint64_t after = edges >> (lane + 1);
  const int len = after ? __ffsll((long long)after) : 64;
  const bool live = start && len < kLongRun && id0 >= 0 &&
                    (int64_t)id0 < sd.rows;           // mode="drop"
  const unsigned shorts = __ballot_sync(kFull, live && len <= kHeld);
  const unsigned mediums = __ballot_sync(kFull, live && len > kHeld);
  const int group = lane / kRunLanes, gl = lane % kRunLanes;
  const int n_short = __popc(shorts);
  for (int k0 = sub * kGroups; k0 < n_short; k0 += kGroups * wpt) {
    const int k = k0 + group;
    const int src = nth_bit(shorts, k < n_short ? k : k0);
    const int rlen = __shfl_sync(kFull, len, src);
    const int32_t row = __shfl_sync(kFull, id0, src);
    int32_t pi[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int sl = src + i < 63 ? src + i : 63;
      const int32_t lo = __shfl_sync(kFull, pm0, sl & 31);
      const int32_t hi = __shfl_sync(kFull, pm1, sl & 31);
      pi[i] = sl < 32 ? lo : hi;
    }
    if (k < n_short)
      apply_short<E, VEC>(sd, a.coef, C, K, d, row, pi, rlen, neg_lr,
                          adagrad, gl);
    __syncwarp();
  }
  const int n_med = __popc(mediums);
  for (int k = sub; k < n_med; k += wpt) {
    const int src = nth_bit(mediums, k);
    const int rlen = __shfl_sync(kFull, len, src);
    const int32_t row = __shfl_sync(kFull, id0, src);
    const int sl = src + lane < 63 ? src + lane : 63;
    const int32_t lo = __shfl_sync(kFull, pm0, sl & 31);
    const int32_t hi = __shfl_sync(kFull, pm1, sl & 31);
    apply_medium<E, VEC>(sd, a.coef, C, K, d, row, sl < 32 ? lo : hi, rlen,
                         neg_lr, adagrad, lane, rows);
  }
}

// The pair's sigmoid negative-sampling math from its lanes' partial dot
// products: reduces them over the warp, adds the pair's loss terms to the
// sums, turns dneg[k] into the negatives' g_neg and returns g_pos.
template <int KMAX>
__device__ __forceinline__ float ns_math(float dpos, float (&dneg)[KMAX],
                                         int K, float m, float& sum_pos,
                                         float& sum_neg) {
  dpos = warp_sum(dpos);
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < K) dneg[k] = warp_sum(dneg[k]);
  const float s_pos = sigmoidf(dpos);
  float ln = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) {
      const float sk = sigmoidf(dneg[k]);
      ln += m * logf(1.f - sk + kEps);
      dneg[k] = sk * m;
    }
  }
  sum_pos += m * logf(s_pos + kEps);
  sum_neg += ln;
  return (s_pos - 1.f) * m;
}

// Pair p's ids spread over a warp: lane k < K holds negative k, lane K the
// center, lane K + 1 the context.
__device__ __forceinline__ int32_t pair_ids(const SgnsArgs& a, int64_t p,
                                            int lane) {
  if (lane < a.k) return a.negatives[p * a.k + lane];
  if (lane == a.k) return a.centers[p];
  if (lane == a.k + 1) return a.contexts[p];
  return 0;
}

template <typename E, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgns_block_kernel(SgnsArgs a) {
  using L = Ld<VEC>;
  using T = typename L::T;
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_pos[kWarps];
  __shared__ float warp_neg[kWarps];
  extern __shared__ __align__(16) unsigned char smem[];
  LongShared& long_sh = *reinterpret_cast<LongShared*>(smem);

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t gwarp = (int64_t)blockIdx.x * kWarps + wib;
  const int64_t nwarps = (int64_t)gridDim.x * kWarps;
  const int C = a.chunk, K = a.k, D = a.d, dv = D / VEC;
  const int64_t n_out_lanes = (int64_t)C * (1 + K);
  const int64_t tiles_in = (C + 31) / 32;
  const int64_t n_tiles = tiles_in + (n_out_lanes + 31) / 32;
  const int64_t n_pairs = *a.n_pairs;
  int64_t n_live = (n_pairs + C - 1) / C;
  if (n_live > a.n_chunks) n_live = a.n_chunks;
  const float neg_lr = -a.lr;
  const bool adagrad = a.adagrad != 0;
  const bool loss_warp = blockIdx.x == gridDim.x - 1 && wib == 0;
  float total = 0.f;  // meaningful in the loss warp only
  PROF_START;

  for (int64_t ci = 0; ci < n_live; ++ci) {
    // -- phase 1: gather, loss, gradient scratch; one warp per pair ------
    float sum_pos = 0.f, sum_neg = 0.f;  // sums of m*log(...) (all lanes)
    int32_t ids = gwarp < C ? pair_ids(a, ci * C + gwarp, lane) : 0;
    for (int64_t b = gwarp; b < C; b += nwarps) {
      const int64_t nb = b + nwarps;
      const int32_t next_ids = nb < C ? pair_ids(a, ci * C + nb, lane) : 0;
      const int64_t p = ci * C + b;
      const float m = (p < n_pairs) ? 1.f : 0.f;
      const int64_t cr = clip(__shfl_sync(kFull, ids, K), a.v_in);
      const int64_t orow = clip(__shfl_sync(kFull, ids, K + 1), a.v_out);
      int32_t nr[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int32_t x = __shfl_sync(kFull, ids, k);
        nr[k] = k < K ? (int32_t)clip(x, a.v_out) : 0;
      }
      const E* w_out = static_cast<const E*>(a.w_out);
      const E* u = static_cast<const E*>(a.w_in) + cr * D;
      const E* vp = w_out + orow * D;
      T* gu = reinterpret_cast<T*>(a.grad_u + b * D);
      T* us = reinterpret_cast<T*>(a.u_snap + b * D);
      float dpos = 0.f, dneg[KMAX], g_pos;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) dneg[k] = 0.f;
      if (dv <= 32) {  // a row in one pass: every row loaded once
        const bool col = lane < dv;
        const int c = col ? lane : 0;
        const T uu = L::at(u, c), vv = L::at(vp, c);
        T vn[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          vn[k] = k < K ? L::at(w_out + (int64_t)nr[k] * D, c) : L::zero();
        if (col) {
          dpos = L::dot(uu, vv);
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K) dneg[k] = L::dot(uu, vn[k]);
        }
        g_pos = ns_math<KMAX>(dpos, dneg, K, m, sum_pos, sum_neg);
        if (col) {
          T acc = L::zero();
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K) acc = L::add(acc, L::scale(dneg[k], vn[k]));
          gu[c] = L::add(L::scale(g_pos, vv), acc);
          us[c] = uu;
        }
      } else {
        for (int c = lane; c < dv; c += 32) {
          const T uu = L::at(u, c);
          dpos += L::dot(uu, L::at(vp, c));
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K)
              dneg[k] += L::dot(uu, L::at(w_out + (int64_t)nr[k] * D, c));
        }
        g_pos = ns_math<KMAX>(dpos, dneg, K, m, sum_pos, sum_neg);
        for (int c = lane; c < dv; c += 32) {
          const T uu = L::at(u, c);
          T acc = L::zero();
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K)
              acc = L::add(acc, L::scale(dneg[k],
                                         L::at(w_out + (int64_t)nr[k] * D,
                                               c)));
          gu[c] = L::add(L::scale(g_pos, L::at(vp, c)), acc);
          us[c] = uu;
        }
      }
      // Every lane holds the same sums (a xor butterfly adds each pair of
      // partial sums in both orders, which round alike).
      if (lane == 0) a.coef[b] = g_pos;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K && lane == k + 1) a.coef[C + b * K + k] = dneg[k];
      ids = next_ids;
    }
    PROF_MARK(0);
    // The chunk's long runs, for phase 2: the first sorted slot (in slots,
    // then C + out slots) of every run of at least kLongRun equal
    // in-range ids. The list's order does not matter: each run is applied
    // whole by one CTA.
    for (int64_t t = gwarp; t < n_tiles; t += nwarps) {
      const bool out = t >= tiles_in;
      const int32_t* sids = out ? a.out_ids + ci * n_out_lanes
                                : a.in_ids + ci * C;
      const int64_t n = out ? n_out_lanes : C;
      const int64_t rows = out ? a.v_out : a.v_in;
      const int64_t s = (out ? t - tiles_in : t) * 32 + lane;
      const int64_t last = s + kLongRun - 1;
      const int32_t r = s < n ? sids[s] : 0;
      const int32_t prev = (s < n && s > 0) ? sids[s - 1] : 0;
      const int32_t tail = last < n ? sids[last] : 0;
      const bool is_long = last < n && (s == 0 || prev != r) && tail == r &&
                           r >= 0 && r < rows;
      const unsigned longs = __ballot_sync(kFull, is_long);
      if (longs) {
        int first = 0;
        if (lane == 0) first = atomicAdd(a.counts + ci, __popc(longs));
        first = __shfl_sync(kFull, first, 0);
        if (is_long)
          a.long_runs[first + __popc(longs & ((1u << lane) - 1u))] =
              (int32_t)(out ? C + s : s);
      }
    }
    PROF_MARK(1);
    if (lane == 0) {
      warp_pos[wib] = sum_pos;
      warp_neg[wib] = sum_neg;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sp = 0.f, sn = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sp += warp_pos[w];
        sn += warp_neg[w];
      }
      a.loss_partials[2 * blockIdx.x] = sp;
      a.loss_partials[2 * blockIdx.x + 1] = sn;
    }
    PROF_MARK(2);
    grid.sync();
    PROF_MARK(3);

    // -- phase 2: the updates, one owner per run -------------------------
    if (loss_warp) {  // the CTAs' partials in a fixed order
      float sp = 0.f, sn = 0.f;
      for (unsigned q = lane; q < gridDim.x; q += 32) {
        sp += a.loss_partials[2 * q];
        sn += a.loss_partials[2 * q + 1];
      }
      sp = warp_sum(sp);
      sn = warp_sum(sn);
      total = total + (-sp - sn);
    }
    PROF_MARK(4);
    const int n_long = a.counts[ci];
    for (int q = blockIdx.x; q < n_long; q += gridDim.x)
      apply_long<E, VEC>(a, ci, a.long_runs[q], neg_lr, adagrad, lane, wib,
                         long_sh);
    PROF_MARK(5);
    // Tiles of short runs: the warps of the CTAs without a long run take
    // one each (a tile split over wpt warps while there are warps to
    // spare); tiles beyond those go to whichever warp asks the chunk's
    // counter first, the long-run CTAs' included.
    const int long_ctas = n_long < (int)gridDim.x ? n_long : (int)gridDim.x;
    const int64_t short_warps = (int64_t)(gridDim.x - long_ctas) * kWarps;
    int wpt = 1;
    while (wpt < kGroups && n_tiles * wpt * 2 <= short_warps) wpt *= 2;
    const int64_t n_virtual = n_tiles * wpt;
    if ((int)blockIdx.x >= long_ctas) {
      const int64_t v = (int64_t)(blockIdx.x - long_ctas) * kWarps + wib;
      if (v < n_virtual)
        apply_tile<E, VEC>(a, ci, v / wpt, (int)(v % wpt), wpt, tiles_in,
                           neg_lr, adagrad, lane, long_sh.med[wib]);
    }
    if (n_virtual > short_warps) {
      for (;;) {
        int taken = 0;
        if (lane == 0) taken = atomicAdd(a.counts + a.n_chunks + ci, 1);
        const int64_t v = short_warps + __shfl_sync(kFull, taken, 0);
        if (v >= n_virtual) break;
        apply_tile<E, VEC>(a, ci, v / wpt, (int)(v % wpt), wpt, tiles_in,
                           neg_lr, adagrad, lane, long_sh.med[wib]);
      }
    }
    PROF_MARK(6);
    grid.sync();
    PROF_MARK(7);
  }
  if (loss_warp && lane == 0) *a.loss_out = total;
}

// Let each instance take kLongSmem bytes of dynamic shared memory, once
// per device.
template <typename E, int VEC, int KMAX>
void allow_smem() {
  static bool done[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !done[dev]) {
    cudaFuncSetAttribute(sgns_block_kernel<E, VEC, KMAX>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kLongSmem);
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
}

template <typename E, int VEC, int KMAX>
int launch(SgnsArgs a, int grid, cudaStream_t st) {
  allow_smem<E, VEC, KMAX>();
  void* params[] = {&a};
  cudaLaunchCooperativeKernel((const void*)sgns_block_kernel<E, VEC, KMAX>,
                              dim3(grid), dim3(kThreads), params, kLongSmem,
                              st);
  return (int)cudaGetLastError();
}

template <typename E, int VEC, int KMAX>
int occupancy_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  allow_smem<E, VEC, KMAX>();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sgns_block_kernel<E, VEC, KMAX>, kThreads, kLongSmem);
  return per_sm * sms;
}

template <typename E>
int grid_size(int d, int k) {
  if (d % 4 == 0)
    return k <= kSmallNeg ? occupancy_grid<E, 4, kSmallNeg>()
                          : occupancy_grid<E, 4, kMaxNeg>();
  return k <= kSmallNeg ? occupancy_grid<E, 1, kSmallNeg>()
                        : occupancy_grid<E, 1, kMaxNeg>();
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue, launching nothing, when long_cap (the length of
// long_runs) is short of the most long runs one chunk can list.
template <typename E>
int block(void* w_in, void* w_out, float* g_in, float* g_out, int64_t v_in,
          int64_t v_out, const int32_t* centers, const int32_t* contexts,
          const int32_t* negatives, const int32_t* in_ids,
          const int32_t* in_perm, const int32_t* out_ids,
          const int32_t* out_perm, const int32_t* n_pairs, float* grad_u,
          float* u_snap, float* coef, float* loss_partials, float* loss_out,
          int64_t n_chunks, int chunk, int k, int d, float lr, int adagrad,
          int grid, int32_t* long_runs, int64_t long_cap, int32_t* counts,
          void* stream) {
  if (long_cap < chunk / kLongRun + (int64_t)chunk * (1 + k) / kLongRun)
    return (int)cudaErrorInvalidValue;
  SgnsArgs a{w_in,      w_out,    g_in,     g_out,    v_in,     v_out,
             centers,   contexts, negatives, in_ids,  in_perm,  out_ids,
             out_perm,  n_pairs,  grad_u,   u_snap,   coef,     loss_partials,
             loss_out,  n_chunks, chunk,    k,        d,        lr,
             adagrad,   long_runs, counts};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d % 4 == 0)
    return k <= kSmallNeg ? launch<E, 4, kSmallNeg>(a, grid, st)
                          : launch<E, 4, kMaxNeg>(a, grid, st);
  return k <= kSmallNeg ? launch<E, 1, kSmallNeg>(a, grid, st)
                        : launch<E, 1, kMaxNeg>(a, grid, st);
}

}  // namespace

extern "C" {

// Lanes from which a run of equal ids is applied by a whole CTA.
int mv_sgns_long_run() { return kLongRun; }

// CTAs of the cooperative grid for this D and K (every CTA resident), for
// float and for bfloat16 embeddings.
int mv_sgns_grid_size(int d, int k) { return grid_size<float>(d, k); }
int mv_sgns_grid_size_bf16(int d, int k) {
  return grid_size<__nv_bfloat16>(d, k);
}

// One launch on float embeddings (w_in, w_out: float*) or on bfloat16
// embeddings (__nv_bfloat16*); see block() for the return value.
#define MV_SGNS_BLOCK_ARGS                                                   \
  void *w_in, void *w_out, float *g_in, float *g_out, int64_t v_in,          \
      int64_t v_out, const int32_t *centers, const int32_t *contexts,        \
      const int32_t *negatives, const int32_t *in_ids,                       \
      const int32_t *in_perm, const int32_t *out_ids,                        \
      const int32_t *out_perm, const int32_t *n_pairs, float *grad_u,        \
      float *u_snap, float *coef, float *loss_partials, float *loss_out,     \
      int64_t n_chunks, int chunk, int k, int d, float lr, int adagrad,      \
      int grid, int32_t *long_runs, int64_t long_cap, int32_t *counts,       \
      void *stream
#define MV_SGNS_BLOCK_PASS                                                   \
  w_in, w_out, g_in, g_out, v_in, v_out, centers, contexts, negatives,       \
      in_ids, in_perm, out_ids, out_perm, n_pairs, grad_u, u_snap, coef,     \
      loss_partials, loss_out, n_chunks, chunk, k, d, lr, adagrad, grid,     \
      long_runs, long_cap, counts, stream
int mv_sgns_block(MV_SGNS_BLOCK_ARGS) {
  return block<float>(MV_SGNS_BLOCK_PASS);
}
int mv_sgns_block_bf16(MV_SGNS_BLOCK_ARGS) {
  return block<__nv_bfloat16>(MV_SGNS_BLOCK_PASS);
}

#ifdef MV_SGNS_PROFILE
// The phase marks' counters: [0, 8) cycle sums, [8, 16) the largest on one
// CTA; cleared after the read.
int mv_sgns_profile(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  unsigned long long zero[16] = {0};
  cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
