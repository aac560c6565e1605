// Whole-block skip-gram / negative-sampling trainer for Hopper (sm_90a).
//
// mv_sgns_block replaces multiverso_tpu/ops/pallas_sgns.py::
// build_sgns_grid_step (B5): one launch trains every live chunk of a
// block, in order, each chunk being raw_sg_ns_step
// (multiverso_tpu/models/word2vec/model.py:288-305): gather u, v_pos and
// v_neg (ids clipped), the sigmoid negative-sampling loss and gradients
// (_ns_grads), then the AdaGrad (or SGD) update of w_in by centers and of
// w_out by contexts followed by negatives (_apply_update), with the lanes
// past n_pairs masked and the loss summed over the chunks.
//
// What bounds it on this card: bytes and latency, not arithmetic. A chunk
// of C pairs gathers C*(2+K) rows and read-modify-writes the touched rows
// of four tables (about 100 MB at the flagship's V=50,000, D=128: twice
// the 50 MB L2), at ~10 flops per byte moved.
//
// Design. On the TPU the four tables sat in VMEM for the whole grid. The
// H100 has 227 KB of shared memory per SM, so here the tables stay in
// HBM/L2 and ONE persistent cooperative launch walks the chunks: the grid
// is sized by occupancy so every CTA is resident, and grid.sync() stands
// in for the TPU's sequential grid step. Per live chunk i < ceil(n_pairs/C)
// (n_pairs is read on the device):
//   1. one warp per pair gathers its rows with 16-byte loads, reduces the
//      1+K dot products with warp shuffles, and writes the gradient rows
//      (grad_u [C,D], grad_out [C*(1+K),D] in the order of
//      concat(contexts, negatives.flatten())) to scratch, plus a per-CTA
//      loss partial; the warps also list the chunk's long runs (below);
//   2. grid.sync(); CTA 0 adds the partials in a fixed order (so the loss
//      is deterministic); one warp per run of equal row ids (from a stable
//      sort done before the launch) applies the run's lanes in lane order:
//      g[r] += grad^2 over the whole run, then w[r] += -lr*grad/sqrt(g[r]
//      + 1e-6) lane by lane with the final g[r] — the order of the JAX
//      scatter-adds, with no float atomics. A warp takes 32 sorted slots
//      at a time, finds the runs that start there with one ballot and
//      each run's end 32 ids per ballot, and loads the run's gradient rows
//      16 lanes at a time. A run of one frequent id can be hundreds of
//      lanes long (unigram^0.75 negatives), and its lane-order chain of
//      loads would hold the whole grid at the next barrier: runs of at
//      least long_min lanes (their starts listed in phase 1, one ballot
//      and one atomic per 32 sorted slots) go to a whole CTA, which
//      stages their gradient rows through shared memory 64 lanes per
//      round trip and folds them one float column per thread; those CTAs
//      take no short runs. The glue sorts the masked lanes (exact zero
//      gradients) to the end as an out-of-range id, which is dropped. The
//      w_in runs and the w_out runs touch different tables, so they share
//      one phase;
//   3. grid.sync() before the next chunk reads the updated rows.
// Dead chunks (all lanes masked) are skipped: in JAX they are bitwise
// no-ops. Registers bound the occupancy (every CTA must be resident for
// the grid barrier), so the kernel is built for at most 8 negatives and
// for at most 16, and launched with the smaller variant that fits. The
// update arithmetic uses explicitly rounded operations (__fmul_rn,
// __fadd_rn, ...) so no multiply-add is contracted and each element
// rounds as the plain torch chain does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNeg = 16;
constexpr int kSmallNeg = 8;     // the variant for negative <= 8
constexpr float kEps = 1e-7f;    // model.py _EPS
constexpr float kAdaEps = 1e-6f; // _apply_update's sqrt(g2 + 1e-6)
constexpr int kBatch = 16;       // run lanes whose loads go out together
constexpr int kStageBytes = 32768;  // a CTA's staging tile for long runs

struct SgnsArgs {
  float* w_in;
  float* w_out;
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
  float* grad_out;           // scratch [C*(1+K), D]
  float* loss_partials;      // scratch [2 * gridDim.x]
  float* loss_out;           // [1]
  int64_t n_chunks;
  int chunk;
  int k;
  int d;
  float lr;
  int adagrad;
  int32_t* long_runs;        // [n_chunks, long_cap]: a run's first slot
  int32_t* long_count;       // [n_chunks], zero at launch
  int long_cap;
  int long_min;              // runs this long or longer go to a CTA
};

__device__ __forceinline__ int64_t clip(int64_t r, int64_t n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int VEC> struct Ld;
template <> struct Ld<4> {
  using T = float4;
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
  __device__ static T sq_acc(T acc, T g) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(g.x, g.x)),
                       __fadd_rn(acc.y, __fmul_rn(g.y, g.y)),
                       __fadd_rn(acc.z, __fmul_rn(g.z, g.z)),
                       __fadd_rn(acc.w, __fmul_rn(g.w, g.w)));
  }
};
template <> struct Ld<1> {
  using T = float;
  __device__ static float dot(T a, T b) { return a * b; }
  __device__ static T scale(float s, T a) { return __fmul_rn(s, a); }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ static T zero() { return 0.f; }
  __device__ static T sq_acc(T acc, T g) {
    return __fadd_rn(acc, __fmul_rn(g, g));
  }
};

// -lr*grad/sqrt(g2 + 1e-6) (AdaGrad) or -lr*grad (SGD), one element.
__device__ __forceinline__ float step_of(float grad, float g2, float neg_lr,
                                         bool adagrad) {
  const float s = __fmul_rn(neg_lr, grad);
  return adagrad ? __fdiv_rn(s, __fsqrt_rn(__fadd_rn(g2, kAdaEps))) : s;
}

template <int VEC> struct Upd;
template <> struct Upd<4> {
  __device__ static float4 step(float4 g, float4 g2, float nl, bool ada) {
    return make_float4(step_of(g.x, g2.x, nl, ada), step_of(g.y, g2.y, nl, ada),
                       step_of(g.z, g2.z, nl, ada), step_of(g.w, g2.w, nl, ada));
  }
};
template <> struct Upd<1> {
  __device__ static float step(float g, float g2, float nl, bool ada) {
    return step_of(g, g2, nl, ada);
  }
};

// Apply one sorted run [s, e) of lanes to row r of (w, g2), lane order.
// The run's permutation entries arrive 32 per coalesced load and are
// broadcast with shuffles, so each batch of kBatch lanes costs one round
// trip (its gradient rows) instead of two; the row's w and g2 are both
// loaded before any store.
template <int VEC>
__device__ void apply_run(float* w, float* g2, const float* grad,
                          const int32_t* perm, int64_t s, int64_t e, int d,
                          float neg_lr, bool adagrad, int lane) {
  using L = Ld<VEC>;
  using T = typename L::T;
  const int dv = d / VEC;
  T* wr = reinterpret_cast<T*>(w);
  T* gr = reinterpret_cast<T*>(g2);
  for (int c0 = 0; c0 < dv; c0 += 32) {   // warp-uniform trip count
    const int c = c0 + lane;
    const bool col = c < dv;
    T wv = col ? wr[c] : L::zero();
    T acc = (col && adagrad) ? gr[c] : L::zero();
    for (int pass = adagrad ? 0 : 1; pass < 2; ++pass) {
      for (int64_t j = s; j < e; j += 32) {
        const int n = e - j < 32 ? (int)(e - j) : 32;
        const int32_t mine = lane < n ? perm[j + lane] : 0;
        for (int q0 = 0; q0 < n; q0 += kBatch) {
          T buf[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int32_t row = __shfl_sync(0xffffffffu, mine, (q0 + q) & 31);
            if (col && q0 + q < n)
              buf[q] = reinterpret_cast<const T*>(grad + (int64_t)row * d)[c];
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            if (q0 + q < n) {
              if (pass == 0)
                acc = L::sq_acc(acc, buf[q]);
              else
                wv = L::add(wv, Upd<VEC>::step(buf[q], acc, neg_lr, adagrad));
            }
          }
        }
      }
    }
    if (col) {
      if (adagrad) gr[c] = acc;
      wr[c] = wv;
    }
  }
}

// Apply one LONG run [s, e) with the whole CTA: all 256 threads stage
// tiles of the run's gradient rows in shared memory (one round trip per
// tile instead of one per 16 lanes), then one thread per float column
// folds the tile in lane order, exactly as apply_run does.
__device__ void apply_run_cta(float* w, float* g2, const float* grad,
                              const int32_t* perm, int64_t s, int64_t e,
                              int d, float neg_lr, bool adagrad,
                              float* stage) {
  using L = Ld<1>;
  using T = float;
  constexpr int kSlots = kStageBytes / (int)sizeof(T);
  const int dv = d;
  T* wr = reinterpret_cast<T*>(w);
  T* gr = reinterpret_cast<T*>(g2);
  for (int c0 = 0; c0 < dv; c0 += kThreads) {
    const int cols = dv - c0 < kThreads ? dv - c0 : kThreads;
    const int tile = kSlots / cols;
    const int c = c0 + (int)threadIdx.x;
    const bool col = (int)threadIdx.x < cols;
    T wv = col ? wr[c] : L::zero();
    T acc = (col && adagrad) ? gr[c] : L::zero();
    for (int pass = adagrad ? 0 : 1; pass < 2; ++pass) {
      for (int64_t j0 = s; j0 < e; j0 += tile) {
        const int n = e - j0 < tile ? (int)(e - j0) : tile;
        __syncthreads();  // the previous tile has been folded
        for (int i = threadIdx.x; i < n * cols; i += kThreads) {
          const int l = i / cols;
          stage[i] = reinterpret_cast<const T*>(
              grad + (int64_t)perm[j0 + l] * d)[c0 + i - l * cols];
        }
        __syncthreads();
        if (col) {
          for (int l = 0; l < n; ++l) {
            const T v = stage[l * cols + threadIdx.x];
            if (pass == 0)
              acc = L::sq_acc(acc, v);
            else
              wv = L::add(wv, Upd<1>::step(v, acc, neg_lr, adagrad));
          }
        }
      }
    }
    if (col) {
      if (adagrad) gr[c] = acc;
      wr[c] = wv;
    }
  }
  __syncthreads();  // the stage is free for the next run
}

// The end of the run of ``r`` that starts at s: 32 ids per step, one
// ballot each, instead of one dependent load per lane.
__device__ __forceinline__ int64_t run_end(const int32_t* ids, int64_t s,
                                           int64_t n, int32_t r, int lane) {
  int64_t e = s + 1;
  while (true) {
    const int64_t q = e + lane;
    const unsigned differ =
        __ballot_sync(0xffffffffu, !(q < n && ids[q] == r));
    if (differ) return e + __ffs(differ) - 1;
    e += 32;
  }
}

template <int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads, 2)
sgns_block_kernel(SgnsArgs a) {
  using L = Ld<VEC>;
  using T = typename L::T;
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_pos[kThreads / 32];
  __shared__ float warp_neg[kThreads / 32];
  __shared__ __align__(16) unsigned char stage_raw[kStageBytes];
  __shared__ int64_t long_end;

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t gwarp = (int64_t)blockIdx.x * (kThreads / 32) + wib;
  const int64_t nwarps = (int64_t)gridDim.x * (kThreads / 32);
  const int C = a.chunk, K = a.k, D = a.d, dv = D / VEC;
  const int64_t n_out_lanes = (int64_t)C * (1 + K);
  const int64_t n_pairs = *a.n_pairs;
  int64_t n_live = (n_pairs + C - 1) / C;
  if (n_live > a.n_chunks) n_live = a.n_chunks;
  const float neg_lr = -a.lr;
  const bool adagrad = a.adagrad != 0;
  float total = 0.f;  // meaningful in CTA 0, thread 0 only

  for (int64_t ci = 0; ci < n_live; ++ci) {
    // -- phase 1: gather, loss and gradients, one warp per pair ----------
    float sum_pos = 0.f, sum_neg = 0.f;  // sums of m*log(...) (all lanes)
    for (int64_t b = gwarp; b < C; b += nwarps) {
      const int64_t p = ci * C + b;
      const float m = (p < n_pairs) ? 1.f : 0.f;
      const int64_t cr = clip(a.centers[p], a.v_in);
      const int64_t orow = clip(a.contexts[p], a.v_out);
      int32_t nr[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        nr[k] = k < K ? (int32_t)clip(a.negatives[p * K + k], a.v_out) : 0;
      const T* u = reinterpret_cast<const T*>(a.w_in + cr * D);
      const T* vp = reinterpret_cast<const T*>(a.w_out + orow * D);
      float dpos = 0.f, dneg[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) dneg[k] = 0.f;
      for (int c = lane; c < dv; c += 32) {
        const T uu = u[c];
        dpos += L::dot(uu, vp[c]);
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K)
            dneg[k] += L::dot(uu, reinterpret_cast<const T*>(
                                      a.w_out + (int64_t)nr[k] * D)[c]);
      }
      dpos = warp_sum(dpos);
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) dneg[k] = warp_sum(dneg[k]);
      const float s_pos = sigmoidf(dpos);
      const float g_pos = (s_pos - 1.f) * m;
      float ln = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const float sk = sigmoidf(dneg[k]);
          ln += m * logf(1.f - sk + kEps);
          dneg[k] = sk * m;  // from here on: the negative's g_neg
        }
      }
      sum_pos += m * logf(s_pos + kEps);
      sum_neg += ln;
      T* gu = reinterpret_cast<T*>(a.grad_u + b * D);
      T* gp = reinterpret_cast<T*>(a.grad_out + b * D);
      for (int c = lane; c < dv; c += 32) {
        const T uu = u[c];
        T acc = L::zero();
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) {
            acc = L::add(acc, L::scale(dneg[k], reinterpret_cast<const T*>(
                                                    a.w_out +
                                                    (int64_t)nr[k] * D)[c]));
            reinterpret_cast<T*>(a.grad_out +
                                 ((int64_t)C + b * K + k) * D)[c] =
                L::scale(dneg[k], uu);
          }
        }
        gu[c] = L::add(L::scale(g_pos, vp[c]), acc);
        gp[c] = L::scale(g_pos, uu);
      }
    }
    // The chunk's long runs, for phase 2: the first sorted slot (the C
    // in-slots, then the C*(1+K) out-slots) of every run of at least
    // long_min equal in-range ids. The list's order does not matter: each
    // run is applied whole by one CTA.
    const int32_t* in_ids = a.in_ids + ci * C;
    const int32_t* out_ids = a.out_ids + ci * n_out_lanes;
    for (int64_t base = gwarp * 32; base < C + n_out_lanes;
         base += nwarps * 32) {
      const int64_t j = base + lane;
      bool is_long = false;
      if (j < C + n_out_lanes) {
        const bool is_in = j < C;
        const int32_t* ids = is_in ? in_ids : out_ids;
        const int64_t jj = is_in ? j : j - C;
        const int64_t last = jj + a.long_min - 1;
        const int32_t r = ids[jj];
        is_long = (jj == 0 || ids[jj - 1] != r) &&
                  last < (is_in ? C : n_out_lanes) && ids[last] == r &&
                  r >= 0 && r < (is_in ? a.v_in : a.v_out);
      }
      const unsigned longs = __ballot_sync(0xffffffffu, is_long);
      if (longs) {
        int first = 0;
        if (lane == 0) first = atomicAdd(a.long_count + ci, __popc(longs));
        first = __shfl_sync(0xffffffffu, first, 0);
        if (is_long)
          a.long_runs[ci * a.long_cap + first +
                      __popc(longs & ((1u << lane) - 1u))] = (int32_t)j;
      }
    }
    if (lane == 0) {
      warp_pos[wib] = sum_pos;
      warp_neg[wib] = sum_neg;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sp = 0.f, sn = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        sp += warp_pos[w];
        sn += warp_neg[w];
      }
      a.loss_partials[2 * blockIdx.x] = sp;
      a.loss_partials[2 * blockIdx.x + 1] = sn;
    }
    grid.sync();

    // -- phase 2: one warp per run of equal ids, w_in and w_out ----------
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      float sp = 0.f, sn = 0.f;
      for (unsigned q = 0; q < gridDim.x; ++q) {
        sp += a.loss_partials[2 * q];
        sn += a.loss_partials[2 * q + 1];
      }
      total = total + (-sp - sn);
    }
    // The chunk's long runs (listed in phase 1), one CTA each; while
    // there are fewer long runs than CTAs, the CTAs that take one apply
    // no short runs, so a long run does not queue behind short ones.
    const int n_long = a.long_count[ci];
    const int first_short = n_long < (int)gridDim.x ? n_long : 0;
    for (int q = blockIdx.x; q < n_long; q += gridDim.x) {
      const int64_t slot = a.long_runs[ci * a.long_cap + q];
      const bool is_in = slot < C;
      const int64_t s = is_in ? slot : slot - C;
      const int32_t* ids = is_in ? in_ids : out_ids;
      const int32_t rr = ids[s];
      if (threadIdx.x < 32) {
        const int64_t end = run_end(ids, s, is_in ? C : n_out_lanes, rr,
                                    lane);
        if (lane == 0) long_end = end;
      }
      __syncthreads();
      const int64_t e = long_end;
      // Scalar columns: D threads fold a tile, one column each.
      if (is_in)
        apply_run_cta(a.w_in + (int64_t)rr * D, a.g_in + (int64_t)rr * D,
                      a.grad_u, a.in_perm + ci * C, s, e, D, neg_lr,
                      adagrad, reinterpret_cast<float*>(stage_raw));
      else
        apply_run_cta(a.w_out + (int64_t)rr * D, a.g_out + (int64_t)rr * D,
                      a.grad_out, a.out_perm + ci * n_out_lanes, s, e, D,
                      neg_lr, adagrad, reinterpret_cast<float*>(stage_raw));
    }
    // The other runs: each warp owns 32 consecutive sorted slots (the C
    // in-slots then the C*(1+K) out-slots) at a time and applies the runs
    // that START there.
    const int64_t short_warps =
        (int64_t)(gridDim.x - first_short) * (kThreads / 32);
    const int64_t short_warp =
        ((int64_t)blockIdx.x - first_short) * (kThreads / 32) + wib;
    for (int64_t base = short_warp * 32;
         short_warp >= 0 && base < C + n_out_lanes;
         base += short_warps * 32) {
      const int64_t j = base + lane;
      bool start = false;
      int32_t r = 0;
      if (j < C + n_out_lanes) {
        const bool is_in = j < C;
        const int32_t* ids = is_in ? in_ids : out_ids;
        const int64_t jj = is_in ? j : j - C;
        r = ids[jj];
        start = jj == 0 || ids[jj - 1] != r;
      }
      unsigned starts = __ballot_sync(0xffffffffu, start);
      while (starts) {
        const int src = __ffs(starts) - 1;
        starts &= starts - 1;
        const int32_t rr = __shfl_sync(0xffffffffu, r, src);
        const int64_t js = base + src;
        const bool is_in = js < C;
        const int64_t s = is_in ? js : js - C;
        const int64_t n_l = is_in ? C : n_out_lanes;
        const int64_t e = run_end(is_in ? in_ids : out_ids, s, n_l, rr, lane);
        const int64_t rows = is_in ? a.v_in : a.v_out;
        if (e - s >= a.long_min) continue;   // a CTA applied it
        if (rr < 0 || rr >= rows) continue;  // mode="drop"
        if (is_in)
          apply_run<VEC>(a.w_in + (int64_t)rr * D, a.g_in + (int64_t)rr * D,
                         a.grad_u, a.in_perm + ci * C, s, e, D, neg_lr,
                         adagrad, lane);
        else
          apply_run<VEC>(a.w_out + (int64_t)rr * D,
                         a.g_out + (int64_t)rr * D, a.grad_out,
                         a.out_perm + ci * n_out_lanes, s, e, D, neg_lr,
                         adagrad, lane);
      }
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.loss_out = total;
}

template <int VEC, int KMAX>
int launch(SgnsArgs a, int grid, cudaStream_t st) {
  void* params[] = {&a};
  cudaLaunchCooperativeKernel((const void*)sgns_block_kernel<VEC, KMAX>,
                              dim3(grid), dim3(kThreads), params, 0, st);
  return (int)cudaGetLastError();
}

template <int VEC, int KMAX>
int occupancy_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sgns_block_kernel<VEC, KMAX>, kThreads, 0);
  return per_sm * sms;
}

}  // namespace

extern "C" {

// CTAs of the cooperative grid for this D and K (every CTA resident).
int mv_sgns_grid_size(int d, int k) {
  if (d % 4 == 0)
    return k <= kSmallNeg ? occupancy_grid<4, kSmallNeg>()
                          : occupancy_grid<4, kMaxNeg>();
  return k <= kSmallNeg ? occupancy_grid<1, kSmallNeg>()
                        : occupancy_grid<1, kMaxNeg>();
}

// Returns cudaGetLastError() after the launch (0 = launched).
int mv_sgns_block(float* w_in, float* w_out, float* g_in, float* g_out,
                  int64_t v_in, int64_t v_out, const int32_t* centers,
                  const int32_t* contexts, const int32_t* negatives,
                  const int32_t* in_ids, const int32_t* in_perm,
                  const int32_t* out_ids, const int32_t* out_perm,
                  const int32_t* n_pairs, float* grad_u, float* grad_out,
                  float* loss_partials, float* loss_out, int64_t n_chunks,
                  int chunk, int k, int d, float lr, int adagrad, int grid,
                  int32_t* long_runs, int32_t* long_count, int long_cap,
                  int long_min, void* stream) {
  SgnsArgs a{w_in,   w_out,    g_in,     g_out,    v_in,          v_out,
             centers, contexts, negatives, in_ids,  in_perm,       out_ids,
             out_perm, n_pairs, grad_u,   grad_out, loss_partials, loss_out,
             n_chunks, chunk,   k,        d,        lr,            adagrad,
             long_runs, long_count, long_cap, long_min};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d % 4 == 0)
    return k <= kSmallNeg ? launch<4, kSmallNeg>(a, grid, st)
                          : launch<4, kMaxNeg>(a, grid, st);
  return k <= kSmallNeg ? launch<1, kSmallNeg>(a, grid, st)
                        : launch<1, kMaxNeg>(a, grid, st);
}

}  // extern "C"
