// Runs of equal sorted ids, found by a warp over a tile of id slots.
// Shared by the sorted scatters (rows.cu: B2, B4) and the stateful row
// updates (stateful_rows.cu: B3 and the combine's fold).
//
// A warp owns a tile of 32 consecutive sorted id slots. Lane l loads ids
// t0 + l and t0 + 32 + l, coalesced, with the id before the tile, all at
// once; __shfl_up_sync and __ballot_sync mark where ids change, and the
// warp owns the runs of equal ids that START in its tile (a run has
// exactly one owner, so no float atomics). The end of a run that reaches
// past the 64 slots read is found by a 32-ary search over the sorted ids
// (each lane probes one slot, one ballot a step: log32 of the run's length
// steps, where a walk of 32 ids a step took one dependent load per 32
// lanes of the run). The runs go to a small per-warp list in shared
// memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;   // sorted id slots a warp owns: one per lane
constexpr unsigned kFull = 0xffffffffu;

// The runs that start in one tile, in order (per warp, in shared memory).
template <typename IdT> struct Runs {
  IdT id[kTile];
  int64_t end[kTile];  // one past the run's last slot
  int start[kTile];    // the run's first slot, from the tile's start
};

// The first slot at or after `lo` whose id is not r (or n), given that
// ids[lo - 1] == r and the ids are sorted: a 32-ary search, lane l probing
// lo + l * step; the answer lies after the last probe still inside the run
// and at or before the first one past it. Warp-uniform.
template <typename IdT>
__device__ int64_t run_end(const IdT* __restrict__ ids, int64_t n,
                           int64_t lo, IdT r, int lane) {
  int64_t hi = n;
  while (lo < hi) {
    const int64_t step = (hi - lo + kTile - 1) / kTile;
    const int64_t p = lo + lane * step;
    const unsigned past = __ballot_sync(kFull, p >= hi || ids[p] != r);
    if (past == 0) {
      lo += (kTile - 1) * step + 1;
      continue;
    }
    const int f = __ffs(past) - 1;
    if (f == 0) break;
    const int64_t top = lo + f * step;
    lo += (f - 1) * step + 1;
    hi = top < hi ? top : hi;
  }
  return lo;
}

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
    const int64_t e = run_end(ids, n, t0 + 2 * kTile, r, lane);
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

}  // namespace
