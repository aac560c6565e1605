// Native host runtime of multiverso_tpu_torch (the port's own copy of
// multiverso_tpu/runtime/src/mv_runtime.cpp).
//
// Host equivalents of the reference's C++ core primitives:
//   * MtQueue  (include/multiverso/util/mt_queue.h:18-145) -> mvq_*  — a
//     blocking MPMC queue with Exit() poison, used for actor-style mailboxes.
//   * Waiter   (include/multiverso/util/waiter.h:9-33)     -> mvw_*  — the
//     counted per-request completion latch.
//   * SmartAllocator (src/util/allocator.cpp:32-131)       -> mva_*  — a
//     size-pooled aligned allocator with free lists.
//   * the server updater hot loop (src/updater/updater.cpp:19-29, OpenMP
//     "data[i] += delta[i]")                               -> mvbuf_* — a
//     striped-lock delta staging buffer: many worker threads accumulate
//     gradients in parallel OUTSIDE the GIL; the drain hands one merged
//     delta to a single update of the card table. This is the async-ASGD
//     host aggregation path: it turns N small host->device launches into
//     one.
//
// Exposed as a flat C ABI consumed via ctypes (runtime/ffi.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// MtQueue: blocking MPMC queue of u64 handles with exit poison.
// ---------------------------------------------------------------------------
struct MvQueue {
  std::deque<uint64_t> items;
  std::mutex mu;
  std::condition_variable cv;
  bool exited = false;
};

// ---------------------------------------------------------------------------
// Waiter: counted latch.
// ---------------------------------------------------------------------------
struct MvWaiter {
  int count;
  std::mutex mu;
  std::condition_variable cv;
};

// ---------------------------------------------------------------------------
// Size-pooled aligned allocator.
// ---------------------------------------------------------------------------
struct MvAllocator {
  size_t alignment;
  std::mutex mu;
  std::unordered_map<size_t, std::vector<void*>> pools;
  std::atomic<uint64_t> hits{0}, misses{0};

  explicit MvAllocator(size_t align) : alignment(align) {}

  void* alloc(size_t size) {
    {
      std::lock_guard<std::mutex> lk(mu);
      auto it = pools.find(size);
      if (it != pools.end() && !it->second.empty()) {
        void* p = it->second.back();
        it->second.pop_back();
        hits.fetch_add(1, std::memory_order_relaxed);
        return p;
      }
    }
    misses.fetch_add(1, std::memory_order_relaxed);
    void* p = nullptr;
    if (posix_memalign(&p, alignment, size) != 0) return nullptr;
    return p;
  }

  void release(void* p, size_t size) {
    std::lock_guard<std::mutex> lk(mu);
    pools[size].push_back(p);
  }

  ~MvAllocator() {
    for (auto& kv : pools)
      for (void* p : kv.second) free(p);
  }
};

// ---------------------------------------------------------------------------
// Striped-lock delta staging buffer (float32).
// ---------------------------------------------------------------------------
constexpr int kStripes = 64;

struct MvBuffer {
  std::vector<float> data;          // flat [rows * cols] or [n]
  int64_t rows, cols;               // cols==1 for 1-D
  int64_t rows_per_stripe;          // ONE row->stripe mapping for all ops
  std::mutex stripes[kStripes];
  std::atomic<int64_t> pending{0};  // adds staged since last drain
  std::vector<uint8_t> row_dirty;   // per-row touched flag (sparse drain)

  MvBuffer(int64_t r, int64_t c)
      : data(static_cast<size_t>(r * c), 0.0f), rows(r), cols(c),
        rows_per_stripe((r + kStripes - 1) / kStripes),
        row_dirty(static_cast<size_t>(r), 0) {}

  // Range-based mapping shared by dense (whole stripe ranges) and row
  // (single row) paths — a modulo mapping here would lock a DIFFERENT
  // stripe than the dense path for the same row (caught by TSAN).
  inline std::mutex& stripe_for_row(int64_t row) {
    return stripes[row / rows_per_stripe];
  }
};

inline void axpy(float* dst, const float* src, int64_t n, float alpha) {
  // The card owns the table's math; this is the host-side merge loop.
  // Compiled with -O3 (no -ffast-math) it vectorizes on the host CPU.
  for (int64_t i = 0; i < n; ++i) dst[i] += alpha * src[i];
}

}  // namespace

extern "C" {

// -- queue ------------------------------------------------------------------
void* mvq_create() { return new MvQueue(); }

void mvq_destroy(void* q) { delete static_cast<MvQueue*>(q); }

void mvq_push(void* qp, uint64_t item) {
  auto* q = static_cast<MvQueue*>(qp);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->items.push_back(item);
  }
  q->cv.notify_one();
}

// Returns 1 on success, 0 on timeout/exit. timeout_ms < 0 blocks forever.
int mvq_pop(void* qp, uint64_t* out, long timeout_ms) {
  auto* q = static_cast<MvQueue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return !q->items.empty() || q->exited; };
  if (timeout_ms < 0) {
    q->cv.wait(lk, ready);
  } else if (!q->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return 0;
  }
  if (q->items.empty()) return 0;  // exited
  *out = q->items.front();
  q->items.pop_front();
  return 1;
}

int64_t mvq_size(void* qp) {
  auto* q = static_cast<MvQueue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int64_t>(q->items.size());
}

void mvq_exit(void* qp) {
  auto* q = static_cast<MvQueue*>(qp);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->exited = true;
  }
  q->cv.notify_all();
}

// -- waiter -----------------------------------------------------------------
void* mvw_create(int count) {
  auto* w = new MvWaiter();
  w->count = count;
  return w;
}

void mvw_destroy(void* wp) { delete static_cast<MvWaiter*>(wp); }

// Returns 1 when count reached zero, 0 on timeout (timeout_ms<0 = forever).
int mvw_wait(void* wp, long timeout_ms) {
  auto* w = static_cast<MvWaiter*>(wp);
  std::unique_lock<std::mutex> lk(w->mu);
  auto done = [w] { return w->count <= 0; };
  if (timeout_ms < 0) {
    w->cv.wait(lk, done);
    return 1;
  }
  return w->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), done)
             ? 1 : 0;
}

void mvw_notify(void* wp) {
  auto* w = static_cast<MvWaiter*>(wp);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    --w->count;
  }
  w->cv.notify_all();
}

void mvw_reset(void* wp, int count) {
  auto* w = static_cast<MvWaiter*>(wp);
  std::lock_guard<std::mutex> lk(w->mu);
  w->count = count;
}

// -- allocator --------------------------------------------------------------
void* mva_create(long alignment) {
  return new MvAllocator(static_cast<size_t>(alignment));
}

void mva_destroy(void* ap) { delete static_cast<MvAllocator*>(ap); }

void* mva_alloc(void* ap, long size) {
  return static_cast<MvAllocator*>(ap)->alloc(static_cast<size_t>(size));
}

void mva_free(void* ap, void* p, long size) {
  static_cast<MvAllocator*>(ap)->release(p, static_cast<size_t>(size));
}

uint64_t mva_pool_hits(void* ap) {
  return static_cast<MvAllocator*>(ap)->hits.load();
}

// -- delta staging buffer ---------------------------------------------------
void* mvbuf_create(int64_t rows, int64_t cols) {
  return new MvBuffer(rows, cols);
}

void mvbuf_destroy(void* bp) { delete static_cast<MvBuffer*>(bp); }

// Dense accumulate: buf += alpha * delta  (whole table). Striped so
// concurrent threads make progress on disjoint row ranges.
void mvbuf_add_dense(void* bp, const float* delta, float alpha) {
  auto* b = static_cast<MvBuffer*>(bp);
  const int64_t rows_per_stripe = b->rows_per_stripe;
  for (int s = 0; s < kStripes; ++s) {
    const int64_t r0 = s * rows_per_stripe;
    if (r0 >= b->rows) break;
    const int64_t r1 = std::min(b->rows, r0 + rows_per_stripe);
    std::lock_guard<std::mutex> lk(b->stripes[s]);
    axpy(b->data.data() + r0 * b->cols, delta + r0 * b->cols,
         (r1 - r0) * b->cols, alpha);
    memset(b->row_dirty.data() + r0, 1, static_cast<size_t>(r1 - r0));
  }
  b->pending.fetch_add(1, std::memory_order_relaxed);
}

// Row scatter-accumulate: buf[row_ids[i]] += alpha * deltas[i].
void mvbuf_add_rows(void* bp, const int32_t* row_ids, int64_t n,
                    const float* deltas, float alpha) {
  auto* b = static_cast<MvBuffer*>(bp);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = row_ids[i];
    if (r < 0 || r >= b->rows) continue;
    std::lock_guard<std::mutex> lk(b->stripe_for_row(r));
    axpy(b->data.data() + r * b->cols, deltas + i * b->cols, b->cols, alpha);
    b->row_dirty[static_cast<size_t>(r)] = 1;
  }
  b->pending.fetch_add(1, std::memory_order_relaxed);
}

// Drain the whole buffer into out (and zero it). Returns number of staged
// adds merged since the previous drain.
int64_t mvbuf_drain_dense(void* bp, float* out) {
  auto* b = static_cast<MvBuffer*>(bp);
  for (int s = 0; s < kStripes; ++s) b->stripes[s].lock();
  const size_t bytes = b->data.size() * sizeof(float);
  memcpy(out, b->data.data(), bytes);
  memset(b->data.data(), 0, bytes);
  memset(b->row_dirty.data(), 0, b->row_dirty.size());
  const int64_t n = b->pending.exchange(0, std::memory_order_relaxed);
  for (int s = kStripes - 1; s >= 0; --s) b->stripes[s].unlock();
  return n;
}

// Sparse drain: write touched row ids into row_ids_out (capacity max_rows),
// their merged deltas into rows_out, zero those rows. Returns row count, or
// -1 if more than max_rows rows are dirty (caller falls back to dense drain).
int64_t mvbuf_drain_rows(void* bp, int32_t* row_ids_out, float* rows_out,
                         int64_t max_rows) {
  auto* b = static_cast<MvBuffer*>(bp);
  for (int s = 0; s < kStripes; ++s) b->stripes[s].lock();
  int64_t count = 0;
  for (int64_t r = 0; r < b->rows; ++r) {
    if (!b->row_dirty[static_cast<size_t>(r)]) continue;
    if (count == max_rows) {
      for (int s = kStripes - 1; s >= 0; --s) b->stripes[s].unlock();
      return -1;
    }
    row_ids_out[count] = static_cast<int32_t>(r);
    memcpy(rows_out + count * b->cols, b->data.data() + r * b->cols,
           static_cast<size_t>(b->cols) * sizeof(float));
    memset(b->data.data() + r * b->cols, 0,
           static_cast<size_t>(b->cols) * sizeof(float));
    b->row_dirty[static_cast<size_t>(r)] = 0;
    ++count;
  }
  b->pending.exchange(0, std::memory_order_relaxed);
  for (int s = kStripes - 1; s >= 0; --s) b->stripes[s].unlock();
  return count;
}

int64_t mvbuf_pending(void* bp) {
  return static_cast<MvBuffer*>(bp)->pending.load(std::memory_order_relaxed);
}

}  // extern "C"
