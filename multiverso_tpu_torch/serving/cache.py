"""Hot-row LRU cache with bounded staleness for the lookup runners.

Port of ``multiverso_tpu/serving/cache.py``: rows stay host numpy, as in
the JAX package, so a hit never touches the card.

Serving traffic is zipfian: a handful of hot embedding rows (head
vocabulary words, trending items) absorb most lookups. Those rows do not
need a device dispatch per request — the previous batch already fetched
them. This cache sits IN FRONT of :class:`SparseLookupRunner`: a request
whose every key is cached fresh is answered straight from host memory at
admission time (no queue, no batch, no device), everything else takes the
normal batched path and repopulates the cache on the way out.

Freshness is defined by the BSP clock stamp the serving plane already
carries (``SyncCoordinator.clock()`` — the same version number stamped
into every ``Serve_Reply``): a row cached at clock ``c`` is served while
``now_clock - c <= staleness``. With ``staleness=0`` under BSP semantics
(writes commit before the clock advances) a hit is bitwise-equal to a
direct ``table.get_rows`` at the same clock — the parity the tests
assert. A training write that advances the clock therefore invalidates
every older entry *by arithmetic*, with no write-path hook into the
trainer: the clock IS the invalidation broadcast. Checkpoint replicas
(no clock) call :meth:`invalidate` on hot-swap instead.

Telemetry: ``serve.cache.hit`` / ``serve.cache.miss`` / ``serve.cache.stale``
counters + ``serve.cache.rows`` gauge.
Hit-path keys feed the ``serve.lookup`` traffic sketch (misses feed it at
runner dispatch), so the hot-key view covers the FULL key stream; the
cache also registers the sketch hub's **headroom advisor** — each
sketch flush publishes the hit rate the stream's frequency CDF says
this capacity could achieve next to the measured one
(``serve.cache.advisor.*`` gauges).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.telemetry import counter, gauge, histogram
from multiverso_tpu_torch.telemetry.sketch import get_sketch_hub, record_keys
from multiverso_tpu_torch.utils.locks import make_lock


class StampedRows(np.ndarray):
    """A cache-hit result matrix carrying the BSP clock stamp of the
    OLDEST cached row it was assembled from. The serving service stamps
    the reply meta with THIS value instead of ``runner.clock()`` — with
    ``-serve_cache_staleness>0`` the runner's last-batch clock can be
    newer than the cached bytes, and a reply must never claim a version
    newer than what it serves."""

    clock_stamp: float

    @classmethod
    def wrap(cls, rows: np.ndarray, stamp: float) -> "StampedRows":
        out = rows.view(cls)
        out.clock_stamp = float(stamp)
        return out


class HotRowCache:
    """Bounded LRU of ``row id -> (clock stamp, value row)``.

    ``capacity`` bounds resident rows (LRU eviction); ``staleness`` is
    the maximum clock-tick age a hit may serve. All-or-nothing at the
    request level: a request with ANY cold/stale key takes the device
    path whole, so a reply never mixes cache generations."""

    def __init__(self, capacity: int, staleness: int = 0):
        self.capacity = max(1, int(capacity))
        self.staleness = max(0, int(staleness))
        #: Observed bytes per cached row (value bytes + stamp/key
        #: overhead), learned from the first insert — what converts the
        #: autosizer's -serve_cache_mem_budget into a row bound.
        self.row_nbytes = 0
        self._lock = make_lock("serve.cache")
        self._rows: "collections.OrderedDict[int, Tuple[float, np.ndarray]]" \
            = collections.OrderedDict()
        self._c_hit = counter("serve.cache.hit")
        self._c_miss = counter("serve.cache.miss")
        self._c_stale = counter("serve.cache.stale")
        self._g_rows = gauge("serve.cache.rows")
        self._h_probe = histogram("serve.latency.cache_probe")
        # Headroom advisor feed (telemetry/sketch.py): each flush reads
        # this cache's counters + capacity and publishes predicted-vs-
        # measured hit rates. Last-registered cache wins the surface —
        # the deployed shape is one lookup cache per process.
        get_sketch_hub().register_advisor(
            "serve.lookup",
            lambda: {"capacity": self.capacity,
                     "hits": self._c_hit.value,
                     "misses": self._c_miss.value,
                     "stale": self._c_stale.value})

    def _fresh(self, stamp: float, now_clock: float) -> bool:
        # No clock (static table / frozen replica): entries live until
        # an explicit invalidate() — the hot-swap path calls it.
        if now_clock < 0:
            return True
        return (now_clock - stamp) <= self.staleness

    def get_rows(self, keys: np.ndarray,
                 now_clock: float) -> Optional["StampedRows"]:
        """The full value matrix for ``keys`` iff EVERY key is cached
        within the staleness bound; None otherwise (counts one miss or
        stale per request, one hit per fully-served request). The result
        is a :class:`StampedRows` whose ``clock_stamp`` is the oldest
        contributing row's stamp — what the reply meta must claim."""
        # Phase-ledger feed: the probe runs at ADMISSION on the submit
        # thread, so its cost lands in the admission phase — the
        # unconditional histogram makes it visible to the roofline
        # classifier even for unsampled requests.
        t0 = time.monotonic()
        out = []
        stamp = now_clock
        with self._lock:
            for k in keys:
                entry = self._rows.get(int(k))
                if entry is None:
                    self._c_miss.inc()
                    self._h_probe.observe((time.monotonic() - t0) * 1e3)
                    return None
                if not self._fresh(entry[0], now_clock):
                    self._c_stale.inc()
                    self._h_probe.observe((time.monotonic() - t0) * 1e3)
                    return None
                stamp = min(stamp, entry[0]) if out else entry[0]
                out.append(entry[1])
            for k in keys:                    # LRU touch only on full hits
                self._rows.move_to_end(int(k))
        self._c_hit.inc()
        self._h_probe.observe((time.monotonic() - t0) * 1e3)
        if not out:
            return None                       # empty request: device path
        rows = np.stack(out)
        # Hit-path half of the key stream (the miss path records at
        # runner dispatch — together the sketch sees EVERY served key).
        record_keys("serve.lookup", np.asarray(keys).reshape(-1).copy(),
                    rows.nbytes)
        return StampedRows.wrap(rows, stamp)

    def put_rows(self, keys: np.ndarray, rows: np.ndarray,
                 clock: float) -> None:
        """Stamp + insert the rows a device batch just fetched. Rows are
        copied (the batch result matrix is sliced per-request afterwards;
        the cache must own stable bytes) — OUTSIDE the lock, so the
        admission fast path's ``get_rows`` never waits on a batch-sized
        memcpy."""
        stamped = [(int(k), (float(clock), np.array(row, copy=True)))
                   for k, row in zip(keys, rows)]
        if stamped and not self.row_nbytes:
            # ~48 bytes of per-entry bookkeeping (dict slot + stamp).
            self.row_nbytes = int(stamped[0][1][1].nbytes) + 48
        with self._lock:
            for k, entry in stamped:
                self._rows[k] = entry
                self._rows.move_to_end(k)
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
            self._g_rows.set(len(self._rows))

    def invalidate(self) -> None:
        """Drop everything — the checkpoint hot-swap hook for clockless
        (frozen replica) tables."""
        with self._lock:
            self._rows.clear()
            self._g_rows.set(0)

    def resize(self, capacity: int) -> None:
        """Change the row bound in place (the autosizer's actuation);
        a shrink evicts LRU-first immediately so the memory comes back
        now, not at the next insert."""
        with self._lock:
            self.capacity = max(1, int(capacity))
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
            self._g_rows.set(len(self._rows))

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


class CacheAutosizer:
    """Advisor-driven ``-serve_cache_rows`` auto-sizing within a byte
    budget.

    Rides the sketch hub's headroom-advisor tick
    (:meth:`~multiverso_tpu_torch.telemetry.sketch.SketchHub.register_autosizer`):
    each advice window it applies the supervisor's hysteresis/cooldown
    discipline to two signals the advisor already computes —

    * **grow** when ``predicted_hit_rate_2x - predicted_hit_rate >=
      grow_gain`` for ``windows`` consecutive ticks: the stream's
      frequency CDF says doubling capacity buys real hit rate. Doubles,
      clamped to ``mem_budget // row_nbytes`` rows.
    * **shrink** when occupancy has stayed under half of capacity for
      ``windows`` ticks (the LRU never fills the grant — halving is
      free), or immediately when the budget itself says so (row bytes
      learned bigger than assumed). Halves, floored at ``min_rows``.

    Metrics: ``serve.cache.autosize.capacity`` / ``.grows`` /
    ``.shrinks`` / ``.budget_rows``."""

    def __init__(self, cache: HotRowCache, mem_budget: int,
                 surface: str = "serve.lookup", grow_gain: float = 0.02,
                 windows: int = 3, cooldown_s: float = 5.0,
                 min_rows: int = 64):
        self.cache = cache
        self.mem_budget = int(mem_budget)
        self.grow_gain = float(grow_gain)
        self.windows = max(1, int(windows))
        self.cooldown_s = float(cooldown_s)
        self.min_rows = max(1, int(min_rows))
        self._grow_streak = 0
        self._shrink_streak = 0
        self._last_action = -float("inf")
        self._g_capacity = gauge("serve.cache.autosize.capacity")
        self._g_budget_rows = gauge("serve.cache.autosize.budget_rows")
        self._c_grows = counter("serve.cache.autosize.grows")
        self._c_shrinks = counter("serve.cache.autosize.shrinks")
        self._g_capacity.set(cache.capacity)
        get_sketch_hub().register_autosizer(surface, self.on_advice)

    def budget_rows(self) -> Optional[int]:
        """The budget as a row bound; None until a row's bytes are
        observed (no guessing — an unsized cache never resizes)."""
        if self.cache.row_nbytes <= 0:
            return None
        return max(self.min_rows, self.mem_budget // self.cache.row_nbytes)

    def on_advice(self, advice: Dict,
                  now: Optional[float] = None) -> Optional[str]:
        """One hysteresis step per advisor tick; returns the action
        taken (``"grow"``/``"shrink"``) or None. Deterministic given
        ``now`` — the tier-1 tests drive it with a fake clock."""
        now = time.monotonic() if now is None else now
        bound = self.budget_rows()
        if bound is None:
            return None
        self._g_budget_rows.set(bound)
        capacity = self.cache.capacity
        if capacity > bound:
            # The budget is a hard ceiling, not advice: clamp now.
            return self._apply(bound, now, grew=False)
        gap = float(advice.get("predicted_hit_rate_2x", 0.0)) \
            - float(advice.get("predicted_hit_rate", 0.0))
        if gap >= self.grow_gain and capacity < bound:
            self._grow_streak += 1
            self._shrink_streak = 0
            if self._grow_streak >= self.windows \
                    and now - self._last_action >= self.cooldown_s:
                return self._apply(min(capacity * 2, bound), now,
                                   grew=True)
            return None
        self._grow_streak = 0
        if len(self.cache) <= capacity // 2 \
                and capacity > self.min_rows:
            self._shrink_streak += 1
            if self._shrink_streak >= self.windows \
                    and now - self._last_action >= self.cooldown_s:
                return self._apply(max(capacity // 2, self.min_rows),
                                   now, grew=False)
        else:
            self._shrink_streak = 0
        return None

    def _apply(self, capacity: int, now: float, grew: bool
               ) -> Optional[str]:
        if capacity == self.cache.capacity:
            return None
        self.cache.resize(capacity)
        self._grow_streak = self._shrink_streak = 0
        self._last_action = now
        self._g_capacity.set(capacity)
        (self._c_grows if grew else self._c_shrinks).inc()
        return "grow" if grew else "shrink"


def cache_from_flags() -> Optional[HotRowCache]:
    """Build the cache the ``-serve_cache_rows`` / ``-serve_cache_staleness``
    flags describe (None when disabled — the default: live-table serving
    opts into staleness, it never inherits it silently). A positive
    ``-serve_cache_mem_budget`` arms the :class:`CacheAutosizer`, kept
    alive as ``cache.autosizer``."""
    from multiverso_tpu_torch.utils.configure import get_flag
    try:
        capacity = int(get_flag("serve_cache_rows"))
        staleness = int(get_flag("serve_cache_staleness"))
    except Exception:  # noqa: BLE001 - flags not parsed (bare library use)
        return None
    if capacity <= 0:
        return None
    cache = HotRowCache(capacity, staleness)
    try:
        budget = int(get_flag("serve_cache_mem_budget"))
    except Exception:  # noqa: BLE001 - older flag sets lack the budget
        budget = 0
    if budget > 0:
        cache.autosizer = CacheAutosizer(cache, budget)
    return cache
