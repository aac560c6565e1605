"""BSP consistency: the SyncServer / VectorClock semantics.

Reference: ``src/server.cpp:68-222`` — in ``-sync=true`` mode the server keeps
per-worker vector clocks for Gets and Adds, caches out-of-clock requests, and
drains them when lagging workers catch up, guaranteeing **every worker's i-th
Get sees identical parameters** (``src/server.cpp:61-67``).
``Server_Finish_Train`` sets a finished worker's clock to infinity so
stragglers can't deadlock shutdown (``src/server.cpp:190-213``).

Port notes: with all workers inside one fused device step this guarantee
is free; it matters for the *host-driven* mode where independent worker threads
(or processes) issue Get/Add against the shared device store. The gating rule
distilled from the reference's clock algebra:

* Add from worker w may be **applied** only while w's own Get count is not
  ahead of the global (min) Get count (ref ``ProcessAdd``: cache when
  ``get_local[w] > get_global``) — a fast worker's next-round add would
  otherwise contaminate a slow worker's current-round view.
* Get from worker w may be **served** only while w's own Add count is not
  ahead of the global (min) Add count (ref ``ProcessGet``: cache when
  ``add_local[w] > add_global``), and w has no Add still in flight. The
  first Get in a get-train-add loop is therefore served immediately; both
  get-first and add-first worker loops are live.

Implemented as a condition-variable-guarded pair of clock vectors rather than
message caching (threads can simply block; the reference had to cache because
actors must not block their mailbox loop).

CONTRACT (inherited verbatim from the reference, ``src/server.cpp:61-63``:
"The implementation assumes all the workers will call same number of Add
and/or Get requests"): the identical-views guarantee holds for HOMOGENEOUS
worker loops — every worker issues the same number of Adds between
consecutive Gets (any fixed number, e.g. ``sync_frequency`` adds per pull).
Round isolation then follows: round-(i+1) adds are gated behind every
worker's i-th get, and each get waits for every worker's same add count, so
the i-th view is exactly ``num_workers x adds_per_round x i`` updates.  If
workers issue UNEQUAL add counts per round, the i-th views may differ by
arrival order — exactly as in the reference, which caches by the same
clocks.  Use ``finish_train`` to retire a worker that stops participating.
"""

from __future__ import annotations

import time
from typing import List, Tuple

from multiverso_tpu_torch.telemetry import counter, gauge, histogram
from multiverso_tpu_torch.utils.log import check, log
from multiverso_tpu_torch.utils.locks import make_condition


class VectorClock:
    """Per-worker monotonic counters with infinity masking
    (ref src/server.cpp:81-139). Growable: elastic membership
    (MXNET-MPI, PAPERS.md 1801.03855) adds slots to a LIVE clock group."""

    INF = float("inf")

    def __init__(self, n: int):
        self._clock: List[float] = [0.0] * n

    def tick(self, i: int) -> None:
        if self._clock[i] != self.INF:
            self._clock[i] += 1

    def finish(self, i: int) -> None:
        self._clock[i] = self.INF

    def min(self) -> float:
        active = [c for c in self._clock if c != self.INF]
        return min(active) if active else self.INF

    def value(self, i: int) -> float:
        return self._clock[i]

    def size(self) -> int:
        return len(self._clock)

    def set(self, i: int, value: float) -> None:
        self._clock[i] = value

    def add_slot(self, value: float = 0.0) -> int:
        """Append one worker slot at ``value``; returns its index."""
        self._clock.append(value)
        return len(self._clock) - 1


class SyncCoordinator:
    """One per table in sync mode; gates worker threads per the BSP rule.

    **Elastic membership** (MXNET-MPI, PAPERS.md 1801.03855): workers may
    :meth:`join` and :meth:`leave` a LIVE clock group. A join takes effect
    at the current epoch floor — the newcomer's clocks initialize to the
    minimum of the active clocks, equivalent to having joined at the epoch
    boundary the slowest worker is still in, so no existing gate predicate
    regresses at the instant of join. A graceful leave retires the
    worker's clocks to infinity (the ``finish_train`` algebra) and frees
    the slot for reuse. **Quorum fallback** (``leave_timeout_s > 0``): a
    worker that goes SILENT — SIGKILL-shaped, no leave, its ops just stop
    — would wedge every peer's gate forever under plain BSP; with the
    fallback armed, a gate stalled past the leave-timeout evicts workers
    not seen within the window and the surviving quorum proceeds.
    Workers blocked IN a gate beat their own liveness each wait slice, so
    a healthy waiter is never named as left."""

    def __init__(self, num_workers: int, name: str = "",
                 leave_timeout_s: float = 0.0):
        check(num_workers >= 1, "need at least one worker")
        self.num_workers = num_workers
        self._adds = VectorClock(num_workers)
        self._gets = VectorClock(num_workers)
        # Adds admitted past their gate but not yet committed; a Get from the
        # same worker must order after them (ref ``num_waited_add_`` in
        # src/server.cpp ProcessGet).
        self._inflight_adds = [0] * num_workers
        self._cv = make_condition("core.sync.cv")
        # -- elastic membership state --------------------------------------
        self._leave_timeout_s = max(0.0, float(leave_timeout_s))
        self._active = set(range(num_workers))
        self._free: List[int] = []          # retired slots reusable by joins
        now = time.monotonic()
        self._last_seen = [now] * num_workers
        self.membership_version = 0
        self.quorum_evictions = 0
        # Telemetry: gate wait time (the BSP barrier tax) + per-worker
        # vector-clock lag — how many rounds each worker trails the most
        # advanced worker, so the STRAGGLER reads positive (same polarity
        # as ps_service.staleness.worker_<w>; docs/OBSERVABILITY.md).
        # ``name`` qualifies the metric names so coordinators of different
        # tables don't conflate into one stream, and the add/get clocks
        # get SEPARATE gauges — interleaving both lag series into one
        # stream would let a get-commit overwrite (mask) an add-side
        # straggler between snapshots.
        # Bounded by construction: `name` is a model-DECLARED table (a
        # handful per model, never a runtime value) and worker indices
        # are fixed at init — not the cardinality hazard the
        # unbounded-metric-name lint exists for.
        prefix = f"sync.{name}." if name else "sync."
        self._prefix = prefix
        # graftlint: disable=unbounded-metric-name
        self._h_add_wait = histogram(f"{prefix}gate_wait.add")
        # graftlint: disable=unbounded-metric-name
        self._h_get_wait = histogram(f"{prefix}gate_wait.get")
        # graftlint: disable=unbounded-metric-name
        self._g_add_staleness = [gauge(f"{prefix}staleness.add.worker_{w}")
                                 for w in range(num_workers)]
        # graftlint: disable=unbounded-metric-name
        self._g_get_staleness = [gauge(f"{prefix}staleness.get.worker_{w}")
                                 for w in range(num_workers)]
        # Elastic-membership telemetry: group size + reform count + the
        # quorum-fallback evictions (each one is a masked fault).
        # graftlint: disable=unbounded-metric-name
        self._g_world = gauge(f"{prefix}world")
        self._g_world.set(num_workers)
        # graftlint: disable=unbounded-metric-name
        self._c_evictions = counter(f"{prefix}quorum_evictions")
        # graftlint: disable=unbounded-metric-name
        self._g_version = gauge(f"{prefix}membership_version")

    def _sample_staleness_locked(self, clock: VectorClock,
                                 gauges: List) -> None:
        vals = [clock.value(w) for w in range(self.num_workers)]
        finite = [v for v in vals if v != VectorClock.INF]
        if not finite:
            return      # every worker retired: lag is meaningless
        hi = max(finite)
        for w, g in enumerate(gauges):
            if vals[w] != VectorClock.INF:
                g.set(hi - vals[w])

    # -- elastic wait plumbing ---------------------------------------------
    def _gate_wait_locked(self, worker_id: int, predicate,
                          timeout: float) -> bool:
        """Wait (holding ``self._cv``) until ``predicate`` holds. With the
        quorum fallback armed, the wait runs in bounded slices: each slice
        beats this worker's own liveness (a BLOCKED worker is alive, not
        left) and then evicts any member not seen inside the
        leave-timeout — so a SIGKILL-shaped leave degrades the group to
        the surviving quorum instead of wedging every peer forever."""
        deadline = time.monotonic() + timeout
        while not predicate():
            now = time.monotonic()
            remaining = deadline - now
            if remaining <= 0:
                return False
            self._last_seen[worker_id] = now
            slice_s = remaining
            if self._leave_timeout_s > 0:
                slice_s = min(slice_s, self._leave_timeout_s / 4.0, 1.0)
            self._cv.wait(slice_s)
            if self._leave_timeout_s > 0:
                self._evict_stale_locked(worker_id)
        self._last_seen[worker_id] = time.monotonic()
        return True

    def _evict_stale_locked(self, waiter: int) -> None:
        """Quorum fallback: retire every ACTIVE worker whose last liveness
        beat is older than the leave-timeout. Only ever called from inside
        a stalled gate — a silent worker with no one blocked behind it
        costs nothing and is left alone until it does."""
        now = time.monotonic()
        stale = [w for w in self._active
                 if w != waiter
                 and now - self._last_seen[w] > self._leave_timeout_s]
        for w in stale:
            log.warning("sync: worker %d silent for %.1fs with peers "
                        "gated — degrading to surviving quorum "
                        "(%d workers)", w,
                        now - self._last_seen[w], len(self._active) - 1)
            self._retire_locked(w, free_slot=True)
            self.quorum_evictions += 1
            self._c_evictions.inc()
        if stale:
            self._cv.notify_all()

    def _retire_locked(self, worker_id: int, free_slot: bool) -> None:
        self._adds.finish(worker_id)
        self._gets.finish(worker_id)
        self._inflight_adds[worker_id] = 0
        if worker_id in self._active:
            self._active.discard(worker_id)
            if free_slot:
                self._free.append(worker_id)
            self.membership_version += 1
            self._g_version.set(self.membership_version)
            self._g_world.set(len(self._active))

    # -- gates -------------------------------------------------------------
    # Two-phase: acquire_* blocks until the op is in-clock; commit_* ticks
    # AFTER the op has been dispatched against the store. Ticking early would
    # let a peer pass its gate and read/write a state that doesn't yet
    # include this worker's op (the reference avoids this by construction:
    # the single-threaded server actor both applies and clocks a message).
    def acquire_add(self, worker_id: int, timeout: float = 60.0) -> None:
        t0 = time.perf_counter()
        try:
            with self._cv:
                ok = self._gate_wait_locked(
                    worker_id,
                    lambda: self._gets.min() >= self._gets.value(worker_id)
                    or self._adds.value(worker_id) == VectorClock.INF,
                    timeout)
                check(ok, f"sync add gate timed out (worker {worker_id})")
                self._inflight_adds[worker_id] += 1
        finally:
            # finally: a timed-out wait is exactly the tail this
            # histogram exists to expose — it must not escape recording.
            self._h_add_wait.observe((time.perf_counter() - t0) * 1e3)

    def commit_add(self, worker_id: int) -> None:
        with self._cv:
            self._adds.tick(worker_id)
            self._last_seen[worker_id] = time.monotonic()
            self._inflight_adds[worker_id] -= 1
            self._sample_staleness_locked(self._adds, self._g_add_staleness)
            self._cv.notify_all()

    def abort_add(self, worker_id: int) -> None:
        """Release an admitted add whose application failed — without this,
        a raise between acquire and commit would wedge every future get."""
        with self._cv:
            self._inflight_adds[worker_id] -= 1
            self._cv.notify_all()

    def acquire_get(self, worker_id: int, timeout: float = 60.0) -> None:
        # A get must not race ANY worker's admitted-but-uncommitted add
        # (the reference's single-threaded server applies and clocks each
        # add atomically, so a served get never observes a half-round).
        t0 = time.perf_counter()
        try:
            with self._cv:
                ok = self._gate_wait_locked(
                    worker_id,
                    lambda: (self._adds.min() >= self._adds.value(worker_id)
                             and not any(self._inflight_adds)) or
                    self._gets.value(worker_id) == VectorClock.INF,
                    timeout)
                check(ok, f"sync get gate timed out (worker {worker_id})")
        finally:
            self._h_get_wait.observe((time.perf_counter() - t0) * 1e3)

    def commit_get(self, worker_id: int) -> None:
        with self._cv:
            self._gets.tick(worker_id)
            self._last_seen[worker_id] = time.monotonic()
            self._sample_staleness_locked(self._gets, self._g_get_staleness)
            self._cv.notify_all()

    def finish_train(self, worker_id: int) -> None:
        """``Server_Finish_Train`` analog (ref src/server.cpp:190-213)."""
        with self._cv:
            self._adds.finish(worker_id)
            self._gets.finish(worker_id)
            self._cv.notify_all()

    # -- elastic membership -------------------------------------------------
    def join(self, timeout: float = 60.0) -> int:
        """Admit one worker into the LIVE clock group; returns its id.

        The join drains to the epoch floor: it waits out any in-flight
        (admitted-but-uncommitted) adds so the newcomer can never split a
        half-applied round, then initializes the new slot's clocks to the
        MINIMUM of the active clocks — the round the slowest survivor is
        still in. Every gate predicate compares against that min, so
        nothing regresses at the instant of join; the group has re-formed
        at the new world size the moment this returns."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: not any(self._inflight_adds), timeout)
            check(ok, "elastic join timed out draining in-flight adds")
            add_floor = self._adds.min()
            get_floor = self._gets.min()
            if add_floor == VectorClock.INF:    # group fully retired:
                add_floor, get_floor = 0.0, 0.0  # newcomer restarts it
            else:
                # Taking each vector's min INDEPENDENTLY can synthesize a
                # mid-round hybrid no worker occupies (add clock from a
                # worker already past its round's add, get clock from one
                # still before its get). A joiner initialized there and
                # entering at the top of a homogeneous loop issues one
                # extra add and the gates deadlock: the joiner waits in
                # its get gate for adds the peers can't commit because
                # their add gates wait on the joiner's get (the elastic
                # membership fuzz caught this). Join at the last round the
                # slowest worker fully COMPLETED — both clocks at the
                # common floor, a state every loop actually passes
                # through — and the group stays live in either phase
                # order (add-first or get-first).
                add_floor = get_floor = min(add_floor, get_floor)
            if self._free:
                w = self._free.pop()
                self._adds.set(w, add_floor)
                self._gets.set(w, get_floor)
                self._inflight_adds[w] = 0
            else:
                w = self._adds.add_slot(add_floor)
                self._gets.add_slot(get_floor)
                self._inflight_adds.append(0)
                self._last_seen.append(0.0)
                self.num_workers = self._adds.size()
                # Bounded family shape (worker_<w>): the population is
                # the slot count, which only grows when the PEAK world
                # size does — rejoins reuse freed slots.
                self._g_add_staleness.append(
                    # graftlint: disable=unbounded-metric-name
                    gauge(f"{self._prefix}staleness.add.worker_{w}"))
                self._g_get_staleness.append(
                    # graftlint: disable=unbounded-metric-name
                    gauge(f"{self._prefix}staleness.get.worker_{w}"))
            self._last_seen[w] = time.monotonic()
            self._active.add(w)
            self.membership_version += 1
            self._g_version.set(self.membership_version)
            self._g_world.set(len(self._active))
            self._cv.notify_all()
            return w

    def leave(self, worker_id: int) -> None:
        """Graceful leave: retire the worker's clocks (the finish_train
        algebra — peers' gates stop waiting on it immediately) and free
        its slot for a later :meth:`join` to reuse."""
        with self._cv:
            self._retire_locked(worker_id, free_slot=True)
            self._cv.notify_all()

    def active_workers(self) -> List[int]:
        with self._cv:
            return sorted(self._active)

    def status(self) -> dict:
        """Membership snapshot for drills and rollups."""
        with self._cv:
            return {"world": len(self._active),
                    "slots": self._adds.size(),
                    "active": sorted(self._active),
                    "version": self.membership_version,
                    "quorum_evictions": self.quorum_evictions,
                    "leave_timeout_s": self._leave_timeout_s}

    def lag(self, worker_id: int) -> float:
        """This worker's measured add-clock lag behind the most advanced
        ACTIVE worker — the SSP staleness the DC-ASGD compensation term
        exists to correct (``-staleness_adaptive`` feeds it into
        ``AddOption.staleness``). Retired workers (and fully-retired
        tables) read 0: there is nothing left to be stale against."""
        with self._cv:
            vals = [self._adds.value(w) for w in range(self.num_workers)]
        mine = vals[worker_id]
        finite = [v for v in vals if v != VectorClock.INF]
        if not finite or mine == VectorClock.INF:
            return 0.0
        return float(max(finite) - mine)

    def clock(self) -> Tuple[float, float]:
        """Snapshot version for read-only consumers: the globally committed
        ``(add_min, get_min)`` clocks. The serving plane stamps replies
        with the add clock — two lookups stamped with the same value were
        served from views containing the same committed update rounds
        (the SyncServer identical-i-th-view guarantee restated as a
        version number). Retired (INF) workers are masked out, so the
        stamp stays finite until every worker finishes."""
        with self._cv:
            return (self._adds.min(), self._gets.min())
