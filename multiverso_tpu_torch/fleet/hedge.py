"""Client-side hedged requests: the p99-straggler counterweapon.

Port of ``multiverso_tpu/fleet/hedge.py``: the same delay and budget
arithmetic. A single serving replica's tail is the problem: one slow
batch (GC pause, checkpoint swap, a cold executable) convoys everything
queued behind it. The fleet fix (Dean &
Barroso, "The Tail at Scale") is to send a SECOND copy of a slow request
to a DIFFERENT replica once the first has been outstanding longer than an
adaptive threshold, take whichever reply lands first, and discard the
loser. Fired at ~p95 of recent latency, hedges add ~5% extra load and cut
the tail by the difference between one replica's p99 and two independent
draws — the classic trade.

Pieces:

* :class:`HedgeScheduler` — ONE daemon timer thread + heap for every
  pending hedge in the process (never a thread per request; cancels are
  O(1) mark-dead).
* :class:`AdaptiveDelay`   — windowed p95 tracker; the hedge delay
  follows measured latency instead of a hand-tuned constant.
* :class:`HedgedCall`      — exactly-once completion over an ordered list
  of attempt launchers: first result wins, a losing reply is discarded
  (counted, never delivered), a failed attempt triggers immediate
  failover to the next candidate without waiting for the timer.

The wire protocol has no server-side cancel: a "cancelled" loser runs to
completion on its replica and its reply is dropped at the client
(``fleet.hedge.wasted``). That is the standard hedging cost model — the
point is bounding tail latency, not total work.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, List, Optional

from multiverso_tpu_torch.telemetry import counter
from multiverso_tpu_torch.utils.log import check, log


class _Handle:
    """Cancellation token for one scheduled callback."""

    __slots__ = ("_dead",)

    def __init__(self):
        self._dead = False

    def cancel(self) -> None:
        self._dead = True


class HedgeScheduler:
    """Single-thread timer wheel: ``call_later(delay_s, fn)``.

    Callbacks run on the scheduler thread and must be cheap (launch an
    async attempt, set an event). One instance per process is plenty —
    module-level :func:`default_scheduler` hands it out lazily."""

    def __init__(self):
        self._cv = threading.Condition()
        self._heap: List = []
        self._seq = itertools.count()
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-hedge", daemon=True)
        self._thread.start()

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> _Handle:
        import time
        handle = _Handle()
        fire_at = time.monotonic() + max(0.0, delay_s)
        with self._cv:
            check(self._running, "hedge scheduler is closed")
            wake = not self._heap or fire_at < self._heap[0][0]
            heapq.heappush(self._heap, (fire_at, next(self._seq), fn,
                                        handle))
            if wake:
                # Only rouse the timer thread when this entry moves the
                # next deadline EARLIER — at request rate, a notify per
                # call_later is two context switches per request for
                # nothing (the loop's bounded wait re-checks anyway).
                self._cv.notify()
        return handle

    def _loop(self) -> None:
        import time
        while True:
            with self._cv:
                while self._running and not self._heap:
                    # timer-wheel idle wait; the hedge a request DOES
                    # ride is the fleet.attempt(hedge=1) span
                    # graftlint: disable=unattributed-wait
                    self._cv.wait(0.5)
                if not self._running:
                    return
                fire_at = self._heap[0][0]
                now = time.monotonic()
                if now < fire_at:
                    # armed-timer countdown, not request residency
                    # graftlint: disable=unattributed-wait
                    self._cv.wait(min(fire_at - now, 0.5))
                    continue
                _, _, fn, handle = heapq.heappop(self._heap)
            if handle._dead:
                continue
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - one bad hedge callback
                log.error("hedge scheduler: callback failed: %s", e)  # must
                # not stop every other pending hedge in the process

    def close(self) -> None:
        with self._cv:
            self._running = False
            self._heap.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5)


_DEFAULT: Optional[HedgeScheduler] = None
_DEFAULT_LOCK = threading.Lock()


def default_scheduler() -> HedgeScheduler:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None or not _DEFAULT._running:
            _DEFAULT = HedgeScheduler()
        return _DEFAULT


class AdaptiveDelay:
    """Hedge-delay tracker: ``delay_ms() ~= 1.25 * p95(recent latencies)``
    clamped to ``[floor_ms, ceil_ms]``. Until ``min_samples`` latencies
    arrive it returns ``initial_ms`` — hedging on no data would either
    never fire (delay too long) or double every request (too short).

    The p95 is recomputed every 16 observations, not per query — this
    sits on the per-request hot path and sorting the window every call
    measurably taxed client throughput."""

    _RECOMPUTE_EVERY = 16

    def __init__(self, window: int = 256, floor_ms: float = 2.0,
                 ceil_ms: float = 250.0, initial_ms: float = 25.0,
                 min_samples: int = 20):
        self._lock = threading.Lock()
        self._window = int(window)
        self._lat: List[float] = []
        self._idx = 0
        self._since_compute = 0
        self._cached: Optional[float] = None
        self.floor_ms = float(floor_ms)
        self.ceil_ms = float(ceil_ms)
        self.initial_ms = float(initial_ms)
        self.min_samples = int(min_samples)

    def observe(self, latency_ms: float) -> None:
        with self._lock:
            if len(self._lat) < self._window:
                self._lat.append(float(latency_ms))
            else:
                self._lat[self._idx] = float(latency_ms)
                self._idx = (self._idx + 1) % self._window
            self._since_compute += 1
            if self._cached is None or \
                    self._since_compute >= self._RECOMPUTE_EVERY:
                self._since_compute = 0
                if len(self._lat) >= self.min_samples:
                    lat = sorted(self._lat)
                    p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))]
                    self._cached = min(max(1.25 * p95, self.floor_ms),
                                       self.ceil_ms)

    def delay_ms(self) -> float:
        cached = self._cached      # atomic read: float or None
        return self.initial_ms if cached is None else cached


class HedgeBudget:
    """Token bucket bounding hedges to a fraction of request rate.

    Without a budget, hedging is unstable under saturation: latency
    crosses the hedge delay, every request doubles, latency rises
    further — a collapse. Dean & Barroso's answer is
    to cap hedge load at a few percent of requests: each primary request
    earns ``ratio`` tokens, a hedge spends one, and when the bucket is
    dry the hedge simply doesn't fire (``fleet.hedge.suppressed``).
    Failure-triggered failover is NOT budgeted — a dead replica must
    always fail over."""

    def __init__(self, ratio: float = 0.1, burst: float = 8.0):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._lock = threading.Lock()

    def on_request(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class _HedgeMetrics:
    """Shared counter handles — resolved from the registry ONCE, not per
    request (five registry lookups per call showed up in bench CPU)."""

    __slots__ = ("fired", "won", "wasted", "failover", "discarded",
                 "suppressed")
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.fired = counter("fleet.hedge.fired")
        self.won = counter("fleet.hedge.won")
        self.wasted = counter("fleet.hedge.wasted")
        self.failover = counter("fleet.failover")
        self.discarded = counter("fleet.hedge.discarded")
        self.suppressed = counter("fleet.hedge.suppressed")

    @classmethod
    def get(cls) -> "_HedgeMetrics":
        inst = cls._instance
        if inst is None:
            with cls._instance_lock:
                inst = cls._instance
                if inst is None:
                    cls._instance = inst = cls()
        return inst


class HedgedCall:
    """Exactly-once completion over ordered attempt launchers.

    ``attempts`` is a list of callables; each, when invoked with a
    ``deliver(result)`` function, starts one asynchronous attempt and
    arranges for ``deliver`` to be called exactly once with either a
    result value or an exception instance. ``on_done`` receives the FIRST
    successful result (or the final exception once every attempt has
    failed) and is guaranteed to run exactly once; late replies from
    losing attempts are discarded and counted, never delivered.

    A launcher that RAISES synchronously (dead replica detected at
    connect) counts as an immediately-failed attempt and triggers
    failover to the next candidate without waiting for the hedge timer.
    """

    def __init__(self, attempts: List[Callable], on_done: Callable,
                 delay_ms: float, scheduler: Optional[HedgeScheduler] = None,
                 hedge: bool = True,
                 allow_hedge: Optional[Callable[[], bool]] = None,
                 on_settled: Optional[Callable[[int, int], None]] = None):
        check(len(attempts) >= 1, "hedged call needs at least one attempt")
        self._attempts = attempts
        self._on_done = on_done
        # Fires exactly once right after completion with (winner_idx,
        # launched) — winner_idx -1 when every attempt failed. The fleet
        # client's hook for cancelling hedged LOSERS server-side.
        self._on_settled = on_settled
        self._delay_s = max(0.0, float(delay_ms)) / 1e3
        self._sched = scheduler or default_scheduler()
        self._hedge = bool(hedge) and len(attempts) > 1
        self._allow_hedge = allow_hedge
        self._lock = threading.Lock()
        self._done = False
        self._launched = 0
        self._failed = 0
        self._last_error: Optional[BaseException] = None
        self._timer: Optional[_Handle] = None
        self._metrics = _HedgeMetrics.get()

    # -- public -------------------------------------------------------------
    def launch(self) -> "HedgedCall":
        self._launch_next(via_timer=False, via_failover=False)
        return self

    # -- internals ----------------------------------------------------------
    def _launch_next(self, via_timer: bool, via_failover: bool) -> None:
        if via_timer and self._allow_hedge is not None \
                and not self._allow_hedge():
            # Budget dry: skip this hedge. The primary keeps its failover
            # right (a failure still launches the next candidate).
            self._metrics.suppressed.inc()
            return
        with self._lock:
            if self._done or self._launched >= len(self._attempts):
                return
            idx = self._launched
            self._launched += 1
            attempt = self._attempts[idx]
            if via_timer:
                self._metrics.fired.inc()
            if via_failover:
                self._metrics.failover.inc()
            if self._hedge and self._launched < len(self._attempts):
                self._timer = self._sched.call_later(
                    self._delay_s,
                    lambda: self._launch_next(via_timer=True,
                                              via_failover=False))
        try:
            attempt(lambda result, _idx=idx: self._deliver(_idx, result))
        except Exception as e:  # noqa: BLE001 - a sync launch failure is
            self._deliver(idx, e)  # attempt failure, not caller crash

    def _deliver(self, idx: int, result) -> None:
        failed = isinstance(result, BaseException)
        fire_next = False
        complete = False
        with self._lock:
            if self._done:
                # Losing attempt's reply (or error) after completion:
                # discard. This is the "loser cancelled" half of hedging.
                self._metrics.discarded.inc()
                return
            if failed:
                self._failed += 1
                self._last_error = result
                if self._failed == len(self._attempts):
                    self._done = True           # every candidate failed
                    complete = True
                elif self._failed == self._launched:
                    fire_next = True            # nothing outstanding: go now
            else:
                self._done = True
                complete = True
                if idx > 0:
                    self._metrics.won.inc()
                elif self._launched > 1:
                    self._metrics.wasted.inc()
            if (self._done or fire_next) and self._timer is not None:
                self._timer.cancel()
            launched = self._launched
            winner = -1 if failed else idx
        if fire_next:
            self._launch_next(via_timer=False, via_failover=True)
            return
        if complete:
            if self._on_settled is not None:
                try:
                    self._on_settled(winner, launched)
                except Exception as e:  # noqa: BLE001 - a cancel-hook
                    log.error("hedged call: on_settled failed: %s", e)
                    # failure must not cost the caller its result
            try:
                self._on_done(result)
            except Exception as e:  # noqa: BLE001 - downstream callback
                log.error("hedged call: on_done failed: %s", e)  # contained
