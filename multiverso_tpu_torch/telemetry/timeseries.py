"""Bounded in-process timeseries: downsampled windows over the registry.

Port of ``multiverso_tpu/telemetry/timeseries.py``, host-only and the
same series, window math and bounds. Point-in-time gauges and cumulative
counters cannot see the pathologies that matter at fleet scale: tail and
straggler shapes and *sustained* SLO burn (the failures are windowed,
not instantaneous). This module turns the metrics registry into cheap
windowed series the alert engine (``alerts.py``) evaluates burn rates
against:

* every **counter** becomes ``rate.<name>``: events/second over the tick
  window;
* every **gauge** becomes ``gauge.<name>``: last value at the tick;
* every **histogram** becomes ``p95.<name>`` (windowed p95 from the
  log-2 bucket DELTAS, not the cumulative distribution) and
  ``count.<name>`` (observations in the window); histograms with a
  registered threshold additionally produce ``bad.<name>``: the number
  of window observations whose bucket lies at/above the threshold, the
  numerator of an SLO burn rate.

Each tick first folds the hot-key sketches' per-thread buffers
(``sketch.py``'s ``SketchHub.flush``), so the ``sketch.<surface>.*``
series advance on the same cadence as everything else.

Memory is FIXED: one float ring (``capacity`` deep, default 240 windows)
per series, plus one previous-snapshot record per metric. Series
cardinality is bounded too (``MAX_SERIES``); beyond it new metrics are
dropped and counted (``telemetry.timeseries.series_dropped``) so the
observability plane reports its own saturation instead of growing
without bound.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from multiverso_tpu_torch.telemetry.metrics import Histogram, get_registry

__all__ = ["TimeseriesStore"]


# Windowed p95/bad math is Histogram's own bucket math applied to
# per-window count DELTAS: Histogram.percentile_from_counts /
# .violations_from_counts are THE single statement of what a bucket
# means — a drift between the cumulative and windowed views can't
# happen structurally.
_windowed_percentile = Histogram.percentile_from_counts
_violations = Histogram.violations_from_counts


class TimeseriesStore:
    """Ring-buffered windowed series over every registered metric.

    ``tick()`` samples the registry once, differentiates counters and
    histogram buckets against the previous tick, and appends one float
    per series. Thread-safe; readers get list copies."""

    #: Hard series-cardinality bound: the observability plane must never
    #: become the memory leak it exists to catch.
    MAX_SERIES = 1024

    def __init__(self, capacity: int = 240):
        self.capacity = max(4, int(capacity))
        self._lock = threading.Lock()
        self._series: Dict[str, "collections.deque[float]"] = {}
        self._prev_counters: Dict[str, int] = {}
        self._prev_hists: Dict[str, Tuple[int, List[int]]] = {}
        self._thresholds: Dict[str, float] = {}
        self._last_tick: Optional[float] = None
        self._dropped_this_tick = 0
        self.ticks = 0
        self.interval_s = 0.0       # measured dt of the latest window

    # -- configuration -------------------------------------------------------
    def set_threshold(self, hist_name: str, threshold_ms: float) -> None:
        """Arm ``bad.<hist_name>`` (window observations over the
        threshold) — the numerator an SLO burn-rate rule divides by
        ``count.<hist_name>``."""
        with self._lock:
            self._thresholds[str(hist_name)] = float(threshold_ms)

    # -- sampling ------------------------------------------------------------
    def _append_locked(self, name: str, value: float) -> None:
        ring = self._series.get(name)
        if ring is None:
            if len(self._series) >= self.MAX_SERIES:
                # Outside this lock (metrics lock ordering: registry
                # locks are only ever taken BEFORE this store's lock by
                # tick(); counter inc here would invert that on the
                # drop path) — flag for the caller instead.
                self._dropped_this_tick += 1
                return
            ring = self._series[name] = collections.deque(
                maxlen=self.capacity)
        ring.append(float(value))

    def tick(self, now: Optional[float] = None) -> None:
        """Sample every registry metric into one new window. ``now`` is a
        ``time.monotonic()`` stand-in for tests that want deterministic
        window widths."""
        now = time.monotonic() if now is None else float(now)
        reg = get_registry()
        # Publish the span ring's eviction tally here (and in the
        # exporter snapshot): the ring counts drops lock-locally so the
        # span hot path never touches the registry.
        from multiverso_tpu_torch.telemetry.spans import get_trace_buffer
        reg.gauge("telemetry.spans.dropped").set(
            get_trace_buffer().dropped)
        # Fold the per-thread hot-key buffers into the traffic sketches
        # and publish their derived load metrics (sketch.<surface>.*)
        # BEFORE the registry read below, so rows/sec and skew series
        # advance on the same tick cadence as everything else.
        from multiverso_tpu_torch.telemetry.sketch import get_sketch_hub
        get_sketch_hub().flush()
        hists, counters, gauges = reg.metrics()
        # Snapshot the raw material first (per-metric locks), then fold
        # into the rings under this store's lock.
        counter_vals = [(c.name, c.value) for c in counters]
        gauge_vals = [(g.name, g.last) for g in gauges]
        hist_vals = []
        for h in hists:
            count, buckets = h.raw_counts()
            hist_vals.append((h.name, count, buckets))
        with self._lock:
            dt = max(now - self._last_tick, 1e-9) \
                if self._last_tick is not None else 0.0
            self._last_tick = now
            self._dropped_this_tick = 0
            first = self.ticks == 0
            self.ticks += 1
            self.interval_s = dt
            for name, value in counter_vals:
                prev = self._prev_counters.get(name)
                self._prev_counters[name] = value
                if prev is None or first or dt <= 0.0:
                    continue        # no baseline: a rate needs two ticks
                self._append_locked(f"rate.{name}",
                                    max(value - prev, 0) / dt)
            for name, value in gauge_vals:
                self._append_locked(f"gauge.{name}", value)
            for name, count, buckets in hist_vals:
                prev = self._prev_hists.get(name)
                self._prev_hists[name] = (count, buckets)
                if prev is None or first:
                    continue
                p_count, p_buckets = prev
                deltas = [max(b - pb, 0)
                          for b, pb in zip(buckets, p_buckets)]
                total = max(count - p_count, 0)
                self._append_locked(f"count.{name}", total)
                self._append_locked(f"p95.{name}",
                                    _windowed_percentile(deltas, total,
                                                         0.95))
                thr = self._thresholds.get(name)
                if thr is not None:
                    self._append_locked(f"bad.{name}",
                                        _violations(deltas, thr))
            dropped = self._dropped_this_tick
        if dropped:
            reg.counter("telemetry.timeseries.series_dropped").inc(dropped)

    # -- reads ---------------------------------------------------------------
    def series(self, name: str) -> List[float]:
        with self._lock:
            ring = self._series.get(name)
            return list(ring) if ring is not None else []

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1] if ring else None

    def sum_last(self, name: str, n: int) -> Optional[float]:
        """Sum over the last ``n`` windows (fewer if less history exists);
        None when the series does not exist yet."""
        with self._lock:
            ring = self._series.get(name)
            if not ring:
                return None
            vals = list(ring)[-max(int(n), 1):]
        return float(sum(vals))

    def avg_last(self, name: str, n: int) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            if not ring:
                return None
            vals = list(ring)[-max(int(n), 1):]
        return float(sum(vals) / len(vals))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def matching(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(n for n in self._series if n.startswith(prefix))

    def snapshot(self, last_n: int = 30) -> Dict:
        """Compact exporter embed: the trailing ``last_n`` windows per
        series (rounded — the exporter schema is JSON, and 12 digits of
        a queue-depth gauge is noise)."""
        with self._lock:
            series = {name: [round(v, 4) for v in
                             list(ring)[-max(int(last_n), 1):]]
                      for name, ring in self._series.items()}
            return {"interval_s": round(self.interval_s, 4),
                    "ticks": self.ticks,
                    "capacity": self.capacity,
                    "series": series}
