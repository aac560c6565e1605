"""Alert rules over the windowed timeseries: the detection half of a
self-healing fleet.

Port of ``multiverso_tpu/telemetry/alerts.py``, host-only: the same rule
shapes, state machine and shipped rule set, so the same series give the
same firing and resolving transitions in both packages. This engine
evaluates a small set of rule shapes against the
:class:`~multiverso_tpu_torch.telemetry.timeseries.TimeseriesStore` every tick
and runs each alert instance through a firing/resolved state machine:

* :class:`BurnRateRule` — multi-window SLO burn rate, the SRE method:
  ``burn = (bad / total) / error_budget`` must exceed the threshold in
  BOTH a fast window (catches the breach quickly) and a slow window
  (refuses to page on one spike). A single bad window dilutes out of the
  slow sum; a sustained breach saturates both.
* :class:`SaturationRule` — a gauge pinned at/over a fraction of its
  capacity gauge for N consecutive windows (queue depth vs admission
  bound, dispatch-window occupancy vs depth).
* :class:`ThresholdRule` — any series compared against a constant
  (heartbeat loss = ``rate.fleet.member_dead > 0`` on the router).
* :class:`StragglerRule` — per-instance alerts over a gauge-name prefix
  (one alert per ``ps_service.staleness.worker_<w>`` over the lag
  bound: the straggler is named, not averaged away).

State machine (per alert INSTANCE): ``ok -> pending`` after one bad
window, ``pending -> firing`` after ``for_windows`` consecutive bad
windows (a single spike that recovers never fires — tested),
``firing -> ok`` after ``clear_windows`` consecutive good windows
(hysteresis: no flapping on a boundary-hugging series). Transitions
count ``telemetry.alerts.fired`` / ``.resolved``, set the
``telemetry.alerts.active`` gauge, and land in the flight recorder.

Active alerts ride the existing fleet heartbeat payload
(``fleet/health.metrics_payload``) so ``Fleet_Stats`` and ``fleet_top``
show a live ALERTS column with no new wire messages.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from multiverso_tpu_torch.telemetry.flight import flight_recorder, \
    watchdog_scope
from multiverso_tpu_torch.telemetry.metrics import Counter, Gauge, counter, \
    gauge
from multiverso_tpu_torch.telemetry.timeseries import TimeseriesStore
from multiverso_tpu_torch.utils.log import log

__all__ = ["AlertRule", "BurnRateRule", "SaturationRule", "ThresholdRule",
           "StragglerRule", "ImbalanceRule", "AlertManager", "AlertEngine",
           "start_alert_engine", "stop_alert_engine", "engine",
           "active_alert_summaries", "default_serving_rules",
           "maybe_start_observability_from_flags"]


class AlertRule:
    """Base rule: yields ``(instance_name, is_bad, value, detail)`` per
    evaluation. Instances let one rule fan out (per-worker stragglers);
    a plain rule yields exactly one instance named after itself."""

    def __init__(self, name: str, severity: str = "page",
                 for_windows: int = 2, clear_windows: int = 3):
        self.name = str(name)
        self.severity = str(severity)
        self.for_windows = max(1, int(for_windows))
        self.clear_windows = max(1, int(clear_windows))

    def attach(self, store: TimeseriesStore) -> None:
        """One-time hook (e.g. arming a histogram threshold)."""

    def evaluate(self, store: TimeseriesStore
                 ) -> Iterator[Tuple[str, bool, float, str]]:
        return iter(())


class BurnRateRule(AlertRule):
    """Multi-window multi-burn-rate SLO alert over one latency
    histogram."""

    def __init__(self, name: str, hist: str, slo_ms: float,
                 budget: float = 0.05, fast_windows: int = 5,
                 slow_windows: int = 60, burn_threshold: float = 2.0,
                 min_count: int = 8, **kw):
        super().__init__(name, **kw)
        self.hist = str(hist)
        self.slo_ms = float(slo_ms)
        self.budget = max(float(budget), 1e-6)
        self.fast_windows = max(1, int(fast_windows))
        self.slow_windows = max(self.fast_windows, int(slow_windows))
        self.burn_threshold = float(burn_threshold)
        self.min_count = max(1, int(min_count))

    def attach(self, store: TimeseriesStore) -> None:
        store.set_threshold(self.hist, self.slo_ms)

    def _burn(self, store: TimeseriesStore, n: int
              ) -> Tuple[Optional[float], float]:
        """(burn rate, window volume); burn None only when the series
        do not EXIST yet (histogram never registered/ticked). Zero
        traffic over an existing series is burn 0.0 — no requests means
        no violations, and a FIRING alert must be able to resolve
        through a traffic trough instead of latching forever."""
        bad = store.sum_last(f"bad.{self.hist}", n)
        total = store.sum_last(f"count.{self.hist}", n)
        if bad is None or total is None:
            return None, 0.0
        if total <= 0.0:
            return 0.0, 0.0
        return (bad / total) / self.budget, total

    def evaluate(self, store):
        fast, n_fast = self._burn(store, self.fast_windows)
        slow, _ = self._burn(store, self.slow_windows)
        if fast is None or slow is None:
            return      # series absent entirely: rule stays dormant
        # min_count gates only the FIRING direction — too few requests
        # to page on, but plenty to keep resolving with.
        bad = n_fast >= self.min_count \
            and fast >= self.burn_threshold \
            and slow >= self.burn_threshold
        yield (self.name, bad, round(fast, 3),
               f"burn fast={fast:.2f} slow={slow:.2f} "
               f"n={n_fast:.0f} (threshold {self.burn_threshold}, "
               f"slo {self.slo_ms}ms, budget {self.budget})")


class SaturationRule(AlertRule):
    """A gauge at/over ``frac`` of its capacity gauge, sustained."""

    def __init__(self, name: str, value_series: str, capacity_series: str,
                 frac: float = 0.9, **kw):
        kw.setdefault("for_windows", 3)
        super().__init__(name, **kw)
        self.value_series = str(value_series)
        self.capacity_series = str(capacity_series)
        self.frac = float(frac)

    def evaluate(self, store):
        value = store.latest(self.value_series)
        cap = store.latest(self.capacity_series)
        if value is None or cap is None or cap <= 0.0:
            return
        bad = value >= self.frac * cap
        yield (self.name, bad, round(value, 3),
               f"{self.value_series}={value:.1f} vs "
               f"{self.frac:.0%} of {self.capacity_series}={cap:.1f}")


class ThresholdRule(AlertRule):
    """Any single series compared against a constant."""

    def __init__(self, name: str, series: str, above: float, **kw):
        super().__init__(name, **kw)
        self.series = str(series)
        self.above = float(above)

    def evaluate(self, store):
        value = store.latest(self.series)
        if value is None:
            return
        yield (self.name, value > self.above, round(value, 3),
               f"{self.series}={value:.3f} > {self.above}")


class StragglerRule(AlertRule):
    """Per-instance alerts over a series-name prefix: each matching
    series (one per worker) gets its own state machine, so one
    straggler's alert names the worker instead of vanishing into a
    fleet mean."""

    def __init__(self, name: str, series_prefix: str, above: float, **kw):
        kw.setdefault("for_windows", 3)
        super().__init__(name, **kw)
        self.series_prefix = str(series_prefix)
        self.above = float(above)

    def evaluate(self, store):
        for series in store.matching(self.series_prefix):
            value = store.latest(series)
            if value is None:
                continue
            suffix = series[len(self.series_prefix):] or series
            yield (f"{self.name}.{suffix}", value > self.above,
                   round(value, 3),
                   f"{series}={value:.2f} > {self.above}")


class ImbalanceRule(AlertRule):
    """Shard-load imbalance: a load-ratio series (p99-to-mean across
    shards, ``sketch.load_ratio`` — the router publishes it from the
    per-replica key rates its heartbeats already carry) sustained at/over
    ``ratio``, gated by a volume series so an idle fleet's noise never
    pages. The base state machine supplies the fire/resolve hysteresis:
    one skewed window is a routing blip, N consecutive ones are a hot
    shard worth rebalancing."""

    def __init__(self, name: str, ratio_series: str, volume_series: str,
                 ratio: float = 1.7, min_volume: float = 100.0, **kw):
        kw.setdefault("for_windows", 3)
        super().__init__(name, **kw)
        self.ratio_series = str(ratio_series)
        self.volume_series = str(volume_series)
        self.ratio = float(ratio)
        self.min_volume = float(min_volume)

    def evaluate(self, store):
        ratio = store.latest(self.ratio_series)
        if ratio is None:
            return      # no shard-load feed in this process: dormant
        volume = store.latest(self.volume_series) or 0.0
        # The volume guard gates only the FIRING direction: a skew that
        # persists into a traffic trough still resolves.
        bad = ratio >= self.ratio and volume >= self.min_volume
        yield (self.name, bad, round(ratio, 3),
               f"{self.ratio_series}={ratio:.2f} >= {self.ratio} "
               f"at {volume:.0f} keys/s (floor {self.min_volume:.0f})")


# ---------------------------------------------------------------------------
# State machine + manager
# ---------------------------------------------------------------------------
class _AlertState:
    __slots__ = ("name", "severity", "state", "bad_windows",
                 "good_windows", "since_unix", "value", "detail",
                 "fired_count")

    def __init__(self, name: str, severity: str):
        self.name = name
        self.severity = severity
        self.state = "ok"
        self.bad_windows = 0
        self.good_windows = 0
        self.since_unix = 0.0
        self.value = 0.0
        self.detail = ""
        self.fired_count = 0


class AlertManager:
    """Evaluates rules against a store and owns every instance's state
    machine. ``evaluate()`` is driven by the engine's tick loop (or
    directly by tests for deterministic windows)."""

    def __init__(self, store: TimeseriesStore, rules: List[AlertRule],
                 shared_telemetry: bool = True):
        self.store = store
        self.rules = list(rules)
        self._lock = threading.Lock()
        self._states: Dict[str, _AlertState] = {}
        #: shared_telemetry=False = a SIDE manager (probes, what-if
        #: evaluation): private metric objects, no flight
        #: events, debug-level transition logs — synthetic firings must
        #: never pollute the real plane's counters or a postmortem.
        self.shared = bool(shared_telemetry)
        if self.shared:
            self._c_fired = counter("telemetry.alerts.fired")
            self._c_resolved = counter("telemetry.alerts.resolved")
            self._c_errors = counter("telemetry.alerts.eval_errors")
            self._g_active = gauge("telemetry.alerts.active")
            self._g_active.set(0.0)
        else:
            self._c_fired = Counter("telemetry.alerts.fired")
            self._c_resolved = Counter("telemetry.alerts.resolved")
            self._c_errors = Counter("telemetry.alerts.eval_errors")
            self._g_active = Gauge("telemetry.alerts.active")
        for rule in self.rules:
            rule.attach(store)

    def evaluate(self) -> None:
        now = time.time()
        results: List[Tuple[AlertRule, str, bool, float, str]] = []
        for rule in self.rules:
            try:
                for inst, bad, value, detail in rule.evaluate(self.store):
                    results.append((rule, inst, bad, value, detail))
            except Exception as e:  # noqa: BLE001 - one broken rule must
                self._c_errors.inc()  # not take the alert plane down
                log.error("alert rule '%s' evaluation failed: %s",
                          rule.name, e)
        transitions: List[Tuple[str, _AlertState]] = []
        with self._lock:
            for rule, inst, bad, value, detail in results:
                st = self._states.get(inst)
                if st is None:
                    st = self._states[inst] = _AlertState(inst,
                                                          rule.severity)
                st.value, st.detail = value, detail
                if st.state == "firing":
                    if bad:
                        st.good_windows = 0
                    else:
                        st.good_windows += 1
                        if st.good_windows >= rule.clear_windows:
                            st.state = "ok"
                            st.bad_windows = st.good_windows = 0
                            transitions.append(("resolved", st))
                elif bad:
                    st.bad_windows += 1
                    st.state = "pending"
                    if st.bad_windows >= rule.for_windows:
                        st.state = "firing"
                        st.since_unix = now
                        st.good_windows = 0
                        st.fired_count += 1
                        transitions.append(("fired", st))
                else:
                    # A spike that recovers before for_windows never
                    # fires — and leaves no half-armed counter behind.
                    st.state = "ok"
                    st.bad_windows = 0
            active = sum(1 for s in self._states.values()
                         if s.state == "firing")
        self._g_active.set(active)
        for kind, st in transitions:
            (self._c_fired if kind == "fired" else self._c_resolved).inc()
            if not self.shared:
                log.debug("side alert %s: %s (%s)", kind, st.name,
                          st.detail)
                continue
            (log.warning if kind == "fired" else log.info)(
                "alert %s: %s (%s)", kind.upper(), st.name, st.detail)
            flight_recorder().note(f"alert_{kind}", alert=st.name,
                                   severity=st.severity, value=st.value,
                                   detail=st.detail)

    def active(self) -> List[Dict]:
        """Firing alerts as compact summaries — the heartbeat payload
        shape (`name`, `severity`, `value`, `for_s`)."""
        now = time.time()
        with self._lock:
            return [{"name": s.name, "severity": s.severity,
                     "value": s.value,
                     "for_s": round(max(now - s.since_unix, 0.0), 1)}
                    for s in sorted(self._states.values(),
                                    key=lambda s: s.name)
                    if s.state == "firing"]

    def snapshot(self) -> Dict:
        with self._lock:
            states = {s.name: {"state": s.state, "value": s.value,
                               "bad_windows": s.bad_windows,
                               "fired_count": s.fired_count,
                               "detail": s.detail}
                      for s in self._states.values()}
        return {"active": self.active(), "states": states,
                "n_rules": len(self.rules)}


# ---------------------------------------------------------------------------
# Engine: ticker thread driving store + manager
# ---------------------------------------------------------------------------
class AlertEngine:
    def __init__(self, rules: List[AlertRule], interval_s: float = 1.0,
                 capacity: int = 240):
        self.interval_s = max(0.02, float(interval_s))
        # The ring must hold every rule's largest window, or a small
        # -telemetry_ts_interval silently SHRINKS the slow-burn horizon
        # (600 wanted windows summed over a 240-deep ring = a 60s guard
        # that actually looks 24s back — the spike-veto property the
        # multi-window method exists for would erode with no warning).
        needed = max((int(getattr(r, attr, 0) or 0)
                      for r in rules
                      for attr in ("fast_windows", "slow_windows",
                                   "for_windows", "clear_windows")),
                     default=1)
        self.store = TimeseriesStore(capacity=max(capacity, needed + 8))
        self.manager = AlertManager(self.store, rules)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-alerts")
        self._thread.start()

    def _loop(self) -> None:
        with watchdog_scope("telemetry-alerts",
                            timeout_s=max(30.0,
                                          20 * self.interval_s)) as wd:
            while not self._stop.wait(self.interval_s):
                wd.beat()
                try:
                    self.store.tick()
                    self.manager.evaluate()
                except Exception as e:  # noqa: BLE001 - the alert plane
                    log.error("alert engine tick failed: %s", e)  # must
                    counter("telemetry.alerts.eval_errors").inc()  # limp,
                    # never crash

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


_engine: Optional[AlertEngine] = None
_engine_lock = threading.Lock()


def engine() -> Optional[AlertEngine]:
    return _engine


def start_alert_engine(rules: Optional[List[AlertRule]] = None,
                       interval_s: Optional[float] = None) -> AlertEngine:
    """Idempotent global engine (one ticker per process). ``rules`` None
    = :func:`default_serving_rules`; ``interval_s`` None = the
    ``-telemetry_ts_interval`` flag (1 s)."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            return _engine
        if interval_s is None:
            interval_s = float(_flag_or("telemetry_ts_interval", 1.0))
        # Rules translate their second-denominated windows using the
        # SAME interval the engine will actually tick at — an explicit
        # interval_s must not leave the flag-derived window counts
        # meaning different wall-clock horizons.
        _engine = AlertEngine(rules if rules is not None
                              else default_serving_rules(interval_s),
                              interval_s=interval_s)
        return _engine


def stop_alert_engine() -> None:
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.stop()
            _engine = None


def active_alert_summaries() -> List[Dict]:
    """Firing alerts of the process-global engine ([] when no engine
    runs) — what the fleet heartbeat ships and a postmortem embeds."""
    eng = _engine
    if eng is None:
        return []
    try:
        return eng.manager.active()
    except Exception:  # noqa: BLE001 - attribution, never control flow
        return []


def _flag_or(name: str, default):
    from multiverso_tpu_torch.utils.configure import flag_or
    return flag_or(name, default)


def default_serving_rules(interval_s: Optional[float] = None
                          ) -> List[AlertRule]:
    """The shipped rule set, parameterized by the ``-serve_slo_*`` flags.
    Rules over series that never appear (no serving plane, no fleet
    router in this process) stay silent — one set fits every role.
    ``interval_s`` is the tick width the window counts are denominated
    in (None = the ``-telemetry_ts_interval`` flag)."""
    interval = max(float(interval_s if interval_s is not None
                         else _flag_or("telemetry_ts_interval", 1.0)),
                   0.02)

    def windows(seconds: float) -> int:
        return max(1, int(round(float(seconds) / interval)))

    return [
        BurnRateRule(
            "serve.slo_burn", hist="serve.latency.total",
            slo_ms=float(_flag_or("serve_slo_ms", 50.0)),
            budget=float(_flag_or("serve_slo_budget", 0.05)),
            fast_windows=windows(_flag_or("serve_slo_fast_s", 5.0)),
            slow_windows=windows(_flag_or("serve_slo_slow_s", 60.0)),
            burn_threshold=float(_flag_or("serve_slo_burn", 2.0)),
            for_windows=2, clear_windows=windows(5.0)),
        SaturationRule(
            "serve.queue_saturation", "gauge.serve.queue_depth",
            "gauge.serve.queue_bound", frac=0.9,
            for_windows=windows(3.0), clear_windows=windows(3.0)),
        SaturationRule(
            "serve.pipeline_saturation", "gauge.serve.pipeline.inflight",
            "gauge.serve.pipeline.depth", frac=1.0, severity="warn",
            for_windows=windows(10.0), clear_windows=windows(5.0)),
        ThresholdRule(
            "fleet.heartbeat_loss", "rate.fleet.member_dead", above=0.0,
            for_windows=1, clear_windows=windows(5.0)),
        StragglerRule(
            "ps.straggler", "gauge.ps_service.staleness.worker_",
            above=32.0, severity="warn",
            for_windows=windows(3.0), clear_windows=windows(3.0)),
        ImbalanceRule(
            "fleet.shard_imbalance", "gauge.fleet.shard_load_ratio",
            "gauge.fleet.shard_keys_rate",
            ratio=float(_flag_or("fleet_imbalance_ratio", 1.7)),
            min_volume=float(_flag_or("fleet_imbalance_min_keys", 100.0)),
            severity="warn",
            for_windows=windows(2.0), clear_windows=windows(3.0)),
    ]


def maybe_start_observability_from_flags() -> bool:
    """CLI-path bring-up (``apps/_runner.run_app``): start the alert
    engine when ``-telemetry_alerts`` and the wedge watchdog + fatal-
    signal handlers when ``-telemetry_flight``. Returns whether anything
    started. ``-telemetry_profile`` raises: the sampling profiler is not
    ported yet."""
    from multiverso_tpu_torch.telemetry.flight import (
        install_crash_handlers, start_watchdog)
    if bool(_flag_or("telemetry_profile", False)):
        raise NotImplementedError(
            "the continuous sampling profiler (-telemetry_profile) is not "
            "ported yet: ROADMAP A11")
    started = False
    if bool(_flag_or("telemetry_alerts", True)):
        start_alert_engine()
        started = True
    if bool(_flag_or("telemetry_flight", True)):
        start_watchdog()
        install_crash_handlers()
        started = True
    return started
