"""The port's timeseries store + alert rule engine: the cases of
``tests/test_telemetry_alerts.py`` run against
``multiverso_tpu_torch.telemetry``; their parity with the JAX package is
in ``tests/test_torch_alerts_parity.py``.

Windows are driven DETERMINISTICALLY: tests call ``store.tick(now=...)``
and ``manager.evaluate()`` by hand instead of sleeping against the
engine's ticker thread, so the state-machine contracts (fires after N
bad windows, never on a single spike, resolves with hysteresis) are
asserted exactly, not probabilistically.
"""

import time

import numpy as np  # noqa: F401 - conftest's device mesh setup

import pytest

import _torch_port

torch = None
get_registry = AlertManager = BurnRateRule = None
SaturationRule = StragglerRule = ThresholdRule = None
active_alert_summaries = default_serving_rules = None
start_alert_engine = stop_alert_engine = None
TimeseriesStore = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, get_registry, AlertManager, BurnRateRule, SaturationRule
    global StragglerRule, ThresholdRule, active_alert_summaries
    global default_serving_rules, start_alert_engine, stop_alert_engine
    global TimeseriesStore
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.telemetry import get_registry
    from multiverso_tpu_torch.telemetry.alerts import (AlertManager,
                                                       BurnRateRule,
                                                       SaturationRule,
                                                       StragglerRule,
                                                       ThresholdRule,
                                                       active_alert_summaries,
                                                       default_serving_rules,
                                                       start_alert_engine,
                                                       stop_alert_engine)
    from multiverso_tpu_torch.telemetry.timeseries import TimeseriesStore


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    reset_telemetry()


@pytest.fixture
def port_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu"])
    yield mvt
    mvt.shutdown()


# ---------------------------------------------------------------------------
# TimeseriesStore
# ---------------------------------------------------------------------------
def test_timeseries_counter_rate_gauge_last(port_env):
    reg = get_registry()
    store = TimeseriesStore(capacity=8)
    c = reg.counter("ts.events")
    g = reg.gauge("ts.depth")
    store.tick(now=0.0)
    c.inc(10)
    g.set(3.0)
    store.tick(now=1.0)
    c.inc(40)
    g.set(7.0)
    store.tick(now=3.0)           # 2-second window: rate halves
    assert store.series("rate.ts.events") == [10.0, 20.0]
    assert store.series("gauge.ts.depth")[-2:] == [3.0, 7.0]
    assert store.latest("gauge.ts.depth") == 7.0


def test_timeseries_windowed_p95_and_threshold(port_env):
    reg = get_registry()
    store = TimeseriesStore()
    h = reg.histogram("ts.lat")
    store.set_threshold("ts.lat", 50.0)
    store.tick(now=0.0)
    for _ in range(20):
        h.observe(1.0)
    store.tick(now=1.0)
    for _ in range(20):
        h.observe(400.0)
    store.tick(now=2.0)
    p95 = store.series("p95.ts.lat")
    # Windowed, not cumulative: the second window's p95 reflects ONLY
    # the 400ms batch (cumulative p95 would blend both).
    assert p95[0] < 10.0 and p95[1] > 100.0
    assert store.series("count.ts.lat") == [20.0, 20.0]
    assert store.series("bad.ts.lat") == [0.0, 20.0]


def test_timeseries_ring_is_bounded(port_env):
    reg = get_registry()
    store = TimeseriesStore(capacity=4)
    g = reg.gauge("ts.bound")
    for i in range(12):
        g.set(float(i))
        store.tick(now=float(i))
    series = store.series("gauge.ts.bound")
    assert len(series) == 4
    assert series == [8.0, 9.0, 10.0, 11.0]
    snap = store.snapshot(last_n=2)
    assert snap["series"]["gauge.ts.bound"] == [10.0, 11.0]
    assert snap["ticks"] == 12


def test_timeseries_series_cardinality_bounded(port_env):
    reg = get_registry()
    store = TimeseriesStore()
    store.MAX_SERIES = 8        # instance attribute shadows the class cap
    for i in range(20):
        reg.gauge(f"ts.card.{i}").set(1.0)
    store.tick(now=0.0)
    assert len(store.names()) <= 8
    assert reg.counter("telemetry.timeseries.series_dropped").value > 0


# ---------------------------------------------------------------------------
# Burn-rate rule: multi-window state machine
# ---------------------------------------------------------------------------
def _burn_env(reg, store):
    rule = BurnRateRule("slo", "burn.lat", slo_ms=50.0, budget=0.05,
                        fast_windows=5, slow_windows=30,
                        burn_threshold=2.0, min_count=8,
                        for_windows=2, clear_windows=3)
    mgr = AlertManager(store, [rule])
    h = reg.histogram("burn.lat")
    clock = [0.0]

    def window(good, bad):
        for _ in range(good):
            h.observe(1.0)
        for _ in range(bad):
            h.observe(500.0)
        clock[0] += 1.0
        store.tick(now=clock[0])
        mgr.evaluate()
    return mgr, window


def test_burn_alert_fires_only_on_sustained_breach(port_env):
    reg = get_registry()
    mgr, window = _burn_env(reg, TimeseriesStore())
    fired0 = reg.counter("telemetry.alerts.fired").value
    for _ in range(30):
        window(20, 0)
    assert mgr.active() == []
    # ONE fully-bad window: the fast window burns but the slow window
    # dilutes it below threshold — a spike never pages.
    window(0, 20)
    assert mgr.active() == []
    for _ in range(3):          # recovery: state machine resets clean
        window(20, 0)
    assert mgr.active() == []
    assert reg.counter("telemetry.alerts.fired").value == fired0
    # Sustained breach: both windows saturate -> fires (and only once).
    n = 0
    while not mgr.active() and n < 40:
        window(0, 20)
        n += 1
    assert mgr.active(), "sustained SLO breach never fired"
    assert mgr.active()[0]["name"] == "slo"
    assert reg.counter("telemetry.alerts.fired").value == fired0 + 1
    assert reg.gauge("telemetry.alerts.active").last == 1.0


def test_burn_alert_resolves_with_hysteresis(port_env):
    reg = get_registry()
    mgr, window = _burn_env(reg, TimeseriesStore())
    for _ in range(10):
        window(20, 0)
    for _ in range(20):
        window(0, 20)
    assert mgr.active()
    resolved0 = reg.counter("telemetry.alerts.resolved").value
    # A couple of good windows are NOT enough: the fast window is still
    # burning (bad windows age out of it first), and clear_windows=3
    # consecutive clean evaluations must follow — no flapping.
    window(20, 0)
    window(20, 0)
    assert mgr.active()
    n = 2
    while mgr.active() and n < 40:
        window(20, 0)
        n += 1
    assert mgr.active() == [], "recovery never resolved the alert"
    # fast window (5) must drain of bad windows + 3 clean evaluations
    assert n >= 5 + 3 - 1
    assert reg.counter("telemetry.alerts.resolved").value == resolved0 + 1
    # Alert transitions landed in the flight recorder ring.
    from multiverso_tpu_torch.telemetry import flight_recorder
    kinds = [e["kind"] for e in flight_recorder().events()]
    assert "alert_fired" in kinds and "alert_resolved" in kinds


def test_burn_alert_quiet_without_traffic(port_env):
    """No observations: no page (zero traffic evaluates as burn 0, and
    a never-ticked histogram keeps the rule fully dormant)."""
    reg = get_registry()
    store = TimeseriesStore()
    rule = BurnRateRule("slo", "quiet.lat", slo_ms=50.0)
    dormant = BurnRateRule("slo2", "never.registered", slo_ms=50.0)
    mgr = AlertManager(store, [rule, dormant])
    reg.histogram("quiet.lat")      # exists, never observed
    for i in range(10):
        store.tick(now=float(i))
        mgr.evaluate()
    assert mgr.active() == []
    states = mgr.snapshot()["states"]
    assert "slo2" not in states     # absent series: rule dormant
    assert all(s["state"] == "ok" for s in states.values())


def test_burn_alert_resolves_through_traffic_trough(port_env):
    """A FIRING burn alert must resolve when traffic stops entirely —
    zero requests means zero violations, not a latched page (review
    finding: the old no-data guard silenced the resolve path too)."""
    reg = get_registry()
    mgr, window = _burn_env(reg, TimeseriesStore())
    for _ in range(10):
        window(20, 0)
    for _ in range(20):
        window(0, 20)
    assert mgr.active()
    n = 0
    while mgr.active() and n < 40:
        window(0, 0)                # the trough: no traffic at all
        n += 1
    assert mgr.active() == [], "alert latched through a traffic trough"


# ---------------------------------------------------------------------------
# Saturation / threshold / straggler rules
# ---------------------------------------------------------------------------
def test_saturation_rule_needs_consecutive_windows(port_env):
    reg = get_registry()
    store = TimeseriesStore()
    rule = SaturationRule("qsat", "gauge.sat.depth", "gauge.sat.bound",
                          frac=0.9, for_windows=3, clear_windows=2)
    mgr = AlertManager(store, [rule])
    reg.gauge("sat.bound").set(10.0)
    depth = reg.gauge("sat.depth")
    clock = [0.0]

    def window(d):
        depth.set(d)
        clock[0] += 1.0
        store.tick(now=clock[0])
        mgr.evaluate()

    window(9.0)
    window(9.5)
    assert mgr.active() == []       # 2 of 3 required windows
    window(2.0)                     # dip resets the count
    window(10.0)
    window(10.0)
    assert mgr.active() == []
    window(10.0)
    assert mgr.active() and mgr.active()[0]["name"] == "qsat"
    window(1.0)
    window(1.0)
    assert mgr.active() == []


def test_threshold_rule_heartbeat_loss_shape(port_env):
    """rate.fleet.member_dead > 0 fires in ONE window (for_windows=1):
    the router's sweep of a SIGKILLed replica is the alert, immediately."""
    reg = get_registry()
    store = TimeseriesStore()
    rule = ThresholdRule("fleet.heartbeat_loss", "rate.fleet.member_dead",
                         above=0.0, for_windows=1, clear_windows=2)
    mgr = AlertManager(store, [rule])
    dead = reg.counter("fleet.member_dead")
    store.tick(now=0.0)
    store.tick(now=1.0)
    mgr.evaluate()
    assert mgr.active() == []
    dead.inc()                      # the sweep removed a member
    store.tick(now=2.0)
    mgr.evaluate()
    assert [a["name"] for a in mgr.active()] == ["fleet.heartbeat_loss"]
    store.tick(now=3.0)
    mgr.evaluate()
    store.tick(now=4.0)
    mgr.evaluate()
    assert mgr.active() == []       # rate back to 0 for clear_windows


def test_straggler_rule_names_the_worker(port_env):
    reg = get_registry()
    store = TimeseriesStore()
    rule = StragglerRule("ps.straggler",
                         "gauge.ps_service.staleness.worker_",
                         above=32.0, for_windows=2, clear_windows=2)
    mgr = AlertManager(store, [rule])
    reg.gauge("ps_service.staleness.worker_0").set(1.0)
    reg.gauge("ps_service.staleness.worker_3").set(80.0)
    for i in range(3):
        store.tick(now=float(i))
        mgr.evaluate()
    names = [a["name"] for a in mgr.active()]
    assert names == ["ps.straggler.3"]      # the straggler is NAMED


# ---------------------------------------------------------------------------
# Engine + payload integration
# ---------------------------------------------------------------------------
def test_engine_ticks_and_feeds_its_snapshot(port_env):
    """The engine's ticker runs, its store and manager carry the
    sections the JAX exporter embeds (the snapshot export itself waits:
    ROADMAP A11), and a second start returns the same engine."""
    reg = get_registry()
    reg.counter("eng.events").inc(5)
    eng = start_alert_engine(rules=default_serving_rules(),
                             interval_s=0.03)
    try:
        deadline = time.monotonic() + 5
        while eng.store.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.store.ticks >= 3, "engine ticker never ran"
        alerts, series = eng.manager.snapshot(), eng.store.snapshot()
        assert alerts["n_rules"] == len(default_serving_rules())
        assert "rate.eng.events" in series["series"]
        assert series["ticks"] >= 3
        # idempotent: a second start returns the same engine
        assert start_alert_engine() is eng
    finally:
        stop_alert_engine()
    assert active_alert_summaries() == []   # no engine -> empty, no raise


def test_alerts_ride_heartbeat_payload_and_fleet_rollup(port_env):
    """A firing alert in the replica's engine reaches metrics_payload,
    the router's Fleet_Stats rollup, and the fleet_top ALERTS column —
    the whole shipping path without a wire."""
    from multiverso_tpu_torch.apps.fleet_top import render_stats
    from multiverso_tpu_torch.fleet.health import metrics_payload
    from multiverso_tpu_torch.fleet.membership import ReplicaGroup

    reg = get_registry()
    eng = start_alert_engine(
        rules=[ThresholdRule("unit.always", "gauge.unit.bad", above=0.0,
                             for_windows=1)],
        interval_s=0.03)
    try:
        reg.gauge("unit.bad").set(5.0)
        deadline = time.monotonic() + 5
        while not active_alert_summaries() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        alerts = active_alert_summaries()
        assert [a["name"] for a in alerts] == ["unit.always"]

        payload = metrics_payload()
        assert [a["name"] for a in payload["alerts"]] == ["unit.always"]

        group = ReplicaGroup(heartbeat_ms=40.0)
        group.join("r0", "127.0.0.1", 1)
        group.heartbeat("r0", {"max_queue": 8, "max_batch": 4},
                        metrics=payload)
        stats = group.stats_payload()
        assert [a["name"] for a in stats["replicas"]["r0"]["alerts"]] \
            == ["unit.always"]
        # router-side engine alerts also counted (same process here)
        assert stats["fleet"]["alerts_active"] >= 1
        rendered = render_stats(stats)
        assert "unit.always"[:11] in rendered
        assert "alerts=" in rendered.splitlines()[0]
    finally:
        stop_alert_engine()


def test_finished_worker_retires_from_straggler_staleness(port_env):
    """A worker that declared Finish_Train stops aging in the staleness
    gauges: before this fix the leader sweep kept growing a departed
    worker's published lag forever, so the ps.straggler alert latched a
    permanently-firing phantom that named a worker that left cleanly and
    could never resolve. Retired workers publish 0; an add un-retires
    and the next sweep restores the true lag."""
    from multiverso_tpu_torch.parallel.ps_service import PSService
    reg = get_registry()
    svc = PSService()
    try:
        for _ in range(3):          # worker 0 leads at count 3
            svc._note_worker_add(0)
        svc._note_worker_add(1)     # worker 1 trails by 2
        g1 = reg.gauge("ps_service.staleness.worker_1")
        assert g1.last == 2.0
        # Clean goodbye: gauge zeroes immediately...
        svc._retire_worker_staleness(1)
        assert g1.last == 0.0
        # ...and STAYS zero while the leader keeps advancing (the old
        # sweep republished a monotonically growing lag here).
        for _ in range(5):
            svc._note_worker_add(0)
        assert g1.last == 0.0
        # An add un-retires: real lag (top=8, own count=2) republishes.
        svc._note_worker_add(1)
        assert g1.last == 6.0
    finally:
        svc.close()


def test_engine_ring_holds_largest_rule_window(port_env):
    """A small tick interval must not silently shrink the slow-burn
    horizon: the engine's ring grows to hold every rule's largest
    window (600 wanted windows over a 240-deep ring would turn the 60s
    spike-veto guard into a 24s one with no warning)."""
    from multiverso_tpu_torch.telemetry.alerts import AlertEngine
    eng = AlertEngine(
        [BurnRateRule("unit.burn", hist="unit.lat", slo_ms=50.0,
                      budget=0.05, fast_windows=50, slow_windows=600,
                      burn_threshold=2.0)],
        interval_s=0.1)
    try:
        assert eng.store.capacity >= 600
    finally:
        eng.stop()
    # the default stays at the documented 240 when no rule needs more
    eng2 = AlertEngine(
        [ThresholdRule("unit.thr", "gauge.unit.g", above=0.0,
                       for_windows=1)], interval_s=1.0)
    try:
        assert eng2.store.capacity == 240
    finally:
        eng2.stop()
