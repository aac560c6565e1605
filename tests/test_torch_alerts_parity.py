"""Port parity: the timeseries store and the alert engine against the JAX
package on the same seeded series.

For each rule of ``default_serving_rules`` a seeded sequence of windows
(healthy stretches, a spike, a sustained breach, recovery) is fed to
both packages' metrics registries, both stores tick on the same fake
clock, and both ``AlertManager``\\ s evaluate after every tick: every
window's rule states (state, bad windows, times fired, value, detail)
and firing set must be identical, and every rule must fire and resolve
at least once. The timeseries themselves (every series' windows) are
held equal too. Host-side float arithmetic in the same order on both
sides: exact equality.
"""

import numpy as np
import pytest

import _torch_port
from multiverso_tpu.telemetry import alerts as jalerts
from multiverso_tpu.telemetry import get_registry as jregistry
from multiverso_tpu.telemetry import timeseries as jts

talerts = tregistry = tts = None

INTERVAL_S = 1.0
RULES = ("serve.slo_burn", "serve.queue_saturation",
         "serve.pipeline_saturation", "fleet.heartbeat_loss", "ps.straggler",
         "fleet.shard_imbalance")


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global talerts, tregistry, tts
    _torch_port.load_torch()
    from multiverso_tpu_torch.telemetry import alerts as talerts
    from multiverso_tpu_torch.telemetry import get_registry as tregistry
    from multiverso_tpu_torch.telemetry import timeseries as tts


@pytest.fixture(autouse=True)
def _reset_registries():
    jregistry().reset()
    tregistry().reset()
    yield
    jregistry().reset()
    tregistry().reset()


def _phases(rng, windows: int) -> np.ndarray:
    """Per window: 0 healthy, 1 breach. A one-window spike, a sustained
    breach, a recovery, a second sustained breach, then quiet."""
    bad = np.zeros(windows, bool)
    bad[5] = True
    start = int(rng.integers(10, 14))
    bad[start:start + 12] = True
    start2 = int(rng.integers(40, 44))
    bad[start2:start2 + 10] = True
    return bad


def _feed(rule: str, reg, bad: bool, rng) -> None:
    """One window of traffic for ``rule`` into ``reg``."""
    if rule == "serve.slo_burn":
        h = reg.histogram("serve.latency.total")
        for _ in range(int(rng.integers(20, 40))):
            h.observe(float(rng.uniform(60, 400) if bad and
                            rng.random() < 0.6 else rng.uniform(0.5, 20)))
    elif rule == "serve.queue_saturation":
        reg.gauge("serve.queue_bound").set(64.0)
        reg.gauge("serve.queue_depth").set(
            float(rng.integers(58, 65) if bad else rng.integers(0, 40)))
    elif rule == "serve.pipeline_saturation":
        reg.gauge("serve.pipeline.depth").set(3.0)
        reg.gauge("serve.pipeline.inflight").set(
            3.0 if bad else float(rng.integers(0, 3)))
    elif rule == "fleet.heartbeat_loss":
        if bad:
            reg.counter("fleet.member_dead").inc(int(rng.integers(1, 3)))
    elif rule == "ps.straggler":
        for w in range(3):
            lag = rng.uniform(40, 90) if bad and w == 1 \
                else rng.uniform(0, 20)
            reg.gauge(f"ps_service.staleness.worker_{w}").set(float(lag))
    elif rule == "fleet.shard_imbalance":
        reg.gauge("fleet.shard_keys_rate").set(
            float(rng.uniform(200, 900)))
        reg.gauge("fleet.shard_load_ratio").set(
            float(rng.uniform(1.8, 3.0) if bad else rng.uniform(1.0, 1.4)))


def _states(manager) -> dict:
    snap = manager.snapshot()
    return {"states": snap["states"],
            "active": [(a["name"], a["severity"], a["value"])
                       for a in snap["active"]]}


@pytest.mark.parametrize("rule", RULES)
def test_rule_transitions_identical(rule):
    rng_seed = 1000 + RULES.index(rule)
    windows = 70
    bad = _phases(np.random.default_rng(rng_seed), windows)
    sides = []
    for alerts, ts, reg in ((jalerts, jts, jregistry()),
                            (talerts, tts, tregistry())):
        rules = [r for r in alerts.default_serving_rules(INTERVAL_S)
                 if r.name == rule]
        assert len(rules) == 1
        store = ts.TimeseriesStore(capacity=240)
        manager = alerts.AlertManager(store, rules, shared_telemetry=False)
        rng = np.random.default_rng(rng_seed)
        trace = []
        for w in range(windows):
            _feed(rule, reg, bool(bad[w]), rng)
            store.tick(now=float(w) * INTERVAL_S)
            manager.evaluate()
            trace.append(_states(manager))
        series = {name: store.series(name) for name in store.names()
                  if not name.startswith(("gauge.telemetry.",
                                          "rate.telemetry."))}
        sides.append((trace, series))
    (jtrace, jseries), (ttrace, tseries) = sides
    for w, (j, t) in enumerate(zip(jtrace, ttrace)):
        assert t == j, (rule, w)
    assert tseries == jseries
    fired = [bool(s["active"]) for s in ttrace]
    assert any(fired), rule
    assert not fired[-1], rule                  # resolved by the end
    # A one-window spike never fires (every rule needs 2+ bad windows,
    # except heartbeat loss, which fires on one by design).
    if rule != "fleet.heartbeat_loss":
        assert not fired[5], rule


def test_default_rules_identical():
    """The shipped rule set: names, severities and every window count."""
    for interval in (0.25, 1.0, 2.0):
        j = jalerts.default_serving_rules(interval)
        t = talerts.default_serving_rules(interval)
        assert [type(r).__name__ for r in t] == \
            [type(r).__name__ for r in j]
        assert [vars(r) for r in t] == [vars(r) for r in j]


def test_timeseries_windows_identical():
    """Counters, gauges and histograms through both stores: every series'
    windows equal, and the snapshot embed equal."""
    rng = np.random.default_rng(21)
    stores = [jts.TimeseriesStore(capacity=16),
              tts.TimeseriesStore(capacity=16)]
    for store in stores:
        store.set_threshold("lat", 10.0)
    for w in range(30):
        events = int(rng.integers(0, 50))
        gauge = float(rng.normal())
        lat = rng.lognormal(1.0, 1.2, size=int(rng.integers(0, 30)))
        for reg in (jregistry(), tregistry()):
            reg.counter("events").inc(events)
            reg.gauge("depth").set(gauge)
            for x in lat:
                reg.histogram("lat").observe(float(x))
        for store in stores:
            store.tick(now=0.5 * w)
    j, t = stores
    names = [n for n in j.names() if not n.startswith(
        ("gauge.telemetry.", "rate.telemetry."))]
    assert names == [n for n in t.names() if not n.startswith(
        ("gauge.telemetry.", "rate.telemetry."))]
    for name in names:
        assert t.series(name) == j.series(name), name
        assert t.sum_last(name, 5) == j.sum_last(name, 5)
        assert t.avg_last(name, 7) == j.avg_last(name, 7)
    js, tsnap = j.snapshot(8), t.snapshot(8)
    assert {k: v for k, v in tsnap["series"].items() if k in names} == \
        {k: v for k, v in js["series"].items() if k in names}
    assert (tsnap["ticks"], tsnap["capacity"], tsnap["interval_s"]) == \
        (js["ticks"], js["capacity"], js["interval_s"])
