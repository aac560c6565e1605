"""The port's flight recorder, wedge watchdog, and postmortem dumps: the
cases of ``tests/test_flight_recorder.py`` run against
``multiverso_tpu_torch.telemetry`` (the JAX package's
``scripts/telemetry_report.py --postmortem`` reads the port's dumps).

Trips are driven through ``_WatchdogMonitor.check_once()`` or tiny
timeouts + a fast poll — never by waiting out production timeouts — so
the module stays cheap in tier-1.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np  # noqa: F401 - conftest's device mesh setup

import pytest

import _torch_port

torch = None
build_postmortem = dump_postmortem = flight_recorder = None
get_registry = span = start_watchdog = stop_watchdog = None
validate_postmortem = watchdog_handles = None
watchdog_register = log = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, build_postmortem, dump_postmortem, flight_recorder
    global get_registry, span, start_watchdog, stop_watchdog
    global validate_postmortem, watchdog_handles, watchdog_register, log
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.telemetry import (build_postmortem,
                                                dump_postmortem,
                                                flight_recorder, get_registry,
                                                span, start_watchdog,
                                                stop_watchdog,
                                                validate_postmortem,
                                                watchdog_handles,
                                                watchdog_register)
    from multiverso_tpu_torch.utils.log import log


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



_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_watchdog_trips_wedged_loop_and_dumps_postmortem(port_env, tmp_path):
    """A loop that stops beating trips exactly once per wedge, and the
    dump is a schema-valid postmortem carrying every live thread's
    stack."""
    reg = get_registry()
    trips0 = reg.counter("telemetry.watchdog.trips").value

    wedged = threading.Event()

    def loop(handle):
        while not wedged.is_set():
            handle.beat()
            time.sleep(0.01)
        time.sleep(10)          # the wedge: alive, no progress

    h = watchdog_register("wedge-unit", timeout_s=0.15)
    t = threading.Thread(target=loop, args=(h,), daemon=True)
    t.start()
    start_watchdog(poll_s=0.03, out_dir=str(tmp_path))
    try:
        time.sleep(0.3)
        assert reg.counter("telemetry.watchdog.trips").value == trips0, \
            "a beating loop tripped (steady state must be quiet)"
        wedged.set()
        deadline = time.monotonic() + 5
        while reg.counter("telemetry.watchdog.trips").value == trips0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert reg.counter("telemetry.watchdog.trips").value == trips0 + 1
        # one trip per wedge: the monitor must not re-trip every poll
        time.sleep(0.2)
        assert reg.counter("telemetry.watchdog.trips").value == trips0 + 1
    finally:
        stop_watchdog()
        h.close()

    path = tmp_path / f"postmortem-{os.getpid()}.json"
    # The dump runs detached from the monitor (bounded join — a wedged
    # lock holder must not wedge the watchdog too): poll for the file.
    deadline = time.monotonic() + 5
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert path.exists(), "tripped watchdog wrote no postmortem"
    pm = json.loads(path.read_text())
    validate_postmortem(pm)
    assert pm["reason"]["kind"] == "watchdog"
    assert pm["reason"]["loop"] == "wedge-unit"
    # >= all live threads: the wedged loop AND the main thread both show
    names = {t["name"] for t in pm["threads"]}
    assert "MainThread" in names
    assert len(pm["threads"]) >= 2
    assert pm["watchdogs"]["wedge-unit"]["tripped"] is True
    # the trip itself is a flight event inside its own dump
    assert any(e["kind"] == "watchdog_trip"
               for e in pm["flight"]["events"])


def test_watchdog_rearms_after_beat(port_env):
    from multiverso_tpu_torch.telemetry.flight import _WatchdogMonitor
    h = watchdog_register("rearm-unit", timeout_s=0.05)
    mon = _WatchdogMonitor(poll_s=3600.0, out_dir=None)  # manual sweeps
    try:
        time.sleep(0.1)
        assert mon.check_once() == ["rearm-unit"]
        assert mon.check_once() == []       # tripped: no re-fire
        h.beat()                            # progress resumed: re-armed
        assert h.tripped is False
        time.sleep(0.1)
        assert mon.check_once() == ["rearm-unit"]
    finally:
        mon.stop()
        h.close()


def test_watchdog_handle_names_unique_and_gauge_tracks(port_env):
    reg = get_registry()
    a = watchdog_register("dup-unit", timeout_s=1.0)
    b = watchdog_register("dup-unit", timeout_s=1.0)
    try:
        names = {h.name for h in watchdog_handles()}
        assert {"dup-unit", "dup-unit#2"} <= names
        assert reg.gauge("telemetry.watchdog.loops").last >= 2
    finally:
        a.close()
        b.close()
    assert not any(h.name.startswith("dup-unit")
                   for h in watchdog_handles())


def test_postmortem_carries_flight_logs_spans_and_metrics(port_env):
    log.info("flight-unit: a breadcrumb before the crash")
    with span("flight.unit_probe"):
        pass
    flight_recorder().note("unit_event", detail="payload")
    get_registry().counter("flight.unit_counter").inc(3)

    pm = build_postmortem({"kind": "test", "why": "unit"})
    validate_postmortem(pm)
    assert any("flight-unit: a breadcrumb" in line
               for line in pm["flight"]["logs"])
    assert any(e.get("kind") == "unit_event"
               for e in pm["flight"]["events"])
    assert any(s.get("name") == "flight.unit_probe"
               for s in pm["flight"]["spans"])
    assert pm["metrics"]["counters"]["flight.unit_counter"]["value"] == 3
    # no -telemetry_dir flag, no explicit dir: build-only, not written
    assert dump_postmortem({"kind": "test"}) is None


def test_batcher_and_pipeline_loops_register_watchdogs(port_env):
    """The serving daemon loops ship instrumented: constructing a
    pipelined batcher registers (and beats) its watchdog handles, and
    close() deregisters them — the graftlint rule's runtime witness."""
    from multiverso_tpu_torch.serving.batcher import DynamicBatcher

    class Runner:
        payload_dtype = np.int32
        pad_id = 0

        def dispatch(self, mat, lengths):
            return mat

        def collect(self, handle):
            return handle

        def run(self, mat, lengths):
            return mat

        def slice_result(self, out, i, n):
            return out[i, :n]

    before = {h.name for h in watchdog_handles()}
    b = DynamicBatcher(Runner(), buckets=(4,), max_batch=2,
                       max_wait_ms=0.0, max_queue=8, pipeline_depth=2)
    try:
        deadline = time.monotonic() + 5
        want = {"serve-batcher", "serve-collector"}
        while time.monotonic() < deadline:
            names = {h.name.split("#")[0]
                     for h in watchdog_handles()} - before
            if want <= names:
                break
            time.sleep(0.01)
        assert want <= names
        b.submit(np.asarray([1, 2], np.int32), 10_000).wait(10)
        batcher_h = [h for h in watchdog_handles()
                     if h.name.startswith("serve-batcher")][0]
        assert batcher_h.beats >= 1
    finally:
        b.close()
    assert not any(h.name.startswith(("serve-batcher", "serve-collector"))
                   and h.name not in before for h in watchdog_handles())


def test_fatal_signal_dumps_postmortem_subprocess(port_env, tmp_path):
    """SIGABRT on a process with crash handlers installed leaves a
    schema-valid postmortem AND still dies by the signal's own
    semantics (abrupt, non-zero) — the fault-drill contract."""
    script = (
        "import os, signal\n"
        "from multiverso_tpu_torch.telemetry import install_crash_handlers\n"
        f"assert install_crash_handlers(out_dir={str(tmp_path)!r})\n"
        "os.kill(os.getpid(), signal.SIGABRT)\n"
        "raise SystemExit('unreachable: handler must re-raise fatally')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    dumps = list(tmp_path.glob("postmortem-*.json"))
    assert len(dumps) == 1, (proc.stdout, proc.stderr)
    pm = json.loads(dumps[0].read_text())
    validate_postmortem(pm)
    assert pm["reason"]["kind"] == "signal"
    assert pm["reason"]["signal_name"] == "SIGABRT"


def test_telemetry_report_postmortem_cli(port_env, tmp_path, capsys):
    dump_postmortem({"kind": "test", "why": "cli"},
                    out_dir=str(tmp_path))
    from scripts.telemetry_report import print_postmortems
    assert print_postmortems(str(tmp_path)) == 1
    out = capsys.readouterr().out
    assert "reason: test" in out and "threads:" in out
    # a corrupt dump is reported INVALID, not crashed on
    (tmp_path / "postmortem-99.json").write_text("{}")
    assert print_postmortems(str(tmp_path)) == 1
