"""The port's fleet CLIs on the CPU: ``fleet_main``'s five roles,
``fleet_top``, and the runner's alert engine and watchdog.

* ``local`` + ``drain`` + the supervisor: ``chip_smoke.py`` phase 13
  (a)-(c) at a small size with ``-serve_device=cpu`` (lookups bitwise the
  seeded table, a rolling drain under load with no failed request, a
  SIGKILLed replica respawned and back in the ring, every replica run's
  launch line on ``cpu``);
* ``router`` and ``replica`` as separate processes, stopped by SIGTERM
  (the replica prints ``FLEET_REPLICA_LAUNCHES``);
* ``ps_fleet``: its seats announce and it stops cleanly;
* ``fleet_top -fleet_top_n=1`` renders one snapshot of a live router.

Each test that spawns processes has its own deadline and stops them in
``finally``.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import _torch_port

torch = None  # set by _load_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch
    torch = _torch_port.load_torch()


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


def _fleet_main(*args, log=None):
    return subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.apps.fleet_main",
         *args], cwd=REPO, stdout=log, stderr=subprocess.STDOUT
        if log is not None else None)


def _wait_file(path: str, procs, t0: float) -> None:
    while not os.path.exists(path):
        assert all(p.poll() is None for p in procs), path
        assert time.monotonic() - t0 < DEADLINE_S, path
        time.sleep(0.05)


def _stop(procs) -> list:
    codes = []
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            codes.append(p.wait(timeout=60))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def test_local_drain_and_supervised_failover_on_the_cpu():
    import chip_smoke
    out = chip_smoke.fleet_lookups(4, rows=3_000, cols=8, device="cpu",
                                   load_s=1.0)
    assert out["lookups"]["errors"] == 0 and out["lookups"]["requests"] > 0
    assert out["drain"]["errors"] == 0
    assert all(out["drain"]["drains_after"][m] > n
               for m, n in out["drain"]["drains_before"].items())
    assert out["failover"]["errors"] == 0
    assert out["failover"]["kill_to_rejoin_s"] < DEADLINE_S
    assert len(out["replica_launches"]) == 2


def test_router_and_replica_roles(tmp_path):
    """A router process and a replica process of a seeded table: routed
    lookups bitwise the table; SIGTERM stops both with exit 0 and the
    replica prints its launch line (its store on the CPU)."""
    from multiverso_tpu_torch.fleet import FleetClient

    addr = str(tmp_path / "router.addr")
    rlog = open(tmp_path / "replica.log", "w")
    procs = [_fleet_main("-fleet_role=router", f"-fleet_addr_file={addr}",
                         "-serve_device=cpu", "-serve_duration=300")]
    cli = None
    try:
        t0 = time.monotonic()
        _wait_file(addr, procs, t0)
        host, port = open(addr).read().split(":")
        procs.append(_fleet_main(
            "-fleet_role=replica", f"-fleet_router={host}:{port}",
            "-fleet_member_id=solo", "-fleet_synthetic=2000x6@9",
            "-serve_device=cpu", "-serve_duration=300", log=rlog))
        cli = FleetClient((host, int(port)), refresh_s=0.05)
        while not cli.refresh().members:
            assert procs[1].poll() is None
            assert time.monotonic() - t0 < DEADLINE_S
            time.sleep(0.05)
        want = np.random.default_rng(9).normal(size=(2000, 6)) \
            .astype(np.float32)
        for keys in np.random.default_rng(1).integers(0, 2000, (20, 8)):
            keys = keys.astype(np.int32)
            got = cli.lookup(keys, deadline_ms=10_000, timeout=30)
            assert got.tobytes() == want[keys].tobytes()
    finally:
        if cli is not None:
            cli.close()
        codes = _stop(procs[::-1])
        rlog.close()
    assert codes == [0, 0]
    import chip_smoke
    text = open(tmp_path / "replica.log").read()
    serving = chip_smoke.tagged_lines(text, "FLEET_REPLICA_SERVING")
    assert [(o["member"], o["device"]) for o in serving] == [("solo", "cpu")]
    lines = chip_smoke.replica_launches(text)
    assert len(lines) == 1
    assert lines[0]["member"] == "solo" and lines[0]["device"] == "cpu"
    assert set(lines[0]["launches"]) >= {"gather_rows"}


def test_ps_fleet_role(tmp_path):
    """``-fleet_role=ps_fleet``: its seats announce, and SIGTERM stops
    the role (and with it every seat) with exit 0."""
    work = str(tmp_path / "ps")
    proc = _fleet_main("-fleet_role=ps_fleet", "-ps_fleet_shards=2",
                       f"-ps_fleet_dir={work}", "-ps_table_size=64",
                       "-serve_device=cpu", "-serve_duration=300")
    try:
        t0 = time.monotonic()
        for rank in (1, 2):
            _wait_file(os.path.join(work, f"seat{rank}.addr"), [proc], t0)
    finally:
        codes = _stop([proc])
    assert codes == [0]


def test_fleet_top_renders_one_snapshot(capsys):
    """``fleet_top -fleet_top_n=1`` against a live router with one
    member prints the member table once and exits 0."""
    from multiverso_tpu_torch.apps import fleet_top
    from multiverso_tpu_torch.fleet import FleetRouter

    router = FleetRouter(heartbeat_ms=50.0)
    try:
        router.group.join("m0", "127.0.0.1", 1)
        router.group.heartbeat("m0", {"max_queue": 64.0, "max_batch": 8.0})
        host, port = router.address
        rc = fleet_top.main([f"-fleet_router={host}:{port}",
                             "-fleet_top_n=1", "-serve_device=cpu"])
    finally:
        router.close()
    assert rc == 0
    out = capsys.readouterr().out
    assert "m0" in out and "\x1b[2J" not in out


def test_run_app_runs_the_alert_engine_and_watchdog():
    """The runner starts the alert engine and the watchdog for the body
    and stops both after shutdown; -telemetry_profile raises (the
    profiler is not ported: ROADMAP A11)."""
    from multiverso_tpu_torch.apps._runner import run_app
    from multiverso_tpu_torch.telemetry import alerts, flight

    seen = {}

    def body(_):
        seen["engine"] = alerts.engine() is not None
        seen["watchdog"] = flight._monitor is not None
        return 0

    assert run_app(body, ["-platform=cpu"]) == 0
    assert seen == {"engine": True, "watchdog": True}
    assert alerts.engine() is None and flight._monitor is None
    assert run_app(body, ["-platform=cpu", "-telemetry_alerts=false",
                          "-telemetry_flight=false"]) == 0
    assert seen == {"engine": False, "watchdog": False}
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        run_app(body, ["-platform=cpu", "-telemetry_profile=true"])


def test_importing_the_fleet_loads_no_jax():
    """The fleet, its CLIs and the telemetry they act on import nothing
    of jax or the JAX package."""
    mods = ["multiverso_tpu_torch.fleet", "multiverso_tpu_torch.fleet.chaos",
            "multiverso_tpu_torch.fleet.ps_fleet",
            "multiverso_tpu_torch.apps.fleet_main",
            "multiverso_tpu_torch.apps.fleet_top",
            "multiverso_tpu_torch.telemetry.alerts",
            "multiverso_tpu_torch.telemetry.timeseries",
            "multiverso_tpu_torch.telemetry.flight"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'multiverso_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
