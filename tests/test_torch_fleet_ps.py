"""The port's supervised PS topology (``fleet/ps_fleet.py``) on the CPU,
and the seat harness that ``chip_smoke.py`` phases 10 and 13 drive.

Seats bind ephemeral ports and announce them in their addr files; every
address a client or a sibling seat uses comes from those announcements
(ROADMAP C10: a harness that picked free ports and closed them before
the seats bound them could lose a port to another process, and a
SIGKILLed seat rebinding its old port could too). Each test that spawns
seats has its own deadline and stops every seat in ``finally``.
"""

import signal
import time

import numpy as np
import pytest

import _torch_port

torch = ps_fleet = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, ps_fleet
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.fleet import ps_fleet


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


def test_seat_peers_ask_for_an_ephemeral_port():
    """A seat's own -ps_peers entry asks for port 0 (it binds an
    ephemeral one and announces it); a sibling not announced yet is the
    placeholder, an announced one its announced address."""
    known = [("10.0.0.1", 5000), None, ("10.0.0.3", 7000)]
    assert ps_fleet.seat_peers(1, known) == \
        "10.0.0.1:5000,127.0.0.1:0,10.0.0.3:7000"
    assert ps_fleet.seat_peers(0, known) == \
        "127.0.0.1:0,127.0.0.1:1,10.0.0.3:7000"
    assert ps_fleet.PLACEHOLDER == ("127.0.0.1", 1)


def test_read_addr(tmp_path):
    path = str(tmp_path / "seat.addr")
    assert ps_fleet.read_addr(path) is None
    with open(path, "w") as f:
        f.write("127.0.0.1:4242")
    assert ps_fleet.read_addr(path) == ("127.0.0.1", 4242)
    with open(path, "w") as f:
        f.write("garbage")
    assert ps_fleet.read_addr(path) is None


def test_seat_harness_takes_its_ports_only_from_the_announcements(
        monkeypatch):
    """ROADMAP C10's witness: phase 10's row plane with ``free_ports``
    unavailable still runs (it never picks a port), every address its C
    client dialled is one a seat announced (no placeholder, no port 0),
    seat 0 keeps its address, and the respawned seat 1 is dialled at the
    address it announced after the respawn."""
    import chip_smoke

    def no_free_ports(n):
        raise AssertionError("the seat harness must not pick ports")

    monkeypatch.setattr(chip_smoke, "free_ports", no_free_ports)
    out = chip_smoke.ps_row_plane(1, rows=4_000, cols=4, n_ids=500,
                                  n_adds=2, seat_args=["-serve_device=cpu"])
    assert out["bitwise"] and out["recovery"]["applied"] == 4
    first, after = out["addresses"][0], out["addresses"][-1]
    for peers in out["addresses"]:
        assert len(peers) == 2
        for host, port in peers:
            assert host == "127.0.0.1" and port not in (0, 1)
    assert after[0] == first[0]


def test_ps_fleet_seat_killed_and_replayed_bitwise_on_the_cpu():
    """``chip_smoke.py`` phase 13 (d) at a small size on the CPU: two
    supervised seats of a ``use_pallas`` sgd table and a default one,
    Adds from the C client around a checkpoint, seat 1 SIGKILLed and
    respawned by the supervisor through its checkpoint and WAL, every
    shard bitwise the CPU replay."""
    import chip_smoke
    out = chip_smoke.ps_fleet_plane(2, rows=8_000, cols=4, n_ids=800,
                                    n_adds=2, ckpt_s=1.5, device="cpu")
    assert out["recovery"]["applied"] > 0
    assert out["status"]["supervisor"]["respawns"] >= 1
    assert {k.split(" run")[0] for k in out["seat_launches"]} == \
        {"seat 0", "seat 1"}


def test_ps_fleet_client_seat_survives_a_killed_shard(tmp_path):
    """The JAX topology: this process holds rank 0 and the client seat,
    two WAL'd seats hold ranks 1 and 2. A seat SIGKILLed between Adds is
    respawned by the supervisor; the client's next Add parks until the
    replacement announces, and every acked Add is in the table exactly
    once."""
    import multiverso_tpu_torch as mvt

    mvt.init(["-platform=cpu"])
    fleet = ps_fleet.PSShardFleet(
        2, table_id=950, table_size=96, workdir=str(tmp_path),
        log_dir=str(tmp_path), device="cpu", checkpoint_every_s=0.5,
        cooldown_s=0.2, poll_s=0.05)
    try:
        fleet.start(bringup_timeout_s=120.0)
        assert fleet.ranks == [1, 2]
        rng = np.random.default_rng(3)
        acked = np.zeros(96, np.float32)
        for step in range(6):
            delta = rng.integers(1, 5, size=96).astype(np.float32)
            fleet.table.add(delta)
            acked += delta
            if step == 2:
                fleet.kill(2, signal.SIGKILL)
        assert fleet.wait_converged(120.0)
        assert np.asarray(fleet.table.get()).tobytes() == acked.tobytes()
        status = fleet.status()
        assert status["supervisor"]["respawns"] >= 1, status
        assert fleet.seat_line(2, "PS_SHARD_RECOVERY") is not None
    finally:
        fleet.close()
        mvt.shutdown()
    assert all(fleet.handle(r) is None for r in (1, 2))


def test_chaos_round_over_the_ps_fleet_loses_no_acked_add(tmp_path):
    """One seeded chaos round (SIGKILL or SIGSTOP of any subset of the
    seats) while this process's client seat keeps adding: the fleet
    converges back to full membership and every acked Add is in the
    table exactly once."""
    import threading

    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.fleet.chaos import ChaosEngine

    mvt.init(["-platform=cpu"])
    fleet = ps_fleet.PSShardFleet(
        2, table_id=960, table_size=64, workdir=str(tmp_path),
        log_dir=str(tmp_path), device="cpu", checkpoint_every_s=0.5,
        cooldown_s=0.2, poll_s=0.05)
    acked = np.zeros(64, np.float32)
    errors, stop = [], threading.Event()

    def writer():
        rng = np.random.default_rng(5)
        while not stop.is_set():
            delta = rng.integers(1, 5, size=64).astype(np.float32)
            try:
                fleet.table.add(delta)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)
                return
            acked[:] += delta
            time.sleep(0.01)

    t = threading.Thread(target=writer, daemon=True)
    try:
        fleet.start(bringup_timeout_s=120.0)
        eng = ChaosEngine(seed=11, kinds=("kill", "pause"),
                          max_pause_s=0.5)
        for rank in fleet.ranks:
            eng.register_kill(f"ps-{rank}",
                              lambda sig, r=rank: fleet.kill(r, sig))
        t.start()
        applied = eng.run_round(eng.plan_round(window_s=0.5))
        assert applied
        assert fleet.wait_converged(120.0), fleet.status()
        time.sleep(0.3)
        stop.set()
        t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        assert np.asarray(fleet.table.get()).tobytes() == acked.tobytes()
    finally:
        stop.set()
        fleet.close()
        mvt.shutdown()


def test_service_close_leaves_no_thread_running():
    """ROADMAP C10's second witness: ``PSService.close`` ends its IO,
    dispatch and directory-registration threads (one still retrying a
    peer that never came up) and ``PeerClient.close`` its reader, so a
    seat's interpreter finalizes with no daemon thread of theirs running
    (such a thread could abort a seat's orderly exit with SIGABRT)."""
    from multiverso_tpu_torch.parallel.ps_service import (PeerClient,
                                                          PSService)

    peer = PSService()
    svc = PSService()
    try:
        svc.enable_directory(0, [("127.0.0.1", 0), ps_fleet.PLACEHOLDER,
                                 peer.address])
        client = PeerClient(*peer.address)
        assert client._reader.is_alive()
        threads = [svc._io_thread, svc._dispatch_thread, *svc._reg_threads]
        assert len(threads) == 4 and all(t.is_alive() for t in threads[:2])
        t0 = time.monotonic()
        client.close()
        svc.close()
        assert time.monotonic() - t0 < 15.0
        assert not client._reader.is_alive()
        assert not any(t.is_alive() for t in threads)
    finally:
        peer.close()
