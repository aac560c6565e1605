"""Chaos fuzz for the port's elastic PS path and fleet: the non-slow
cases of ``tests/test_elastic_fuzz.py`` run against
``multiverso_tpu_torch`` on the CPU.

The targeted drills (tests/test_ps_robustness.py, the app drills in
test_distributed_word2vec.py) each prove ONE failure scenario; this fuzz
sweeps many: server seats go down in random order at random times
(orderly close with a shard checkpoint — the reference's recovery story,
``table_interface.h:61-75``) and come back at NEW addresses, while a
client hammers adds and gets throughout. Invariant: no client op ever
fails, and the final table value equals the sum of every acknowledged
add exactly once — retries through the replicated directory plus the
server's exactly-once caches must never drop or double-apply a delta.
"""

import os
import tempfile
import threading
import time

import numpy as np
import pytest

import _torch_port

torch = None
ckpt = DistributedArrayTable = PSService = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, ckpt, DistributedArrayTable, PSService
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.core import checkpoint as ckpt
    from multiverso_tpu_torch.parallel.ps_service import (DistributedArrayTable
                                                          , PSService)


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



SIZE = 60          # 3 shards x 20
TABLE = 400


def _seat(rank, peers, restore_uri=None):
    """Restart protocol: restore the shard FIRST, announce to the
    directory SECOND (announce=False + enable_directory) — announcing
    early would let a peer's retried add land on the fresh shard and be
    overwritten by the restore (an acked-write loss this fuzz caught)."""
    svc = PSService()
    peers = list(peers)
    peers[rank] = svc.address
    table = DistributedArrayTable(TABLE, SIZE, svc, peers, rank=rank,
                                  announce=False)
    if restore_uri:
        ckpt.load_table(table, restore_uri)
    svc.enable_directory(rank, peers)
    return svc, table, peers


def test_supervisor_kill_respawn_fuzz(port_env):
    """Kill-respawn chaos over the SUPERVISOR: an
    in-process fleet of serving replicas under a ReplicaSupervisor; a
    seeded schedule abruptly kills random victims at random times (no
    leave, no drain — heartbeats just stop, exactly a SIGKILL's shape).
    Invariants: the fleet converges back to FULL membership after every
    round, every respawn is supervisor-driven (counted + event-logged),
    lookups answer correct bytes at the end, and no monitored daemon
    loop wedged (watchdog trips 0)."""
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.fleet import (FleetClient, FleetRouter,
                                      FleetMember, LocalFleetView,
                                      ReplicaSupervisor)
    from multiverso_tpu_torch.serving import ServingService, SparseLookupRunner
    from multiverso_tpu_torch.telemetry import get_registry
    from multiverso_tpu_torch.telemetry.flight import start_watchdog

    start_watchdog()
    trips0 = get_registry().counter("telemetry.watchdog.trips").value
    ROWS, COLS, N = 256, 8, 3
    rng = np.random.default_rng(42)
    data = np.random.default_rng(0).normal(
        size=(ROWS, COLS)).astype(np.float32)
    router = FleetRouter(heartbeat_ms=40.0, liveness_misses=4)

    class InProcReplica:
        """Supervisor handle over an in-process service+member pair."""

        def __init__(self, slot: int):
            store = ServerStore(f"fuzz_t{slot}", (ROWS, COLS), np.float32,
                                get_updater(np.float32, "default"),
                                torch.device("cpu"), num_workers=1,
                                init_array=data.copy())
            self.service = ServingService()
            self.service.register_runner(SparseLookupRunner(store),
                                         buckets=(4, 8), max_batch=4,
                                         max_wait_ms=1.0)
            self.service.warmup()
            self.member = FleetMember(router.address, self.service,
                                      member_id=f"replica-{slot}").start()
            self.dead = False

        def poll(self):
            return 1 if self.dead else None

        def kill_abruptly(self):
            """SIGKILL shape: heartbeats stop mid-cadence, no goodbye."""
            self.dead = True
            self.member._stop.set()
            self.member._close_sock()
            self.service.close()

        def terminate(self):
            self.dead = True
            self.member.close()
            self.service.close()

    sup = ReplicaSupervisor(LocalFleetView(router), InProcReplica,
                            min_replicas=N, max_replicas=N,
                            cooldown_s=0.5, poll_s=0.05,
                            join_grace_s=20.0)
    replicas = {i: InProcReplica(i) for i in range(N)}
    for i, r in replicas.items():
        sup.adopt(i, r)

    def await_members(n, deadline_s):
        deadline = time.monotonic() + deadline_s
        while len(router.group.member_ids()) != n:
            assert time.monotonic() < deadline, \
                (f"fleet never converged to {n} members; have "
                 f"{router.group.member_ids()}; events {sup.events()}")
            time.sleep(0.02)

    await_members(N, 20)
    sup.start()
    cli = FleetClient(router.address, refresh_s=0.05, hedge="off")
    try:
        kills = 0
        for round_i in range(4):
            victims = {int(rng.integers(0, N))}
            if rng.random() < 0.4:          # sometimes a double kill
                victims.add(int(rng.integers(0, N)))
            time.sleep(float(rng.random() * 0.3))
            for v in victims:
                sup.slots()[v].kill_abruptly()
                kills += 1
            # Convergence: sweep reaps the corpses, the supervisor
            # respawns the slots (counted), fresh members warm + rejoin.
            deadline = time.monotonic() + 60
            while sup.status()["respawns"] < kills:
                assert time.monotonic() < deadline, \
                    (f"supervisor never respawned round {round_i} "
                     f"victims {victims}: {sup.status()}")
                time.sleep(0.02)
            await_members(N, 60)
        status = sup.status()
        assert status["respawns"] >= kills, status
        assert sorted(status["slots"]) == list(range(N))
        respawn_events = [e for e in status["events"]
                          if e["kind"] == "respawn"]
        assert {e["trigger"] for e in respawn_events} <= \
            {"process_exit", "heartbeat_loss", "missing_timeout"}
        # The healed fleet still serves correct bytes from every owner.
        for _ in range(8):
            rows = rng.integers(0, ROWS, 4).astype(np.int32)
            got = cli.lookup(rows, deadline_ms=10_000, timeout=30)
            np.testing.assert_array_equal(got, data[rows])
        trips = get_registry().counter("telemetry.watchdog.trips").value
        assert trips == trips0, "a daemon loop wedged during the chaos"
    finally:
        cli.close()
        sup.stop()
        for handle in sup.slots().values():
            handle.terminate()
        router.close()


def test_elastic_membership_join_leave_fuzz(port_env):
    """Elastic clock-group fuzz: a live BSP group
    under a seeded schedule of joins, graceful leaves, and SIGKILL-shaped
    silent deaths — including one that dies BETWEEN acquire_add and
    commit_add, the worst point (an in-flight add that would wedge every
    peer's get gate forever without the quorum fallback's cleanup).
    Invariants: no surviving worker's op ever fails, every silent death
    is evicted by the quorum fallback (counted exactly), the group
    re-forms and keeps making progress after every event, freed slots
    are reused by later joins, and no monitored daemon loop wedged."""
    from multiverso_tpu_torch.core.sync_coordinator import SyncCoordinator
    from multiverso_tpu_torch.telemetry import get_registry
    from multiverso_tpu_torch.telemetry.flight import start_watchdog

    start_watchdog()
    trips0 = get_registry().counter("telemetry.watchdog.trips").value
    rng = np.random.default_rng(16)
    sc = SyncCoordinator(3, name="fuzz16", leave_timeout_s=0.4)

    stop = threading.Event()
    errors = []
    rounds = {}
    mu = threading.Lock()
    silent = {}        # wid -> "boundary" | "inflight" (simulated SIGKILL)
    departing = set()  # wid -> graceful leave requested

    def worker(wid):
        rounds[wid] = 0
        try:
            while not stop.is_set():
                with mu:
                    if silent.get(wid) == "boundary":
                        return          # vanish: no leave, no finish
                    if wid in departing:
                        sc.leave(wid)   # orderly goodbye, slot freed
                        return
                sc.acquire_add(wid, timeout=30.0)
                with mu:
                    if silent.get(wid) == "inflight":
                        return          # die holding an in-flight add
                sc.commit_add(wid)
                sc.acquire_get(wid, timeout=30.0)
                sc.commit_get(wid)
                rounds[wid] += 1
                time.sleep(0.001)
            sc.finish_train(wid)        # test teardown: retire cleanly
        except Exception as e:  # noqa: BLE001 - the invariant
            errors.append((wid, e))

    threads = {}

    def spawn(wid):
        t = threading.Thread(target=worker, args=(wid,), daemon=True)
        threads[wid] = t
        t.start()

    def await_world(n, deadline_s=20.0):
        deadline = time.monotonic() + deadline_s
        while sc.status()["world"] != n:
            assert time.monotonic() < deadline, \
                f"group never re-formed to {n}: {sc.status()}, {errors}"
            time.sleep(0.01)

    def await_progress(deadline_s=20.0):
        with mu:
            base = dict(rounds)
        live = sc.status()["active"]
        deadline = time.monotonic() + deadline_s
        while any(rounds.get(w, 0) <= base.get(w, 0) for w in live):
            assert time.monotonic() < deadline, \
                f"surviving quorum stalled: {rounds} vs {base}, {errors}"
            time.sleep(0.01)

    live = {0, 1, 2}
    for w in live:
        spawn(w)
    kills = leaves = joins = 0
    # Seeded schedule: every event class fires, order fixed, victims
    # random. "kill" alternates the death point so both the clean
    # round-boundary death and the in-flight-add death are exercised.
    try:
        for i, event in enumerate(
                ["join", "kill", "leave", "join", "kill", "join"]):
            time.sleep(float(rng.random() * 0.1))
            if event == "join":
                w = sc.join(timeout=30.0)
                with mu:
                    # The slot id may be a reused corpse's: a stale kill
                    # flag must not shoot the fresh tenant.
                    silent.pop(w, None)
                    departing.discard(w)
                live.add(w)
                spawn(w)
                joins += 1
                await_world(len(live))
            elif event == "kill":
                victim = int(rng.choice(sorted(live)))
                point = "inflight" if kills % 2 else "boundary"
                with mu:
                    silent[victim] = point
                live.discard(victim)
                kills += 1
                threads[victim].join(timeout=30)
                assert not threads[victim].is_alive()
                # The survivors' stalled gates must evict the corpse.
                await_world(len(live))
            else:
                victim = int(rng.choice(sorted(live)))
                with mu:
                    departing.add(victim)
                live.discard(victim)
                leaves += 1
                threads[victim].join(timeout=30)
                assert not threads[victim].is_alive()
                await_world(len(live))
            await_progress()
    finally:
        stop.set()
        for t in threads.values():
            t.join(timeout=60)
    assert not errors, f"surviving worker op failed: {errors}"

    status = sc.status()
    assert status["quorum_evictions"] == kills, status
    # Every membership change bumped the version exactly once.
    assert status["version"] == kills + leaves + joins, status
    # Slot reuse: freed slots (2 kills + 1 leave) cover the later joins,
    # so the slot table never grows past the peak concurrent world.
    assert status["slots"] <= 4, status
    trips = get_registry().counter("telemetry.watchdog.trips").value
    assert trips == trips0, "a daemon loop wedged during the chaos"


def test_restart_restore_before_announce_keeps_acked_writes(port_env,
                                                            tmp_path):
    """The acked-write-loss race the fuzz caught, pinned deterministically:
    while a seat is down, a peer's add sits in the directory-retry loop.
    If the restarted seat announced BEFORE restoring, that add could land
    on the fresh shard and be overwritten by the restore. With
    announce=False + restore + enable_directory, the un-announced seat is
    unreachable until its state is back, so the acked add survives."""
    import time as _time

    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    t0 = DistributedArrayTable(90, 40, svc0, peers, rank=0)
    t1 = DistributedArrayTable(90, 40, svc1, peers, rank=1)
    t0.add(np.full(40, 2.0, dtype=np.float32))
    uri = f"file://{tmp_path}/seat1.npz"
    ckpt.save_table(t1, uri)
    svc1.close()

    done = []

    def bg_add():
        t0.add(np.ones(40, dtype=np.float32))   # retries until reachable
        done.append(True)

    th = threading.Thread(target=bg_add)
    th.start()
    _time.sleep(1.0)                 # the add is now in the retry loop
    svc1b = PSService()
    peers2 = [peers[0], svc1b.address]
    t1b = DistributedArrayTable(90, 40, svc1b, peers2, rank=1,
                                announce=False)
    ckpt.load_table(t1b, uri)
    _time.sleep(1.0)
    assert not done, "un-announced seat must not be discoverable"
    svc1b.enable_directory(1, peers2)
    th.join(timeout=30)
    assert done, "add never landed after announce"
    np.testing.assert_allclose(t0.get(), 3.0)   # baseline 2 + acked 1
    np.testing.assert_allclose(t1b.get(), 3.0)
    svc1b.close()
    svc0.close()
