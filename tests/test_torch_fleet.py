"""The port's fleet layer on the CPU: the cases of
``tests/test_fleet.py`` run against ``multiverso_tpu_torch.fleet``.

HashRing ownership-stability property tests (adding one replica to N
moves <= ~1/(N+1) of keys; removal reassigns ONLY the removed replica's
keys), hedge-cancellation semantics (losing reply discarded, ``on_done``
fires exactly once), plus the membership/drain/failover machinery end to
end with real sockets over two in-process replicas serving a
``ServerStore`` on the CPU, the wire cancel and the stats rollup —
everything in one process so the suite stays fast. The parity of the
pure pieces with the JAX package is in
``tests/test_torch_fleet_parity.py``.
"""

import threading
import time

import numpy as np
import pytest

import _torch_port

torch = None
AdaptiveDelay = FleetClient = FleetMember = None
FleetRouter = HashRing = HedgedCall = ReplicaGroup = None
health_score = HedgeBudget = HedgeScheduler = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, AdaptiveDelay, FleetClient, FleetMember, FleetRouter
    global HashRing, HedgedCall, ReplicaGroup, health_score, HedgeBudget
    global HedgeScheduler
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.fleet import (AdaptiveDelay, FleetClient,
                                            FleetMember, FleetRouter, HashRing,
                                            HedgedCall, ReplicaGroup,
                                            health_score)
    from multiverso_tpu_torch.fleet.hedge import (HedgeBudget, HedgeScheduler)


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



KEYS = np.arange(20_000, dtype=np.int64)


def _owners(ring, keys=KEYS):
    members = ring.members
    return [members[i] for i in ring.owner_indices(keys)]


# ---------------------------------------------------------------------------
# HashRing properties
# ---------------------------------------------------------------------------
def test_ring_deterministic_across_instances():
    a = HashRing(["r2", "r0", "r1"])
    b = HashRing(["r0", "r1", "r2"])     # order must not matter
    assert _owners(a) == _owners(b)


def test_ring_balance_reasonable():
    ring = HashRing([f"r{i}" for i in range(5)])
    counts = np.bincount(ring.owner_indices(KEYS), minlength=5)
    assert counts.min() > 0.5 * KEYS.size / 5
    assert counts.max() < 1.6 * KEYS.size / 5


@pytest.mark.parametrize("n", [2, 4, 7])
def test_ring_add_moves_about_one_over_n_plus_one(n):
    before = HashRing([f"r{i}" for i in range(n)])
    after = HashRing([f"r{i}" for i in range(n + 1)])
    own_b, own_a = _owners(before), _owners(after)
    moved = sum(1 for x, y in zip(own_b, own_a) if x != y)
    ideal = KEYS.size / (n + 1)
    # Minimal movement: within 1.6x of the consistent-hashing ideal —
    # contiguous-offset routing would move ~half the keyspace.
    assert moved < 1.6 * ideal, (moved, ideal)
    # ...and every moved key moved TO the new member, nowhere else.
    new = f"r{n}"
    assert all(y == new for x, y in zip(own_b, own_a) if x != y)


def test_ring_removal_reassigns_only_the_removed_members_keys():
    members = [f"r{i}" for i in range(5)]
    full = HashRing(members)
    own_full = _owners(full)
    reduced = HashRing(members)
    assert reduced.remove("r2")
    own_red = _owners(reduced)
    for x, y in zip(own_full, own_red):
        if x != "r2":
            assert y == x          # survivor keys never move
        else:
            assert y != "r2"       # orphaned keys all found a new home


def test_ring_partition_covers_all_positions():
    ring = HashRing(["a", "b", "c"])
    parts = ring.partition(KEYS[:999])
    got = np.sort(np.concatenate(list(parts.values())))
    np.testing.assert_array_equal(got, np.arange(999))


def test_ring_membership_api():
    ring = HashRing()
    assert ring.add("x") and not ring.add("x")
    assert "x" in ring and len(ring) == 1
    assert ring.remove("x") and not ring.remove("x")


# ---------------------------------------------------------------------------
# Hedging: exactly-once, discard, failover, budget
# ---------------------------------------------------------------------------
def _async_attempt(delay_s, result):
    def attempt(deliver):
        t = threading.Timer(delay_s, deliver, args=(result,))
        t.daemon = True
        t.start()
    return attempt


def test_hedge_loser_discarded_on_done_fires_exactly_once():
    sched = HedgeScheduler()
    done = []
    call = HedgedCall([_async_attempt(0.2, "slow-primary"),
                       _async_attempt(0.01, "fast-hedge")],
                      done.append, delay_ms=20, scheduler=sched)
    call.launch()
    time.sleep(0.4)                # both replies have landed by now
    assert done == ["fast-hedge"]  # hedge won; loser discarded, one fire
    sched.close()


def test_hedge_primary_wins_when_fast():
    sched = HedgeScheduler()
    done = []
    HedgedCall([_async_attempt(0.01, "primary"),
                _async_attempt(0.01, "hedge")],
               done.append, delay_ms=150, scheduler=sched).launch()
    time.sleep(0.3)
    assert done == ["primary"]
    sched.close()


def test_hedge_sync_raise_fails_over_immediately():
    sched = HedgeScheduler()
    done = []

    def dead(deliver):
        raise OSError("connect refused")

    t0 = time.monotonic()
    HedgedCall([dead, _async_attempt(0.01, "backup")], done.append,
               delay_ms=10_000, scheduler=sched).launch()
    time.sleep(0.3)
    assert done == ["backup"]
    assert time.monotonic() - t0 < 5  # did not wait for the hedge timer
    sched.close()


def test_hedge_all_attempts_fail_delivers_last_error():
    sched = HedgeScheduler()
    done = []
    err = OSError("boom")
    HedgedCall([_async_attempt(0.01, OSError("first")),
                _async_attempt(0.01, err)],
               done.append, delay_ms=5, scheduler=sched).launch()
    time.sleep(0.4)
    assert len(done) == 1 and isinstance(done[0], OSError)
    sched.close()


def test_hedge_budget_suppresses_when_dry():
    budget = HedgeBudget(ratio=0.0, burst=0.0)    # never allows a hedge
    sched = HedgeScheduler()
    done = []
    HedgedCall([_async_attempt(0.15, "slow-primary"),
                _async_attempt(0.01, "hedge")],
               done.append, delay_ms=10, scheduler=sched,
               allow_hedge=budget.try_spend).launch()
    time.sleep(0.4)
    assert done == ["slow-primary"]   # hedge never fired: primary answered
    sched.close()


def test_hedge_budget_token_arithmetic():
    budget = HedgeBudget(ratio=0.5, burst=1.0)
    assert budget.try_spend()          # starts with the burst
    assert not budget.try_spend()      # dry
    budget.on_request()
    assert not budget.try_spend()      # 0.5 tokens: still dry
    budget.on_request()
    assert budget.try_spend()          # 1.0 tokens: one hedge


def test_adaptive_delay_tracks_p95():
    d = AdaptiveDelay(floor_ms=1.0, ceil_ms=500.0, initial_ms=25.0,
                      min_samples=10)
    assert d.delay_ms() == 25.0        # no data yet
    for _ in range(64):
        d.observe(10.0)
    assert 10.0 <= d.delay_ms() <= 20.0   # ~1.25 * p95


# ---------------------------------------------------------------------------
# Health + membership state machine (no sockets)
# ---------------------------------------------------------------------------
def test_health_score_shape():
    idle = health_score({"queue_depth": 0, "inflight": 0,
                         "max_queue": 64, "max_batch": 8,
                         "replica_step": 5}, fleet_max_step=5)
    busy = health_score({"queue_depth": 64, "inflight": 8,
                         "max_queue": 64, "max_batch": 8,
                         "replica_step": 5}, fleet_max_step=5)
    stale = health_score({"queue_depth": 0, "inflight": 0,
                          "max_queue": 64, "max_batch": 8,
                          "replica_step": 1}, fleet_max_step=5)
    draining = health_score({"draining": 1.0}, fleet_max_step=5)
    assert idle == 1.0
    assert 0.0 < busy < idle
    assert 0.0 < stale < idle
    assert draining == 0.0


def test_health_score_sees_pipeline_occupancy():
    """A pipelined replica with an EMPTY admission queue but a full
    dispatch window must not look idle to the router — window occupancy
    is load one stage past the queue."""
    base = {"queue_depth": 0, "inflight": 0, "max_queue": 64,
            "max_batch": 8, "replica_step": 5}
    idle = health_score({**base, "pipeline_inflight": 0,
                         "pipeline_depth": 3}, fleet_max_step=5)
    full_window = health_score({**base, "pipeline_inflight": 3,
                                "pipeline_depth": 3}, fleet_max_step=5)
    half_window = health_score({**base, "pipeline_inflight": 1.5,
                                "pipeline_depth": 3}, fleet_max_step=5)
    assert idle == 1.0
    assert 0.0 < full_window < half_window < idle
    # a full window weighs like a full admission queue (both normalize
    # to load 1.0)
    full_queue = health_score({**base, "queue_depth": 64},
                              fleet_max_step=5)
    assert abs(full_window - full_queue) < 1e-9
    # NO double counting: in pipelined mode serve.inflight counts the
    # SAME window requests, so a realistic saturated pipelined member
    # (inflight = depth * max_batch AND occupancy = depth) must score
    # exactly like a saturated serialized one (inflight = max_batch) —
    # otherwise the router drifts away from the faster path.
    pipelined_sat = health_score({**base, "inflight": 24,
                                  "pipeline_inflight": 3,
                                  "pipeline_depth": 3}, fleet_max_step=5)
    serial_sat = health_score({**base, "inflight": 8}, fleet_max_step=5)
    assert abs(pipelined_sat - serial_sat) < 1e-9
    # pre-pipeline members (no depth field) are unaffected
    legacy = health_score(base, fleet_max_step=5)
    assert legacy == 1.0


def test_replica_group_join_heartbeat_sweep():
    group = ReplicaGroup(heartbeat_ms=20.0, liveness_misses=3)
    reply = group.join("a", "127.0.0.1", 1111)
    assert reply["ok"] and reply["heartbeat_ms"] == 20.0
    group.join("b", "127.0.0.1", 2222)
    v0 = group.version
    assert group.member_ids() == ["a", "b"]
    assert sorted(group.ring.members) == ["a", "b"]
    # heartbeat for an unknown member asks it to rejoin
    assert group.heartbeat("ghost", {})["directive"] == "rejoin"
    # a drain directive is delivered exactly once
    group.drain("a")
    assert group.heartbeat("a", {})["directive"] == "drain"
    assert group.heartbeat("a", {})["directive"] == "none"
    # draining=1 removes from the ring, rejoin restores it
    group.heartbeat("a", {"draining": 1.0})
    assert group.ring.members == ("b",)
    group.heartbeat("a", {"draining": 0.0, "drains_completed": 1.0})
    assert sorted(group.ring.members) == ["a", "b"]
    assert group.drains_completed("a") == 1
    assert group.version > v0
    # b stops heartbeating -> swept after the liveness horizon
    deadline = time.monotonic() + 5
    dead = []
    while time.monotonic() < deadline and not dead:
        group.heartbeat("a", {})
        dead = group.sweep()
        time.sleep(0.02)
    assert dead == ["b"]
    assert group.member_ids() == ["a"]


def test_routing_payload_health_ranking():
    group = ReplicaGroup(heartbeat_ms=50.0)
    group.join("busy", "h", 1)
    group.join("idle", "h", 2)
    group.heartbeat("busy", {"queue_depth": 64, "inflight": 8,
                             "max_queue": 64, "max_batch": 8})
    group.heartbeat("idle", {"queue_depth": 0, "inflight": 0,
                             "max_queue": 64, "max_batch": 8})
    payload = group.routing_payload()
    by_id = {m["id"]: m for m in payload["members"]}
    assert by_id["idle"]["health"] > by_id["busy"]["health"]
    from multiverso_tpu_torch.fleet import RoutingTable
    table = RoutingTable(payload)
    assert table.ranked()[0] == "idle"
    assert table.ranked(exclude=("idle",)) == ["busy"]


def test_json_blob_codec_roundtrip():
    from multiverso_tpu_torch.parallel.net import (pack_json_blob,
                                                   unpack_json_blob)
    obj = {"id": "r0", "stats": {"queue_depth": 3.0}, "list": [1, 2]}
    assert unpack_json_blob(pack_json_blob(obj)) == obj
    with pytest.raises(IOError):
        unpack_json_blob(np.frombuffer(b"not json", dtype=np.uint8))


# ---------------------------------------------------------------------------
# In-process fleet integration over real sockets
# ---------------------------------------------------------------------------
ROWS, COLS = 512, 8


@pytest.fixture
def fleet_env(port_env):
    """Router + two serving replicas (same seeded table, on the CPU) +
    members."""
    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.serving import (ServingService,
                                              SparseLookupRunner)

    rng = np.random.default_rng(0)
    data = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    services, members = [], []
    router = FleetRouter(heartbeat_ms=40.0, liveness_misses=5, proxy=True)
    for i in range(2):
        store = ServerStore(f"fleet_t{i}", (ROWS, COLS), np.float32,
                            get_updater(np.float32, "default"),
                            torch.device("cpu"), num_workers=1,
                            init_array=data.copy())
        svc = ServingService()
        svc.register_runner(SparseLookupRunner(store), buckets=(4, 8),
                            max_batch=4, max_wait_ms=1.0)
        svc.warmup()
        services.append(svc)
        members.append(FleetMember(router.address, svc,
                                   member_id=f"r{i}").start())
    deadline = time.monotonic() + 20
    while len(router.group.member_ids()) < 2:
        assert time.monotonic() < deadline, "members never joined"
        time.sleep(0.02)
    yield router, services, members, data
    for m in members:
        m.close()
    for s in services:
        s.close()
    router.close()


def test_fleet_client_lookup_parity(fleet_env):
    router, services, members, data = fleet_env
    cli = FleetClient(router.address)
    try:
        rows = np.asarray([3, 481, 77, 0, 511], np.int32)
        got = cli.lookup(rows, deadline_ms=10_000, timeout=30)
        np.testing.assert_array_equal(got, data[rows])
        got = cli.lookup(rows, deadline_ms=10_000, split=True, timeout=30)
        np.testing.assert_array_equal(got, data[rows])
        # empty lookup keeps the real column shape
        got = cli.lookup(np.zeros(0, np.int32), deadline_ms=10_000,
                         timeout=30)
        assert got.shape == (0, COLS)
    finally:
        cli.close()


def test_fleet_hot_key_replicated_reads_bitwise_fresh(fleet_env):
    """E2E leg-1 witness (docs/DESIGN.md "Skew actuation"): replicate a
    hot row set, round-robin the reads across its replicas, and every
    reply is bitwise the table row — replication changes WHO serves a
    hot key, never WHAT is served."""
    router, services, members, data = fleet_env
    rows = np.asarray([3, 77], np.int32)
    ring = router.group.ring
    router.group.set_hot_keys(
        {int(r): ring.replica_set(int(r), 2) for r in rows})
    cli = FleetClient(router.address, hedge="off", refresh_s=0.05,
                      hot_staleness=1.0)
    try:
        deadline = time.monotonic() + 10.0
        while not cli.routing().hot_replicas:
            assert time.monotonic() < deadline, "hot keys never shipped"
            time.sleep(0.05)
        assert set(cli.routing().hot_replicas) == {int(r) for r in rows}
        from multiverso_tpu_torch.telemetry import counter
        routed = counter("fleet.hotkey.routed")
        base = routed.value
        for _ in range(6):
            got = cli.lookup(rows, deadline_ms=10_000, timeout=30)
            np.testing.assert_array_equal(got, data[rows])
        assert routed.value - base == 6
    finally:
        cli.close()


def test_fleet_router_proxy_serves_plain_clients(fleet_env):
    router, services, members, data = fleet_env
    from multiverso_tpu_torch.serving import ServingClient
    pc = ServingClient(*router.address)
    try:
        rows = np.asarray([1, 500, 42], np.int32)
        got = pc.lookup(rows, deadline_ms=10_000, timeout=30)
        np.testing.assert_array_equal(got, data[rows])
    finally:
        pc.close()


def test_fleet_rolling_drain_zero_drops_under_load(fleet_env):
    router, services, members, data = fleet_env
    cli = FleetClient(router.address, refresh_s=0.05)
    errors = []
    stop = threading.Event()

    def loader():
        rng = np.random.default_rng(3)
        while not stop.is_set():
            rows = rng.integers(0, ROWS, 4).astype(np.int32)
            try:
                got = cli.lookup(rows, deadline_ms=10_000, timeout=30)
                np.testing.assert_array_equal(got, data[rows])
            except Exception as e:  # noqa: BLE001 - the assertion below
                errors.append(e)    # reports every failure mode at once
    t = threading.Thread(target=loader, daemon=True)
    t.start()
    try:
        assert router.rolling_drain(timeout_s_per_member=30)
        time.sleep(0.2)
    finally:
        stop.set()
        t.join(timeout=10)
        cli.close()
    assert not errors, errors[:3]
    # both members completed a full drain cycle
    for mid in ("r0", "r1"):
        assert router.group.drains_completed(mid) == 1


def test_fleet_wire_drain_trigger(fleet_env):
    """Operator path: Fleet_Drain over the wire starts a rolling drain;
    completion is observable via the routing table's per-member
    monotonic drains_completed."""
    router, services, members, data = fleet_env
    from multiverso_tpu_torch.fleet import request_drain
    ack = request_drain(router.address)
    assert ack["started"] and ack["rolling"]
    assert sorted(ack["members"]) == ["r0", "r1"]
    deadline = time.monotonic() + 30
    cli = FleetClient(router.address, refresh_s=0.05)
    try:
        while time.monotonic() < deadline:
            table = {m["id"]: m for m in cli.refresh().members}
            if all(m.get("drains_completed", 0) >= 1
                   and not m.get("draining") for m in table.values()):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("wire-triggered rolling drain never "
                                 "completed")
        # unknown member is refused, not crashed
        assert not request_drain(router.address,
                                 member_id="ghost")["started"]
    finally:
        cli.close()


def test_fleet_drain_runs_swap_fn(fleet_env):
    router, services, members, data = fleet_env
    swapped = threading.Event()
    members[0].swap_fn = swapped.set
    assert router.drain("r0", timeout_s=30)
    assert swapped.is_set()


def test_fleet_failover_masks_killed_replica(fleet_env):
    router, services, members, data = fleet_env
    cli = FleetClient(router.address, refresh_s=0.05)
    try:
        rows = np.asarray([9, 10, 11], np.int32)
        np.testing.assert_array_equal(
            cli.lookup(rows, deadline_ms=10_000, timeout=30), data[rows])
        # hard-kill r1's serving socket + member agent (SIGKILL analog)
        members[1].close()
        services[1].close()
        # every subsequent lookup still answers (failover masks the loss)
        for _ in range(6):
            np.testing.assert_array_equal(
                cli.lookup(rows, deadline_ms=10_000, timeout=30),
                data[rows])
        # the sweep reaps the dead member within the liveness horizon
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                len(router.group.member_ids()) > 1:
            time.sleep(0.05)
        assert router.group.member_ids() == ["r0"]
    finally:
        cli.close()


def test_replica_unavailable_error_is_typed(port_env):
    from multiverso_tpu_torch.serving import (ReplicaUnavailableError,
                                        ServingClient, connect_with_backoff)
    t0 = time.monotonic()
    with pytest.raises(ReplicaUnavailableError):
        connect_with_backoff("127.0.0.1", 1, attempts=2,
                             base_delay_s=0.01)
    assert time.monotonic() - t0 < 5
    # ...and it IS an OSError, so pre-fleet call sites keep working
    assert issubclass(ReplicaUnavailableError, OSError)
    with pytest.raises(OSError):
        ServingClient("127.0.0.1", 1, connect_attempts=2)


# ---------------------------------------------------------------------------
# Server-side cancel for hedged losers + fleet stats rollup
# ---------------------------------------------------------------------------
def test_hedged_call_on_settled_reports_winner_and_launched():
    sched = HedgeScheduler()
    settled = []
    try:
        deliver_1 = []

        def a0(deliver):
            deliver_1.append(deliver)       # stays outstanding

        def a1(deliver):
            deliver("second wins")

        HedgedCall([a0, a1], lambda r: None, delay_ms=1.0,
                   scheduler=sched,
                   on_settled=lambda w, n: settled.append((w, n))).launch()
        deadline = time.monotonic() + 5
        while not settled and time.monotonic() < deadline:
            time.sleep(0.01)
        assert settled == [(1, 2)]
        deliver_1[0]("late loser")          # discarded, settled unchanged
        assert settled == [(1, 2)]
    finally:
        sched.close()


def test_hedged_call_on_settled_all_failed():
    sched = HedgeScheduler()
    settled = []
    try:
        def fail(deliver):
            raise OSError("down")

        HedgedCall([fail, fail], lambda r: None, delay_ms=1.0,
                   scheduler=sched,
                   on_settled=lambda w, n: settled.append((w, n))).launch()
        deadline = time.monotonic() + 5
        while not settled and time.monotonic() < deadline:
            time.sleep(0.01)
        assert settled == [(-1, 2)]
    finally:
        sched.close()


def test_batcher_cancel_drops_queued_request(port_env):
    """A queued hedged loser is dropped at admission: on_done gets
    ShedError('cancelled'), the device never sees it, and
    serve.cancelled counts it.

    The runner blocks on an Event the test only sets AFTER the cancel
    landed, so "cancel_me is still queued when cancelled" is guaranteed
    by construction, not by timing."""
    from multiverso_tpu_torch.serving.batcher import DynamicBatcher, ShedError
    from multiverso_tpu_torch.telemetry import get_registry

    class GatedRunner:
        payload_dtype = np.int32
        pad_id = 0

        def __init__(self):
            self.ran = []
            self.started = threading.Event()
            self.release = threading.Event()

        def run(self, mat, lengths):
            self.ran.append(mat.copy())
            self.started.set()
            assert self.release.wait(10), "test never released the runner"
            return mat

        def slice_result(self, out, i, n):
            return out[i, :n]

    runner = GatedRunner()
    b = DynamicBatcher(runner, buckets=(4,), max_batch=1,
                       max_wait_ms=0.0, max_queue=8)
    try:
        results = {}
        done = threading.Event()

        def on_done(key):
            def cb(result):
                results[key] = result
                if key == "cancel_me":
                    done.set()
            return cb

        # Head request occupies the worker (held on the gate)...
        b.submit_callback(np.asarray([1], np.int32), 10_000,
                          on_done("head"))
        assert runner.started.wait(5), "head batch never reached the runner"
        # ...so the second provably sits queued until we release.
        token = b.submit_callback(np.asarray([2], np.int32), 10_000,
                                  on_done("cancel_me"))
        assert token is not None
        before = get_registry().counter("serve.cancelled").value
        assert b.cancel(token) is True
        runner.release.set()
        assert done.wait(5)
        assert isinstance(results["cancel_me"], ShedError)
        assert results["cancel_me"].reason == "cancelled"
        assert get_registry().counter("serve.cancelled").value == before + 1
        # cancelling an already-delivered request is a harmless no-op
        assert b.cancel(token) is False
    finally:
        b.close()
    # the cancelled payload never reached the runner (close() drained
    # the worker, so this read is not racing it)
    assert not any((mat == 2).any() for mat in runner.ran)


def test_serve_cancel_over_the_wire(fleet_env):
    """Serve_Cancel for a queued request answers the ORIGINAL msg_id
    with Reply_Error('cancelled') — the waiter completes, nothing leaks,
    and an unknown msg_id is a counted no-op.

    Cancel is fire-and-forget, so the victim cancel's miss increment
    (when the victim raced past the queue) is ASYNCHRONOUS with respect
    to reply delivery — replies come from the batcher thread, the miss
    from the conn-reader thread. So the baselines are read BEFORE any
    cancel is sent and the total is bounded by the victim's observed
    outcome. The bound (not an exact count) is forced
    by a third server-side path: a cancel that races the queue POP
    returns False (counted a miss) but still marks the request, which
    batch FORMATION then drops with ShedError('cancelled') — so a
    client-observed 'cancelled' may carry 0 or 1 victim misses, while
    'completed' always carries exactly 1."""
    from multiverso_tpu_torch.serving import ServingClient, ShedError
    from multiverso_tpu_torch.telemetry import get_registry

    router, services, members, data = fleet_env
    svc = services[0]
    reg = get_registry()
    cli = ServingClient(*svc.address)
    try:
        req0 = reg.counter("serve.cancel.requests").value
        miss0 = reg.counter("serve.cancel.miss").value
        # Saturate the batcher briefly so a second request queues.
        slow = [cli.request_async(np.arange(8, dtype=np.int32), 10_000)
                for _ in range(8)]
        victim = cli.request_async(np.arange(4, dtype=np.int32), 10_000)
        cli.cancel(victim.msg_id)
        try:
            victim.wait(timeout=10)
            outcome = "completed"       # raced past the queue: fine
        except ShedError as e:
            # Wire sheds surface as reason "server" with the server's
            # reason text in the message.
            outcome = "cancelled" if "cancelled" in str(e) else str(e)
        assert outcome in ("cancelled", "completed")
        for r in slow:
            r.wait(timeout=10)
        cli.cancel(999_999_999)         # unknown id: counted, harmless
        # Wait until BOTH cancels were processed (requests counts every
        # cancel frame deterministically), then bound the misses this
        # test can produce: the unknown id ALWAYS misses; a completed
        # victim always adds one more; a cancelled victim adds 0 (still
        # queued) or 1 (the formation-drop race above) — never more.
        min_miss = miss0 + (2 if outcome == "completed" else 1)
        max_miss = miss0 + 2
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and (
                reg.counter("serve.cancel.requests").value < req0 + 2
                or reg.counter("serve.cancel.miss").value < min_miss):
            time.sleep(0.01)
        assert reg.counter("serve.cancel.requests").value == req0 + 2
        assert min_miss <= reg.counter("serve.cancel.miss").value \
            <= max_miss
    finally:
        cli.close()


def test_fleet_stats_rollup_sums_match_per_replica(fleet_env):
    from multiverso_tpu_torch.fleet import fetch_fleet_stats

    router, services, members, data = fleet_env
    cli = FleetClient(router.address, hedge="off", refresh_s=0.05)
    try:
        for _ in range(12):
            cli.lookup(np.arange(6, dtype=np.int32), deadline_ms=10_000,
                       timeout=30)
        # Wait until the heartbeat metrics caught up with the traffic.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            stats = fetch_fleet_stats(router.address)
            if stats["fleet"]["replies"] >= 12:
                break
            time.sleep(0.05)
        assert stats["schema"] == "multiverso_tpu.fleet_stats/v1"
        assert stats["version"] > 0
        per = stats["replicas"]
        assert set(per) == {"r0", "r1"}
        fleet = stats["fleet"]
        for key in ("requests", "replies", "shed", "cancelled",
                    "slo_violations", "watchdog_trips"):
            assert fleet[key] == sum(r[key] for r in per.values()), key
        assert "router_watchdog_trips" in stats
        assert fleet["replicas"] == 2
        # stage percentiles rode along (count-weighted merge is defined
        # whenever any replica served anything)
        assert fleet["stages"]["total"]["count"] >= 12
        # versioned: another metrics-bearing heartbeat bumps it
        v0 = stats["version"]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if fetch_fleet_stats(router.address)["version"] > v0:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("stats version never advanced")
    finally:
        cli.close()


def test_fleet_top_render_is_stable():
    from multiverso_tpu_torch.apps.fleet_top import render_stats
    stats = {
        "version": 7, "time_unix": 0.0,
        "router_alerts": [{"name": "fleet.heartbeat_loss",
                           "severity": "page", "value": 1.0,
                           "for_s": 2.0}],
        "fleet": {"replicas": 2, "qps": 123.4, "shed_rate": 0.015,
                  "queue_depth": 3.0, "inflight": 2.0,
                  "slo_violations": 9, "alerts_active": 2,
                  "hotkey_replicated": 3,
                  "rebalance": {"overrides": 4, "migrations": 1},
                  "stages": {"total": {"p50": 1.0, "p95": 2.0,
                                       "p99": 3.0, "count": 10}}},
        "replicas": {
            "r0": {"health": 0.9, "qps": 61.7, "shed_rate": 0.01,
                   "queue_depth": 1.0, "inflight": 1.0,
                   "slo_violations": 4, "drains_completed": 1,
                   "draining": False,
                   "hot_replicated": 3, "migrations": 1,
                   "alerts": [{"name": "serve.slo_burn",
                               "severity": "page", "value": 3.2,
                               "for_s": 1.5}],
                   "stages": {"total": {"p50": 1.0, "p95": 2.0,
                                        "p99": 3.0, "count": 5}}},
            "r1": {"health": 0.0, "qps": 61.7, "shed_rate": 0.02,
                   "queue_depth": 2.0, "inflight": 1.0,
                   "slo_violations": 5, "drains_completed": 0,
                   "draining": True, "stages": {}},
        },
    }
    out = render_stats(stats)
    lines = out.splitlines()
    assert lines[0].startswith("fleet_top  v7")
    assert "qps=123.4" in lines[0]
    assert "alerts=2" in lines[0]
    assert "ALERTS" in lines[1] and "REBAL" in lines[1]
    r0 = [l for l in lines if l.startswith("r0")][0]
    assert "up" in r0 and "1:serve.slo_b" in r0
    # REBAL cell: replicated-key count + migrations in flight
    assert "3/m1" in r0
    r1 = [l for l in lines if l.startswith("r1")][0]
    # no alerts key at all renders as the quiet cell, never a KeyError
    assert "drain" in r1 and r1.rstrip().endswith("-")
    assert lines[-1].startswith("FLEET")
    assert "3/m1" in lines[-1]
    # router-scoped alerts (heartbeat loss) render on the FLEET row
    assert "1:fleet.heart" in lines[-1]
    # a missing stages dict renders as zeros, never a KeyError
    assert "0.00" in r1


def test_member_rates_survive_sparse_heartbeats():
    """A heartbeat interval LONGER than the rate window must degrade to
    rate-over-one-beat, not to permanent zeros (review finding)."""
    from multiverso_tpu_torch.fleet.membership import MemberInfo
    info = MemberInfo("r0", "h", 1)
    t = 1000.0
    for beat in range(4):
        info.observe_metrics({"requests": 100.0 * beat,
                              "replies": 100.0 * beat,
                              "shed": 0.0}, t + 10.0 * beat)
    assert len(info.history) >= 2
    rates = info.rates()
    assert rates["qps"] > 0.0
    assert abs(rates["qps"] - 10.0) < 1e-6      # 100 replies / 10 s
