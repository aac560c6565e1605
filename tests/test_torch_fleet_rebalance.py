"""The port's skew actuators (docs/DESIGN.md "Skew actuation"): the
cases of ``tests/test_rebalance.py`` run against
``multiverso_tpu_torch.fleet``; their parity with the JAX package is in
``tests/test_torch_fleet_parity.py``.

Three legs, each with its correctness witness:

* **Vnode ownership transfer** (hashring overrides): minimal disruption
  (only the migrated arcs' keys move, and all of them land on the
  target), determinism (router and clients rebuild the identical
  effective ring from ``(members, vnodes, overrides)``), and the
  mid-migration retry property — through the flip a key resolves to
  exactly one of {old owner, new owner}, never a third member.
* **Hot-key replication** (HotKeyReplicator + RoutingTable freshness):
  windowed-share promotion, demotion hysteresis, counter-reset resync,
  and the staleness gate — a member serves a replicated key iff
  ``fleet_max_step - member_step <= hot_staleness``, filtered at table
  build time.
* **Drain-and-handoff** (FleetRebalancer): deterministic hysteresis
  under a fake clock, hottest-arc targeting from merged sketch data,
  one-migration-in-flight, and the WAL parity witness — every write
  sync-acked before/during/after the handoff window replays bitwise.

Plus the CacheAutosizer's grow/shrink/clamp discipline (leg 3).
"""

import threading

import numpy as np
import pytest

import _torch_port

torch = None
WriteAheadLog = replay = FleetClient = RoutingTable = None
HashRing = ReplicaGroup = FleetRebalancer = None
HotKeyReplicator = CacheAutosizer = HotRowCache = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, WriteAheadLog, replay, FleetClient, RoutingTable, HashRing
    global ReplicaGroup, FleetRebalancer, HotKeyReplicator, CacheAutosizer
    global HotRowCache
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.core.wal import (WriteAheadLog, replay)
    from multiverso_tpu_torch.fleet.client import (FleetClient, RoutingTable)
    from multiverso_tpu_torch.fleet.hashring import HashRing
    from multiverso_tpu_torch.fleet.membership import ReplicaGroup
    from multiverso_tpu_torch.fleet.rebalance import (FleetRebalancer,
                                                      HotKeyReplicator)
    from multiverso_tpu_torch.serving.cache import (CacheAutosizer,
                                                    HotRowCache)


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


# ---------------------------------------------------------------------------
# Leg 2 actuation surface: vnode ownership transfer on the hash ring.
# ---------------------------------------------------------------------------

class TestOwnershipTransfer:
    def test_transfer_moves_only_the_migrated_arcs(self):
        ring = HashRing(["a", "b", "c"], vnodes=16)
        before = ring.owner_indices(KEYS)
        arcs = [("a", 0), ("a", 1), ("a", 2)]
        ring.set_overrides([(m, v, "b") for m, v in arcs])
        after = ring.owner_indices(KEYS)
        names = ring.members
        moved = np.flatnonzero(before != after)
        assert moved.size > 0
        # Every moved key left the donor for the target — nobody else.
        assert all(names[before[i]] == "a" for i in moved.tolist())
        assert all(names[after[i]] == "b" for i in moved.tolist())
        # Every moved key sits on a migrated arc; keys on any other arc
        # (including the donor's other arcs) did not move at all.
        assert set(ring.arc_ids(KEYS[moved])) <= set(arcs)
        untouched = [i for i, arc in enumerate(ring.arc_ids(KEYS))
                     if arc not in set(arcs)]
        assert (before[untouched] == after[untouched]).all()

    def test_ring_is_deterministic_in_members_vnodes_overrides(self):
        ov = [("a", 3, "c"), ("b", 7, "a")]
        r1 = HashRing(["a", "b", "c"], vnodes=16, overrides=ov)
        r2 = HashRing(["c", "b", "a"], vnodes=16,
                      overrides=list(reversed(ov)))
        assert r1.members == r2.members
        assert (r1.owner_indices(KEYS) == r2.owner_indices(KEYS)).all()
        assert r1.overrides == r2.overrides == tuple(sorted(ov))
        # assign_vnode(member, v, member) clears; the ring reverts to
        # the pure hash placement bit-for-bit.
        r1.assign_vnode("a", 3, "a")
        r1.assign_vnode("b", 7, "b")
        base = HashRing(["a", "b", "c"], vnodes=16)
        assert r1.overrides == ()
        assert (r1.owner_indices(KEYS) == base.owner_indices(KEYS)).all()

    def test_retry_through_the_flip_lands_on_old_xor_new_owner(self):
        """A client retrying through the announce sees either the
        pre-flip or the post-flip table; in both, a migrated key's owner
        is one of {donor, target} — the park-and-retry loop can never be
        routed to a member that was never responsible for the key."""
        old = HashRing(["a", "b", "c"], vnodes=16)
        new = HashRing(["a", "b", "c"], vnodes=16,
                       overrides=[("a", 0, "c")])
        names = old.members
        ob, nb = old.owner_indices(KEYS), new.owner_indices(KEYS)
        flipped = np.flatnonzero(ob != nb)
        assert flipped.size > 0
        for i in flipped.tolist():
            assert (names[ob[i]], names[nb[i]]) == ("a", "c")
        # The un-migrated majority resolves identically on both tables.
        same = np.flatnonzero(ob == nb)
        assert same.size + flipped.size == KEYS.size

    def test_dangling_override_reverts_to_hash_owner(self):
        base = HashRing(["a", "b"], vnodes=16)
        gone = HashRing(["a", "b"], vnodes=16, overrides=[("a", 0, "zz")])
        assert (base.owner_indices(KEYS) == gone.owner_indices(KEYS)).all()
        # Removing a live override's target reverts those arcs too — the
        # fail-safe a swept member needs, with no bookkeeping.
        ring = HashRing(["a", "b", "c"], vnodes=16,
                        overrides=[("a", 0, "c")])
        ring.remove("c")
        two = HashRing(["a", "b"], vnodes=16)
        assert (ring.owner_indices(KEYS) == two.owner_indices(KEYS)).all()


# ---------------------------------------------------------------------------
# Leg 1: hot-key replication — promotion/demotion hysteresis.
# ---------------------------------------------------------------------------

def _group(n=3, vnodes=16):
    g = ReplicaGroup(vnodes=vnodes, heartbeat_ms=1000.0)
    names = [f"r{i}" for i in range(n)] if n > 3 else ["a", "b", "c"][:n]
    for i, mid in enumerate(names):
        g.join(mid, "127.0.0.1", 1000 + i)
    return g


def _beat(group, mid, keys_total, hot):
    """One metrics-bearing heartbeat: cumulative served-keys total plus
    the member's heavy-hitter list [[key, cumulative_count], ...]."""
    group.heartbeat(mid, {}, {"keys": keys_total, "hot_keys": hot})


class TestHotKeyReplicator:
    def test_promotion_publishes_replica_set_home_owner_first(self):
        g = _group()
        rep = HotKeyReplicator(g, replicas=1, promote_share=0.02,
                               min_window_keys=100)
        assert rep.tick() == {}          # zero-traffic baseline window
        _beat(g, "a", 1000, [[7, 500]])
        mapping = rep.tick()
        assert list(mapping) == [7]
        assert mapping[7] == g.ring.replica_set(7, 2)
        assert mapping[7][0] == g.ring.owner(7)
        assert len(set(mapping[7])) == 2
        assert g.hot_keys() == mapping   # installed for the next payload

    def test_demotion_needs_consecutive_cold_windows(self):
        g = _group()
        rep = HotKeyReplicator(g, promote_share=0.02, demote_windows=2,
                               min_window_keys=100)
        rep.tick()
        _beat(g, "a", 1000, [[7, 500]])
        assert 7 in rep.tick()           # promoted
        _beat(g, "a", 2000, [[7, 500]])
        assert 7 in rep.tick()           # one cold window: still hot
        _beat(g, "a", 3000, [[7, 1000]])
        assert 7 in rep.tick()           # hot again: streak resets
        _beat(g, "a", 4000, [[7, 1000]])
        assert 7 in rep.tick()           # cold window 1 of 2
        _beat(g, "a", 5000, [[7, 1000]])
        assert 7 not in rep.tick()       # cold window 2: demoted

    def test_tiny_window_is_not_judged(self):
        """A trickle window (fewer than min_window_keys served fleet-wide)
        neither promotes nor advances demotion — quiet periods must not
        flap the confident set."""
        g = _group()
        rep = HotKeyReplicator(g, promote_share=0.02, demote_windows=1,
                               min_window_keys=200)
        rep.tick()
        _beat(g, "a", 1000, [[7, 500]])
        assert 7 in rep.tick()
        for total in (1050, 1100, 1150):     # 50-key windows, key 7 cold
            _beat(g, "a", total, [[7, 500]])
            assert 7 in rep.tick()
        _beat(g, "a", 2000, [[7, 500]])      # a real window, still cold
        assert 7 not in rep.tick()           # demote_windows=1: out

    def test_counter_reset_resyncs_baseline(self):
        """A member restart drops the cumulative totals; the replicator
        must resynchronize instead of judging a negative window."""
        g = _group()
        rep = HotKeyReplicator(g, promote_share=0.02, demote_windows=3,
                               min_window_keys=100)
        rep.tick()
        _beat(g, "a", 1000, [[7, 500]])
        assert 7 in rep.tick()
        _beat(g, "a", 100, [[7, 10]])        # restarted: counters reset
        assert 7 in rep.tick()               # resync window: no judgment
        _beat(g, "a", 1100, [[9, 900], [7, 10]])
        mapping = rep.tick()                 # next window judges normally
        assert 9 in mapping                  # 900/1000 promotes
        assert 7 in mapping                  # 1 cold window of 3: kept

    def test_topk_caps_the_confident_set_by_share(self):
        g = _group()
        rep = HotKeyReplicator(g, promote_share=0.01, topk=2,
                               min_window_keys=100)
        rep.tick()
        _beat(g, "a", 1000, [[1, 400], [2, 300], [3, 200], [4, 100]])
        assert set(rep.tick()) == {1, 2}

    def test_counts_merge_across_members_and_version_bumps_on_delta(self):
        g = _group()
        rep = HotKeyReplicator(g, promote_share=0.02, min_window_keys=100)
        rep.tick()
        # 300 + 300 out of 1000: neither member alone crosses 2%-of-
        # window confidently enough to matter — the MERGED share does.
        _beat(g, "a", 500, [[7, 300]])
        _beat(g, "b", 500, [[7, 300]])
        v0 = g.version
        assert 7 in rep.tick()
        assert g.version == v0 + 1           # real delta: announce
        assert 7 in rep.tick()               # steady set: no churn
        assert g.version == v0 + 1


# ---------------------------------------------------------------------------
# Leg 1 routing: build-time freshness filter + all-or-nothing hot routing.
# ---------------------------------------------------------------------------

def _payload(steps, hot, overrides=(), draining=()):
    return {
        "version": 1, "vnodes": 16,
        "hot_keys": {str(k): list(v) for k, v in hot.items()},
        "overrides": [list(o) for o in overrides],
        "members": [{"id": mid, "host": "127.0.0.1", "port": 1000 + i,
                     "health": 1.0, "draining": mid in draining,
                     "step": step, "drains_completed": 0}
                    for i, (mid, step) in enumerate(sorted(steps.items()))],
    }


class _Cnt:
    def __init__(self):
        self.n = 0

    def inc(self, k=1):
        self.n += k


def _cli_stub():
    """The two attrs _affinity_pref touches, without dialing a router."""
    class _S:
        pass
    s = _S()
    s._hot_rr = 0
    s._c_hot_routed = _Cnt()
    return s


class TestReplicatedReadFreshness:
    def test_stale_replica_filtered_at_build_time(self):
        pay = _payload({"a": 10.0, "b": 8.0, "c": 10.0},
                       {5: ["a", "b", "c"]})
        assert RoutingTable(pay, hot_staleness=0.0).hot_replicas \
            == {5: ["a", "c"]}
        assert RoutingTable(pay, hot_staleness=1.0).hot_replicas \
            == {5: ["a", "c"]}
        assert RoutingTable(pay, hot_staleness=2.0).hot_replicas \
            == {5: ["a", "b", "c"]}

    def test_unversioned_fleet_is_always_fresh(self):
        pay = _payload({"a": -1.0, "b": -1.0}, {5: ["a", "b"]})
        assert RoutingTable(pay, hot_staleness=0.0).hot_replicas \
            == {5: ["a", "b"]}

    def test_stepless_member_in_versioned_fleet_never_serves_hot(self):
        pay = _payload({"a": 10.0, "b": -1.0}, {5: ["a", "b"]})
        assert RoutingTable(pay, hot_staleness=1e9).hot_replicas \
            == {5: ["a"]}

    def test_key_with_no_fresh_replica_falls_back_to_affinity(self):
        pay = _payload({"a": 10.0, "b": 0.0}, {5: ["b"]})
        table = RoutingTable(pay, hot_staleness=0.0)
        assert table.hot_replicas == {}
        cli = _cli_stub()
        pref = FleetClient._affinity_pref(
            cli, np.array([5], dtype=np.int64), table)
        assert sorted(pref) == sorted(table.ring.members)
        assert cli._c_hot_routed.n == 0      # classic route, not hot

    def test_draining_member_is_not_a_hot_replica(self):
        pay = _payload({"a": -1.0, "b": -1.0}, {5: ["a", "b"]},
                       draining=("b",))
        assert RoutingTable(pay, hot_staleness=0.0).hot_replicas \
            == {5: ["a"]}

    def test_hot_routing_round_robins_over_fresh_union(self):
        ring = HashRing(["a", "b", "c"], vnodes=16)
        hot = {1: ring.replica_set(1, 2), 2: ring.replica_set(2, 2)}
        pay = _payload({"a": -1.0, "b": -1.0, "c": -1.0}, hot)
        table = RoutingTable(pay, hot_staleness=0.0)
        cli = _cli_stub()
        rows = np.array([1, 2], dtype=np.int64)
        cand = []
        for r in rows:
            for m in hot[int(r)]:
                if m not in cand:
                    cand.append(m)
        picks = []
        for _ in range(3 * len(cand)):
            pref = FleetClient._affinity_pref(cli, rows, table)
            picks.append(pref[0])
            # Every preference list covers the whole fleet exactly once.
            assert sorted(pref) == sorted(table.ring.members)
        assert set(picks) == set(cand)       # round-robin visits them all
        assert cli._c_hot_routed.n == len(picks)

    def test_partial_hot_set_routes_classic(self):
        """All-or-nothing: one un-replicated row in the request disables
        hot routing for the whole request (mirrors the cache's
        all-or-nothing admission)."""
        ring = HashRing(["a", "b", "c"], vnodes=16)
        pay = _payload({"a": -1.0, "b": -1.0, "c": -1.0},
                       {1: ring.replica_set(1, 2)})
        table = RoutingTable(pay, hot_staleness=0.0)
        cli = _cli_stub()
        prefs = {tuple(FleetClient._affinity_pref(
            cli, np.array([1, 3], dtype=np.int64), table))
            for _ in range(6)}
        assert len(prefs) == 1               # sticky, not round-robin
        assert cli._c_hot_routed.n == 0


# ---------------------------------------------------------------------------
# Leg 2: drain-and-handoff rebalancer (deterministic via fake clock +
# injected drain).
# ---------------------------------------------------------------------------

SKEWED = {"r0": 100.0, "r1": 1.0, "r2": 50.0}
BALANCED = {"r0": 50.0, "r1": 50.0, "r2": 50.0}


def _rgroup(n=3):
    g = ReplicaGroup(vnodes=8, heartbeat_ms=1000.0)
    for i in range(n):
        g.join(f"r{i}", "127.0.0.1", 1000 + i)
    return g


class TestFleetRebalancer:
    def test_arms_after_windows_and_migrates_hot_to_cold(self):
        g = _rgroup()
        drained = []
        reb = FleetRebalancer(g, ratio=1.5, windows=2, cooldown_s=10.0,
                              move_vnodes=2,
                              drain_fn=lambda m: bool(drained.append(m)))
        assert reb.tick(SKEWED, now=0.0) is None         # streak 1 of 2
        assert reb.tick(SKEWED, now=1.0) == ("r0", "r1")
        assert reb.join()
        assert drained == ["r0"]
        ov = g.vnode_overrides()
        assert len(ov) == 2
        assert all(m == "r0" and t == "r1" for m, _v, t in ov)
        assert g.ring.overrides == tuple(ov)             # announced
        assert reb.migrations_started == 1
        # Display state (fleet_top REBAL) cleared once the handoff
        # settles.
        sp = g.stats_payload()
        assert sp["replicas"]["r0"]["migrations"] == 0
        assert sp["fleet"]["rebalance"] == {"overrides": 2,
                                            "migrations": 0}

    def test_balanced_window_resets_the_streak(self):
        g = _rgroup()
        reb = FleetRebalancer(g, ratio=1.5, windows=2, cooldown_s=0.0,
                              drain_fn=lambda m: True)
        assert reb.tick(SKEWED, now=0.0) is None
        assert reb.tick(BALANCED, now=1.0) is None       # streak reset
        assert reb.tick(SKEWED, now=2.0) is None         # back to 1 of 2
        assert reb.tick(SKEWED, now=3.0) is not None
        assert reb.join()

    def test_cooldown_gates_back_to_back_migrations(self):
        g = _rgroup()
        reb = FleetRebalancer(g, ratio=1.5, windows=1, cooldown_s=10.0,
                              move_vnodes=1, drain_fn=lambda m: True)
        assert reb.tick(SKEWED, now=0.0) is not None
        assert reb.join()
        assert reb.tick(SKEWED, now=5.0) is None         # cooling down
        assert reb.tick(SKEWED, now=10.5) is not None
        assert reb.join()
        assert reb.migrations_started == 2

    def test_one_migration_in_flight_at_a_time(self):
        g = _rgroup()
        gate = threading.Event()
        reb = FleetRebalancer(g, ratio=1.5, windows=1, cooldown_s=0.0,
                              drain_fn=lambda m: gate.wait(5.0))
        assert reb.tick(SKEWED, now=0.0) is not None
        assert reb.migrating
        assert reb.tick(SKEWED, now=100.0) is None       # handoff busy
        gate.set()
        assert reb.join()
        assert reb.migrations_started == 1

    def test_picks_the_arcs_the_sketch_says_are_hot(self):
        g = _rgroup(2)
        # One key the sketch blames, on a donor-owned arc; a second
        # donor-owned key on a DIFFERENT arc must stay home.
        hot_key = next(int(k) for k in range(5000)
                       if g.ring.owner(int(k)) == "r0")
        hot_arc = g.ring.arc_ids(np.array([hot_key]))[0]
        cold_key = next(
            int(k) for k in range(5000)
            if g.ring.owner(int(k)) == "r0"
            and g.ring.arc_ids(np.array([int(k)]))[0] != hot_arc)
        _beat(g, "r0", 1000, [[hot_key, 900]])
        reb = FleetRebalancer(g, ratio=1.5, windows=1, cooldown_s=0.0,
                              move_vnodes=1, drain_fn=lambda m: True)
        assert reb.tick({"r0": 100.0, "r1": 1.0}, now=0.0) == ("r0", "r1")
        assert reb.join()
        assert g.ring.owner(hot_key) == "r1"             # heat moved
        assert g.ring.owner(cold_key) == "r0"            # cold stayed

    def test_wal_parity_through_the_handoff_window(self, tmp_path):
        """The durability witness: every write sync-acked before, DURING
        (mid-drain, while ownership flips), and after the handoff
        replays bitwise and in order — the WAL parity guarantee on the
        migration path."""
        g = _rgroup(2)
        wal = WriteAheadLog(str(tmp_path))
        acked = []

        def ack(payload):
            acked.append((wal.append(payload, sync=True), payload))

        for i in range(4):
            ack(b"pre-%d" % i)

        def drain_fn(donor):
            assert donor == "r0"
            for i in range(4):
                ack(b"mid-%d" % i)       # acks keep landing mid-drain
            return True

        reb = FleetRebalancer(g, ratio=1.5, windows=1, cooldown_s=0.0,
                              move_vnodes=2, drain_fn=drain_fn)
        assert reb.tick({"r0": 100.0, "r1": 1.0}, now=0.0) == ("r0", "r1")
        assert reb.join()
        assert g.vnode_overrides()       # ownership really flipped
        for i in range(4):
            ack(b"post-%d" % i)
        wal.close()
        assert list(replay(str(tmp_path))) == acked

    def test_membership_ships_actuation_state_to_clients(self):
        g = _rgroup()
        v0 = g.version
        g.set_hot_keys({5: ["r0", "r1"]})
        g.apply_vnode_overrides([("r0", 1, "r2")])
        assert g.version == v0 + 2
        # Idempotent re-installs must NOT churn client tables.
        g.set_hot_keys({5: ["r0", "r1"]})
        g.apply_vnode_overrides([("r0", 1, "r2")])
        assert g.version == v0 + 2
        pay = g.routing_payload()
        assert pay["hot_keys"] == {"5": ["r0", "r1"]}
        assert pay["overrides"] == [["r0", 1, "r2"]]
        table = RoutingTable(pay)
        assert table.ring.overrides == g.ring.overrides
        sample = np.arange(2000, dtype=np.int64)
        assert (table.ring.owner_indices(sample)
                == g.ring.owner_indices(sample)).all()
        sp = g.stats_payload()
        assert sp["fleet"]["hotkey_replicated"] == 1
        assert sp["fleet"]["rebalance"]["overrides"] == 1
        assert sp["replicas"]["r0"]["hot_replicated"] == 1
        assert sp["replicas"]["r1"]["hot_replicated"] == 1
        assert sp["replicas"]["r2"]["hot_replicated"] == 0


# ---------------------------------------------------------------------------
# Leg 3: advisor-sized hot-row cache.
# ---------------------------------------------------------------------------

GROWS = {"predicted_hit_rate": 0.50, "predicted_hit_rate_2x": 0.60}
FLAT = {"predicted_hit_rate": 0.50, "predicted_hit_rate_2x": 0.50}


def _sized_cache(capacity=64):
    cache = HotRowCache(capacity, staleness=0)
    cache.put_rows(np.array([1]), np.ones((1, 16), np.float32), clock=1.0)
    return cache


class TestCacheAutosizer:
    def test_no_resize_until_row_bytes_are_learned(self):
        cache = HotRowCache(64, staleness=0)
        auto = CacheAutosizer(cache, mem_budget=1 << 20, windows=1,
                              cooldown_s=0.0)
        assert auto.budget_rows() is None
        assert auto.on_advice(GROWS, now=0.0) is None
        assert cache.capacity == 64

    def test_grow_needs_streak_and_cooldown_and_budget_caps_it(self):
        cache = _sized_cache(64)
        auto = CacheAutosizer(cache, mem_budget=cache.row_nbytes * 200,
                              windows=2, cooldown_s=10.0, min_rows=16)
        assert auto.budget_rows() == 200
        assert auto.on_advice(GROWS, now=0.0) is None    # streak 1 of 2
        assert auto.on_advice(GROWS, now=1.0) == "grow"
        assert cache.capacity == 128
        assert auto.on_advice(GROWS, now=2.0) is None    # streak rebuilt
        assert auto.on_advice(GROWS, now=3.0) is None    # cooling down
        assert auto.on_advice(GROWS, now=11.0) == "grow"  # cooldown over
        assert cache.capacity == 200                     # budget clamp
        # Keep occupancy above half so only the grow arm is in play:
        # at the bound, more grow-worthy advice must be a no-op.
        cache.put_rows(np.arange(2, 152),
                       np.ones((150, 16), np.float32), clock=1.0)
        assert auto.on_advice(GROWS, now=30.0) is None   # at the bound
        assert auto.on_advice(GROWS, now=31.0) is None
        assert cache.capacity == 200

    def test_flat_advice_resets_the_grow_streak(self):
        cache = _sized_cache(64)
        # Keep occupancy above half so the shrink arm stays quiet.
        cache.put_rows(np.arange(2, 40),
                       np.ones((38, 16), np.float32), clock=1.0)
        auto = CacheAutosizer(cache, mem_budget=cache.row_nbytes * 200,
                              windows=2, cooldown_s=0.0)
        assert auto.on_advice(GROWS, now=0.0) is None
        assert auto.on_advice(FLAT, now=1.0) is None     # streak reset
        assert auto.on_advice(GROWS, now=2.0) is None    # back to 1 of 2
        assert auto.on_advice(GROWS, now=3.0) == "grow"

    def test_idle_cache_shrinks_to_the_floor(self):
        cache = _sized_cache(256)                        # occupancy 1
        auto = CacheAutosizer(cache, mem_budget=cache.row_nbytes * 1024,
                              windows=2, cooldown_s=0.0, min_rows=64)
        assert auto.on_advice(FLAT, now=0.0) is None
        assert auto.on_advice(FLAT, now=1.0) == "shrink"
        assert cache.capacity == 128
        assert auto.on_advice(FLAT, now=2.0) is None
        assert auto.on_advice(FLAT, now=3.0) == "shrink"
        assert cache.capacity == 64                      # min_rows floor
        assert auto.on_advice(FLAT, now=4.0) is None
        assert auto.on_advice(FLAT, now=5.0) is None
        assert cache.capacity == 64

    def test_budget_breach_clamps_immediately(self):
        """The budget is a ceiling, not advice: when learned row bytes
        put capacity over it, the clamp skips streak AND cooldown."""
        cache = _sized_cache(1024)
        auto = CacheAutosizer(cache, mem_budget=cache.row_nbytes * 100,
                              windows=3, cooldown_s=1e9, min_rows=16)
        assert auto.on_advice(FLAT, now=0.0) == "shrink"
        assert cache.capacity == 100
        # Evictions happen at clamp time, not lazily at the next insert.
        cache2 = _sized_cache(8)
        cache2.put_rows(np.arange(2, 10),
                        np.ones((8, 16), np.float32), clock=1.0)
        assert len(cache2) == 8
        cache2.resize(4)
        assert len(cache2) == 4
