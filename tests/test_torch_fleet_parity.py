"""Port parity: the fleet's pure pieces against the JAX package on the same
seeded inputs.

* ``HashRing``: the owners of 100,000 keys, the keys that move when a
  member joins or leaves, replica sets, successors and vnode overrides,
  identical for the same members and vnodes.
* ``health_score`` and the routing payload's health ranking, identical
  (bitwise floats) for the same stats; ``AdaptiveDelay`` and
  ``HedgeBudget`` give the same delays and the same token decisions for
  the same observation sequences.
* ``metrics_payload`` ships every field the JAX one ships.
* ``fleet_top``'s ``render_stats`` and ``render_exemplars`` give the
  identical string for the same rollup.
* ``HotKeyReplicator`` and ``FleetRebalancer``: identical hot-key sets
  and migration plans (donor, target, vnode overrides) for the same
  heartbeat and load sequences.
* ``ChaosEngine``: identical fault schedules for the same seed.

Everything here is host-side numpy and Python: exact equality.
"""

import numpy as np
import pytest

import _torch_port
from multiverso_tpu.apps import fleet_top as jtop
from multiverso_tpu.fleet import client as jclient
from multiverso_tpu.fleet import hashring as jring
from multiverso_tpu.fleet import health as jhealth
from multiverso_tpu.fleet import hedge as jhedge
from multiverso_tpu.fleet import membership as jmember
from multiverso_tpu.fleet import rebalance as jrebal

tring = thealth = thedge = tmember = trebal = tclient = ttop = None

KEYS = np.arange(100_000, dtype=np.int64)


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global tring, thealth, thedge, tmember, trebal, tclient, ttop
    _torch_port.load_torch()
    from multiverso_tpu_torch.apps import fleet_top as ttop
    from multiverso_tpu_torch.fleet import client as tclient
    from multiverso_tpu_torch.fleet import hashring as tring
    from multiverso_tpu_torch.fleet import health as thealth
    from multiverso_tpu_torch.fleet import hedge as thedge
    from multiverso_tpu_torch.fleet import membership as tmember
    from multiverso_tpu_torch.fleet import rebalance as trebal


@pytest.fixture(autouse=True)
def _reset_registries():
    from multiverso_tpu.telemetry import get_registry as jreg
    from multiverso_tpu_torch.telemetry import get_registry as treg
    jreg().reset()
    treg().reset()
    yield
    jreg().reset()
    treg().reset()


def _owners(ring, keys=KEYS):
    return np.asarray(ring.members)[ring.owner_indices(keys)]


# ---------------------------------------------------------------------------
# HashRing
# ---------------------------------------------------------------------------
MEMBER_SETS = [["r0", "r1"], ["a", "b", "c"],
               [f"replica-{i}" for i in range(5)],
               ["127.0.0.1:7070#12", "127.0.0.1:7071#13", "h:1#2"]]


@pytest.mark.parametrize("vnodes", [1, 16, 64])
@pytest.mark.parametrize("members", MEMBER_SETS,
                         ids=["two", "three", "five", "addresses"])
def test_ring_owners_identical(members, vnodes):
    j = jring.HashRing(members, vnodes=vnodes)
    t = tring.HashRing(members, vnodes=vnodes)
    assert t.members == j.members
    np.testing.assert_array_equal(_owners(t), _owners(j))
    rng = np.random.default_rng(vnodes)
    wide = rng.integers(-2**62, 2**62, size=10_000, dtype=np.int64)
    np.testing.assert_array_equal(_owners(t, wide), _owners(j, wide))
    for k in (0, 7, 99_999, -5):
        assert t.owner(k) == j.owner(k)
        assert t.replica_set(k, 2) == j.replica_set(k, 2)
        assert t.replica_set(k, 9) == j.replica_set(k, 9)
    for m in members:
        assert t.successors(m, 2) == j.successors(m, 2)
    assert [sorted(v.tolist()) for v in t.partition(KEYS[:999]).values()] \
        == [sorted(v.tolist()) for v in j.partition(KEYS[:999]).values()]


@pytest.mark.parametrize("vnodes", [16, 64])
@pytest.mark.parametrize("members", MEMBER_SETS[1:3], ids=["three", "five"])
def test_ring_key_movement_identical(members, vnodes):
    """The keys that move on a join and on a leave, and where they go."""
    for pkg in ("add", "remove"):
        moved = []
        for mod in (jring, tring):
            ring = mod.HashRing(members, vnodes=vnodes)
            before = _owners(ring)
            if pkg == "add":
                assert ring.add("newcomer")
            else:
                assert ring.remove(members[1])
            after = _owners(ring)
            idx = np.flatnonzero(before != after)
            moved.append((idx, after[idx]))
        np.testing.assert_array_equal(moved[0][0], moved[1][0])
        np.testing.assert_array_equal(moved[0][1], moved[1][1])
        assert moved[0][0].size > 0


def test_ring_overrides_and_arc_ids_identical():
    ov = [("a", 3, "c"), ("b", 7, "a"), ("c", 0, "b")]
    j = jring.HashRing(["a", "b", "c"], vnodes=16, overrides=ov)
    t = tring.HashRing(["a", "b", "c"], vnodes=16, overrides=ov)
    np.testing.assert_array_equal(_owners(t), _owners(j))
    assert t.overrides == j.overrides
    assert t.arc_ids(KEYS[:2_000]) == j.arc_ids(KEYS[:2_000])
    for ring in (j, t):
        ring.assign_vnode("a", 5, "b")
        ring.remove("c")
    np.testing.assert_array_equal(_owners(t), _owners(j))
    assert t.overrides == j.overrides


# ---------------------------------------------------------------------------
# Health and hedging
# ---------------------------------------------------------------------------
def _random_stats(rng, n: int) -> list:
    out = []
    for _ in range(n):
        s = {"queue_depth": float(rng.integers(0, 80)),
             "inflight": float(rng.integers(0, 16)),
             "max_queue": float(rng.choice([0, 1, 64, 128])),
             "max_batch": float(rng.choice([0, 1, 8, 16])),
             "replica_step": float(rng.integers(-1, 8)),
             "draining": float(rng.random() < 0.1),
             "pipeline_inflight": float(rng.random() * 3),
             "pipeline_depth": float(rng.choice([0, 2, 3]))}
        out.append({k: v for k, v in s.items() if rng.random() < 0.9})
    return out


def test_health_score_identical():
    rng = np.random.default_rng(5)
    for stats in _random_stats(rng, 500):
        step = float(rng.integers(-1, 10))
        t = thealth.health_score(stats, step)
        assert t == jhealth.health_score(stats, step), stats
        assert 0.0 <= t <= 1.0
    assert thealth.STAT_FIELDS == jhealth.STAT_FIELDS
    assert thealth.STAGE_HISTOGRAMS == jhealth.STAGE_HISTOGRAMS


def test_routing_payload_ranking_identical():
    """The same joins and heartbeats give the same members, healths and
    ranking in both packages' routing tables."""
    rng = np.random.default_rng(6)
    stats = _random_stats(rng, 6)
    tables = []
    for member, client in ((jmember, jclient), (tmember, tclient)):
        group = member.ReplicaGroup(vnodes=32, heartbeat_ms=1000.0)
        for i, s in enumerate(stats):
            group.join(f"r{i}", "127.0.0.1", 7000 + i)
            group.heartbeat(f"r{i}", s)
        payload = group.routing_payload()
        table = client.RoutingTable(payload)
        tables.append(([(m["id"], m["health"], m["draining"])
                        for m in payload["members"]],
                       table.ranked(), table.ranked(exclude=("r0", "r3")),
                       _owners(table.ring)))
    assert tables[0][:3] == tables[1][:3]
    np.testing.assert_array_equal(tables[0][3], tables[1][3])


def test_adaptive_delay_identical():
    rng = np.random.default_rng(7)
    j = jhedge.AdaptiveDelay(window=64, floor_ms=1.0, ceil_ms=80.0,
                             initial_ms=25.0, min_samples=10)
    t = thedge.AdaptiveDelay(window=64, floor_ms=1.0, ceil_ms=80.0,
                             initial_ms=25.0, min_samples=10)
    lat = rng.lognormal(mean=1.5, sigma=1.0, size=1_000)
    for x in lat:
        j.observe(float(x))
        t.observe(float(x))
        assert t.delay_ms() == j.delay_ms()


def test_hedge_budget_identical():
    rng = np.random.default_rng(8)
    for ratio, burst in ((0.1, 8.0), (0.5, 1.0), (0.0, 0.0), (0.05, 3.0)):
        j, t = jhedge.HedgeBudget(ratio, burst), \
            thedge.HedgeBudget(ratio, burst)
        for op in rng.integers(0, 3, size=400):
            if op:
                j.on_request()
                t.on_request()
            else:
                assert t.try_spend() == j.try_spend()


def test_metrics_payload_ships_every_field():
    from multiverso_tpu.utils.configure import parse_cmd_flags
    del parse_cmd_flags
    j, t = jhealth.metrics_payload(), thealth.metrics_payload()
    assert set(t) == set(j)
    assert set(t["stages"]) == set(j["stages"])
    # The port ships the attribution sections as the JAX package does
    # when it cannot read them (ROADMAP A11).
    assert t["exemplars"] == [] and t["roofline"] == {}


# ---------------------------------------------------------------------------
# fleet_top
# ---------------------------------------------------------------------------
def _rollup() -> dict:
    """A Fleet_Stats rollup from the port's group after heartbeats that
    carry metric payloads, with a draining member, alerts, exemplars and
    roofline verdicts in it."""
    rng = np.random.default_rng(9)
    group = tmember.ReplicaGroup(vnodes=16, heartbeat_ms=1000.0)
    for i in range(3):
        group.join(f"replica-{i}", "127.0.0.1", 7100 + i)
    for step in range(3):
        for i in range(3):
            met = thealth.metrics_payload()
            met.update(requests=100 * step + 10 * i,
                       replies=100 * step + 9 * i, keys=800 * step + i,
                       shed=step, cancelled=i, slo_violations=step * i,
                       hot_keys=[[int(k), int(c)] for k, c in zip(
                           rng.integers(0, 1000, 4), rng.integers(1, 99, 4))],
                       alerts=[{"name": "serve.slo_burn", "severity": "page",
                                "value": 2.5, "for_s": 3.0}] if i == 1
                       else [],
                       roofline={"bound": "host"} if i == 2 else {},
                       exemplars=[{"trace": f"t{i}{step}", "total_ms":
                                   float(10 * i + step), "age_s": 1.0,
                                   "phases": {"device": 1.5,
                                              "queue": 0.5}}])
            group.heartbeat(f"replica-{i}", {
                "queue_depth": float(i), "inflight": 1.0,
                "max_queue": 64.0, "max_batch": 8.0,
                "draining": float(i == 0 and step == 2),
                "drains_completed": float(step)}, met)
    return group.stats_payload()


def test_fleet_top_render_identical():
    stats = _rollup()
    assert stats["replicas"] and stats["fleet"]["exemplars"]
    for clear in (False, True):
        assert ttop.render_stats(stats, clear=clear) == \
            jtop.render_stats(stats, clear=clear)
    assert ttop.render_exemplars(stats) == jtop.render_exemplars(stats)
    assert ttop.render_exemplars(stats, n=2) == \
        jtop.render_exemplars(stats, n=2)
    empty = {"schema": stats["schema"], "version": 0, "replicas": {},
             "fleet": {}, "router_alerts": []}
    assert ttop.render_stats(empty) == jtop.render_stats(empty)


# ---------------------------------------------------------------------------
# Rebalance
# ---------------------------------------------------------------------------
def _group(member, n: int, vnodes: int):
    g = member.ReplicaGroup(vnodes=vnodes, heartbeat_ms=1000.0)
    for i in range(n):
        g.join(f"r{i}", "127.0.0.1", 1000 + i)
    return g


def test_hot_key_sets_identical():
    """The same windows of served keys and heavy hitters promote and
    demote the same keys to the same replica sets."""
    rng = np.random.default_rng(10)
    groups = [_group(m, 4, 16) for m in (jmember, tmember)]
    reps = [mod.HotKeyReplicator(g, replicas=2, promote_share=0.02,
                                 demote_share=0.01, demote_windows=2,
                                 min_window_keys=100, topk=8)
            for mod, g in zip((jrebal, trebal), groups)]
    totals = np.zeros(4, np.int64)
    counts = {}
    for window in range(40):
        totals += rng.integers(0, 3_000, size=4)
        for i in range(4):
            if window % 10 == 9:
                totals[i] = 0       # a member restarted: counters reset
                counts = {k: v for k, v in counts.items() if k[0] != i}
            hot = []
            for key in rng.choice(200, size=6, replace=False):
                c = counts.get((i, int(key)), 0) + int(rng.integers(0, 400))
                counts[(i, int(key))] = c
                hot.append([int(key), c])
            for g in groups:
                g.heartbeat(f"r{i}", {}, {"keys": int(totals[i]),
                                          "hot_keys": hot})
        got = [rep.tick() for rep in reps]
        assert got[1] == got[0], window
        assert groups[1].hot_keys() == groups[0].hot_keys()
    assert any(groups[1].hot_keys() for _ in range(1))


@pytest.mark.parametrize("seed", [11, 12])
def test_migration_plans_identical(seed):
    """The same per-member load sequences arm the same migrations: the
    same (donor, target) at the same ticks and the same vnode
    overrides, with the same arcs picked from the same heavy hitters."""
    rng = np.random.default_rng(seed)
    groups = [_group(m, 3, 8) for m in (jmember, tmember)]
    drained = ([], [])
    rebs = [mod.FleetRebalancer(g, ratio=1.5, windows=2, cooldown_s=5.0,
                                move_vnodes=2,
                                drain_fn=lambda m, d=d: bool(d.append(m)))
            for mod, g, d in zip((jrebal, trebal), groups, drained)]
    plans = ([], [])
    for tick in range(30):
        hot = [[int(k), int(c)] for k, c in zip(
            rng.integers(0, 5_000, size=5), rng.integers(1, 900, size=5))]
        owner = f"r{int(rng.integers(0, 3))}"
        for g in groups:
            g.heartbeat(owner, {}, {"keys": 1_000 * (tick + 1),
                                    "hot_keys": hot})
        rates = {f"r{i}": float(x) for i, x in
                 enumerate(rng.choice([1.0, 50.0, 100.0, 400.0], size=3))}
        for reb, g, plan in zip(rebs, groups, plans):
            decided = reb.tick(rates, now=float(tick))
            if decided is not None:
                assert reb.join()
            plan.append((decided, tuple(g.vnode_overrides())))
    assert plans[1] == plans[0]
    assert drained[1] == drained[0]
    assert any(p[0] is not None for p in plans[0])


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------
def test_chaos_schedules_identical():
    """The same seed draws the same rounds of faults (targets, kinds,
    offsets, windows, parameters) in both packages."""
    from multiverso_tpu.fleet import chaos as jchaos
    from multiverso_tpu_torch.fleet import chaos as tchaos
    for seed in (0, 7, 123):
        plans = []
        for mod in (jchaos, tchaos):
            eng = mod.ChaosEngine(seed=seed)
            for name, kinds in (("ps-1", ("kill", "pause")),
                                ("ps-2", ("kill", "pause")),
                                ("replica-0", ("kill",))):
                eng.register_kill(name, lambda sig: None, kinds=kinds)
            plans.append([[f.as_dict() for f in eng.plan_round(2.0)]
                          for _ in range(8)])
        assert plans[1] == plans[0], seed


def test_chaos_round_applies_and_reverts():
    """A round over fake targets delivers each kill or pause (and the
    pause's SIGCONT), and the link and disk faults are reverted when
    their windows end."""
    import signal

    from multiverso_tpu_torch.core import wal
    from multiverso_tpu_torch.fleet.chaos import ChaosEngine, Fault
    from multiverso_tpu_torch.parallel import net

    got = []
    eng = ChaosEngine(seed=3)
    eng.register_kill("a", lambda sig: got.append(("a", sig)))
    eng.register_kill("b", lambda sig: got.append(("b", sig)))
    applied = eng.run_round([
        Fault("pause", "a", at_s=0.0, duration_s=0.05),
        Fault("kill", "b", at_s=0.01),
        Fault("net_drop", at_s=0.0, duration_s=0.05, param=0.5),
        Fault("wal_slow", at_s=0.0, duration_s=0.05, param=0.01)])
    assert [f["kind"] for f in applied] == ["pause", "net_drop",
                                            "wal_slow", "kill"]
    assert ("a", signal.SIGSTOP) in got and ("a", signal.SIGCONT) in got
    assert ("b", signal.SIGKILL) in got
    assert net._fault_hook is None and wal._fsync_delay_s == 0.0
    assert eng.events == applied


@pytest.mark.parametrize("argv", [
    [],
    ["-fleet_role=replica", "-fleet_router=10.0.0.1:7071",
     "-fleet_hedge=12.5", "-fleet_synthetic=1000x8@3",
     "-fleet_member_id=r7", "-fleet_supervise=true",
     "-fleet_rebalance=true", "-fleet_hotkey_replicas=2"],
    ["-fleet_role=local", "-fleet_hedge=off", "-fleet_synthetic=64X4",
     "-fleet_replicas=3", "-ps_fleet_shards=2", "-fleet_vnodes=16"]],
    ids=["defaults", "replica", "local"])
def test_fleet_config_identical(argv):
    """The same flags resolve to the same fleet configuration."""
    from multiverso_tpu.apps import _runner as jrunner
    from multiverso_tpu.utils import configure as jconf
    from multiverso_tpu_torch.apps import _runner as trunner
    from multiverso_tpu_torch.utils import configure as tconf
    try:
        assert jconf.parse_cmd_flags(list(argv)) == []
        assert tconf.parse_cmd_flags(list(argv)) == []
        assert trunner.fleet_config() == jrunner.fleet_config()
    finally:
        jconf.reset_flags()
        tconf.reset_flags()
