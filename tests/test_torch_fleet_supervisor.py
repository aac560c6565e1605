"""The port's ReplicaSupervisor decision core: the cases of
``tests/test_supervisor.py`` run against ``multiverso_tpu_torch.fleet``,
deterministic and tick-driven.

The supervisor's loop is a thin poller; every decision lives in
``tick(stats, now)``, so these tests drive synthetic ``Fleet_Stats``
payloads and fake process handles through it and assert the action log —
replacement triggers, hysteresis, cooldown, floors/ceilings — with no
real processes, sockets, or sleeps.
"""

import threading
import time

import numpy as np
import pytest

import _torch_port

torch = None
ReplicaSupervisor = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, ReplicaSupervisor
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.fleet.supervisor import ReplicaSupervisor


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


class FakeHandle:
    def __init__(self):
        self.alive = True
        self.terminated = 0

    def poll(self):
        return None if self.alive else 1

    def terminate(self):
        self.terminated += 1
        self.alive = False


class FakeView:
    def __init__(self):
        self.drained = []

    def stats(self):        # the loop path is not used in these tests
        return None

    def drain(self, member_id, timeout_s=30.0):
        self.drained.append(member_id)
        return True


def stats_for(member_ids, replica_alerts=(), router_alerts=()):
    """Minimal Fleet_Stats-shaped payload."""
    return {
        "replicas": {mid: {"alerts": [{"name": a} for a in replica_alerts]}
                     for mid in member_ids},
        "router_alerts": [{"name": a} for a in router_alerts],
    }


def make_supervisor(spawned, view=None, **kw):
    def spawn(slot):
        h = FakeHandle()
        spawned.append((slot, h))
        return h

    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("scale_up_windows", 3)
    kw.setdefault("scale_quiet_s", 30.0)
    kw.setdefault("join_grace_s", 20.0)
    return ReplicaSupervisor(view or FakeView(), spawn, **kw)


def test_dead_process_respawned_once_with_backoff():
    spawned = []
    sup = make_supervisor(spawned)
    h0 = FakeHandle()
    sup.adopt(0, h0)
    sup.tick(stats_for(["replica-0"]), now=100.0)
    assert not spawned                      # healthy: nothing happens
    h0.alive = False
    sup.tick(stats_for([]), now=101.0)      # dead + out of the ring
    assert [s for s, _ in spawned] == [0]
    assert sup.events()[-1]["trigger"] == "process_exit"
    # The fresh spawn is pending-join: repeated ticks inside the grace
    # window must NOT respawn again.
    sup.tick(stats_for([]), now=101.5)
    sup.tick(stats_for([]), now=110.0)
    assert len(spawned) == 1
    # It joins: pending clears, slot healthy again.
    sup.tick(stats_for(["replica-0"]), now=111.0)
    assert sup.status()["respawns"] == 1


def test_crash_loop_backs_off_exponentially():
    spawned = []
    sup = make_supervisor(spawned)
    h = FakeHandle()
    h.alive = False
    sup.adopt(0, h)
    t, respawn_times = 100.0, []
    for _ in range(200):
        sup.tick(stats_for([]), now=t)
        if spawned and not spawned[-1][1].alive is False:
            pass
        if spawned:
            spawned[-1][1].alive = False    # every incarnation dies
        if len(spawned) > len(respawn_times):
            respawn_times.append(t)
        t += 0.5
    gaps = np.diff(respawn_times)
    assert len(respawn_times) >= 3
    # Gaps grow (exponential backoff), and are capped.
    assert gaps[1] >= gaps[0]
    assert max(gaps) <= sup.max_respawn_backoff_s + 0.5


def test_heartbeat_loss_alert_triggers_replacement_of_live_process():
    """A member missing from the ring while its process LOOKS alive (a
    wedged replica) is replaced once the router's heartbeat-loss alert
    confirms the death — and the zombie is reaped first."""
    spawned = []
    sup = make_supervisor(spawned)
    h0 = FakeHandle()
    sup.adopt(0, h0)
    # Missing but no alert: the supervisor defers to the detector.
    sup.tick(stats_for([]), now=100.0)
    assert not spawned
    sup.tick(stats_for([], router_alerts=["fleet.heartbeat_loss"]),
             now=101.5)
    assert [s for s, _ in spawned] == [0]
    assert h0.terminated == 1               # zombie reaped
    assert sup.events()[-1]["trigger"] == "heartbeat_loss"


def test_scale_up_needs_sustained_alert_and_respects_ceiling():
    spawned = []
    sup = make_supervisor(spawned, max_replicas=2)
    sup.adopt(0, FakeHandle())
    base = stats_for(["replica-0"])
    burn = stats_for(["replica-0"], replica_alerts=["serve.slo_burn"])
    # A 2-window spike that recovers never scales (hysteresis).
    sup.tick(burn, now=100.0)
    sup.tick(burn, now=101.0)
    sup.tick(base, now=102.0)
    sup.tick(burn, now=103.0)
    sup.tick(burn, now=104.0)
    assert not spawned
    # Third consecutive bad window scales up exactly one slot.
    sup.tick(burn, now=105.0)
    sup.tick(burn, now=106.0)
    sup.tick(burn, now=107.0)
    assert [s for s, _ in spawned] == [1]
    # Ceiling: sustained burn at max_replicas never spawns more.
    burn2 = stats_for(["replica-0", "replica-1"],
                      replica_alerts=["serve.queue_saturation"])
    for i in range(10):
        sup.tick(burn2, now=120.0 + i)
    assert len(spawned) == 1
    assert sup.status()["scale_ups"] == 1


def test_cooldown_bounds_action_rate():
    spawned = []
    sup = make_supervisor(spawned, max_replicas=8, cooldown_s=50.0)
    sup.adopt(0, FakeHandle())
    burn = ["serve.slo_burn"]

    def members():
        return ["replica-0"] + [f"replica-{s}" for s, _ in spawned]

    t = 100.0
    for _ in range(30):                     # 30s of continuous burn
        sup.tick(stats_for(members(), replica_alerts=burn), now=t)
        t += 1.0
    # One scale-up at the 3rd window; everything after sat in cooldown.
    assert len(spawned) == 1
    from multiverso_tpu_torch.telemetry import get_registry
    assert get_registry().counter(
        "fleet.supervisor.skipped_cooldown").value > 0
    # Past the cooldown, the NEXT sustained streak may act again.
    for _ in range(30):
        sup.tick(stats_for(members(), replica_alerts=burn), now=t)
        t += 1.0
    assert len(spawned) == 2


def test_scale_down_after_quiet_only_scaled_up_slots(monkeypatch):
    spawned = []
    view = FakeView()
    sup = make_supervisor(spawned, view=view, min_replicas=1,
                          max_replicas=4, cooldown_s=5.0,
                          scale_quiet_s=20.0)
    sup.adopt(0, FakeHandle())              # baseline: never drained
    burn = stats_for(["replica-0"], replica_alerts=["serve.slo_burn"])
    for i in range(3):
        sup.tick(burn, now=100.0 + i)
    assert [s for s, _ in spawned] == [1]   # scaled up
    joined = stats_for(["replica-0", "replica-1"])
    # Quiet, but not long enough.
    sup.tick(joined, now=110.0)
    sup.tick(joined, now=120.0)
    assert sup.status()["scale_downs"] == 0
    # Long quiet: the SCALED-UP slot drains + stops; baseline survives.
    sup.tick(joined, now=131.0)
    deadline = time.monotonic() + 5
    while not view.drained and time.monotonic() < deadline:
        time.sleep(0.01)
    assert view.drained == ["replica-1"]
    deadline = time.monotonic() + 5
    while not spawned[0][1].terminated and time.monotonic() < deadline:
        time.sleep(0.01)
    assert spawned[0][1].terminated == 1
    assert sup.status()["slots"] == [0]
    # Further quiet never goes below the baseline/min floor.
    for i in range(100):
        sup.tick(stats_for(["replica-0"]), now=140.0 + i)
    assert sup.status()["slots"] == [0]
    assert sup.status()["scale_downs"] == 1
    # A LATER scale-up must take a FRESH index, never reuse the drained
    # slot's (two live processes behind one member id otherwise —
    # review finding).
    burn2 = stats_for(["replica-0"], replica_alerts=["serve.slo_burn"])
    for i in range(3):
        sup.tick(burn2, now=300.0 + i)
    assert [s for s, _ in spawned[1:]] == [2]


def test_retiring_slot_stays_reachable_until_stopped():
    """A scale-down victim mid-drain must remain in slots() — the
    owner's teardown stops every handle it can see, and a handle that
    vanished at drain START would outlive the owner as an orphan
    (review finding)."""
    spawned = []

    class SlowView(FakeView):
        def __init__(self):
            super().__init__()
            self.release = threading.Event()

        def drain(self, member_id, timeout_s=30.0):
            self.drained.append(member_id)
            self.release.wait(10)
            return True

    view = SlowView()
    sup = make_supervisor(spawned, view=view, cooldown_s=1.0,
                          scale_quiet_s=5.0)
    sup.adopt(0, FakeHandle())
    burn = stats_for(["replica-0"], replica_alerts=["serve.slo_burn"])
    for i in range(3):
        sup.tick(burn, now=100.0 + i)
    victim = spawned[0][1]
    joined = stats_for(["replica-0", "replica-1"])
    sup.tick(joined, now=110.0)
    sup.tick(joined, now=116.0)        # quiet long enough: scale-down
    deadline = time.monotonic() + 5
    while not view.drained and time.monotonic() < deadline:
        time.sleep(0.01)
    # Mid-drain: the victim is out of the MANAGED set but still in
    # slots(), un-terminated.
    assert 1 in sup.slots() and not victim.terminated
    view.release.set()
    deadline = time.monotonic() + 5
    while 1 in sup.slots() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert victim.terminated == 1
    assert 1 not in sup.slots()


def test_unreachable_view_holds_position():
    spawned = []
    sup = make_supervisor(spawned)
    h = FakeHandle()
    h.alive = False
    sup.adopt(0, h)
    sup.tick(None, now=100.0)       # view returned None (router down)
    assert not spawned              # no stats -> no action


def test_loop_runs_and_stops():
    spawned = []

    class LiveView(FakeView):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def stats(self):
            self.calls += 1
            return stats_for(["replica-0"])

    view = LiveView()
    sup = make_supervisor(spawned, view=view, poll_s=0.05)
    sup.adopt(0, FakeHandle())
    sup.start()
    deadline = time.monotonic() + 5
    while view.calls < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    sup.stop()
    assert view.calls >= 3
    assert not spawned
