"""Fleet supervisor: the ACTUATION half of the self-healing fleet.

Port of ``multiverso_tpu/fleet/supervisor.py``. The detection plane —
heartbeat-loss, SLO-burn, queue-saturation and shard-imbalance alerts —
fires, rides heartbeats into ``Fleet_Stats``, and shows in
``fleet_top``; a supervisor consumes the firing alerts and drives the
existing primitives:

* ``fleet.heartbeat_loss`` (or a managed process exiting) triggers
  **replacement**, not mere removal: the slot is respawned through the
  recovery path (a PS shard restores checkpoint+WAL; a serving replica
  reloads its checkpoint/synthetic table, re-warms, and rejoins the
  ring — the router re-routes to it on the next version bump).
* firing ``serve.slo_burn`` / ``serve.queue_saturation`` (any replica)
  sustained for ``scale_up_windows`` consecutive polls triggers
  **scale-up** — one new replica slot per action.
* every scale alert staying resolved for ``scale_quiet_s`` triggers
  **scale-down** of a replica the supervisor itself scaled up (never the
  baseline fleet), through the zero-drop ``rolling_drain`` primitive
  (drain -> stop) so no request is lost on the way down.

Anti-flap is structural, not advisory: a **global cooldown** bounds the
rate of ANY scaling action, scale-up needs N *consecutive* bad polls
(one spiky poll resets the count — the same hysteresis shape as the
alert state machines), scale-down needs a long all-quiet streak, and
per-slot respawns back off exponentially so a crash-looping binary
cannot hot-loop the spawner.

The supervisor is deliberately transport-agnostic: it reads ONE view —
the ``Fleet_Stats`` rollup schema — through either a
:class:`LocalFleetView` (in-process router, ``fleet_main -fleet_role=
local -fleet_supervise``) or a :class:`RemoteFleetView` (router in
another process), and acts
through caller-supplied ``spawn_fn``/``stop_fn`` so it can supervise
serving replicas and PS shards alike.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from multiverso_tpu_torch.telemetry import counter, gauge, watchdog_scope
from multiverso_tpu_torch.utils.log import log
from multiverso_tpu_torch.utils.locks import make_lock

#: Alert names whose firing drives scale-UP (replica-reported, shipped
#: on heartbeats into the rollup rows).
SCALE_ALERTS = ("serve.slo_burn", "serve.queue_saturation")


class LocalFleetView:
    """Fleet state read straight off an in-process :class:`FleetRouter`."""

    def __init__(self, router):
        self._router = router

    def stats(self) -> Optional[Dict]:
        return self._router.group.stats_payload()

    def drain(self, member_id: str, timeout_s: float = 30.0) -> bool:
        try:
            return self._router.drain(member_id, timeout_s=timeout_s)
        except Exception:  # noqa: BLE001 - a vanished member mid-drain
            return False


class RemoteFleetView:
    """Fleet state polled over the wire from a router in another
    process (``Fleet_Stats`` / ``Fleet_Drain``)."""

    def __init__(self, router_addr):
        self._addr = (str(router_addr[0]), int(router_addr[1]))

    def stats(self) -> Optional[Dict]:
        from multiverso_tpu_torch.fleet.client import fetch_fleet_stats
        try:
            return fetch_fleet_stats(self._addr)
        except Exception:  # noqa: BLE001 - router restarting/unreachable:
            return None    # skip the tick, never crash the supervisor

    def drain(self, member_id: str, timeout_s: float = 30.0) -> bool:
        from multiverso_tpu_torch.fleet.client import request_drain
        try:
            ack = request_drain(self._addr, member_id=member_id,
                                timeout_s=timeout_s)
            return bool(ack.get("started"))
        except Exception:  # noqa: BLE001 - best-effort: stop_fn still runs
            return False


class _Slot:
    __slots__ = ("index", "handle", "member_id", "scaled_up",
                 "pending_since", "missing_since", "respawn_backoff_s",
                 "last_respawn")

    def __init__(self, index: int, handle, member_id: str,
                 scaled_up: bool, now: float):
        self.index = index
        self.handle = handle
        self.member_id = member_id
        self.scaled_up = scaled_up
        #: set while the slot's member is expected but not yet in the
        #: rollup (fresh spawn warming/joining); cleared on first sight.
        self.pending_since: Optional[float] = now
        #: when an ESTABLISHED member first went missing from the rollup
        #: (distinct from the join grace — this is the detector-confirm
        #: clock, not the warm-up clock).
        self.missing_since: Optional[float] = None
        self.respawn_backoff_s = 1.0
        self.last_respawn = 0.0


def _alive(handle) -> bool:
    """subprocess.Popen-compatible liveness (poll() is None == alive);
    handles without poll() are treated as alive (in-process members own
    their own liveness through the membership sweep)."""
    poll = getattr(handle, "poll", None)
    return True if poll is None else poll() is None


class ReplicaSupervisor:
    """Alert-driven replacement + scaling over a set of managed slots.

    ``spawn_fn(slot_index) -> handle`` must bring up a replica whose
    member id is ``f"{member_prefix}{slot_index}"`` (the convention
    ``fleet_main``/``serve_bench`` already use); ``stop_fn(handle)``
    tears one down (default: ``handle.terminate()``). All decision logic
    lives in :meth:`tick` so tests and drills can drive it
    deterministically; :meth:`start` runs it on a daemon poll loop."""

    def __init__(self, view, spawn_fn: Callable[[int], object],
                 stop_fn: Optional[Callable[[object], None]] = None,
                 member_prefix: str = "replica-",
                 min_replicas: int = 1, max_replicas: int = 8,
                 cooldown_s: float = 10.0, poll_s: float = 0.5,
                 join_grace_s: float = 20.0,
                 scale_up_windows: int = 3,
                 scale_quiet_s: float = 30.0,
                 scale_alerts=SCALE_ALERTS,
                 max_respawn_backoff_s: float = 30.0):
        self.view = view
        self.spawn_fn = spawn_fn
        self.stop_fn = stop_fn or (lambda h: getattr(
            h, "terminate", lambda: None)())
        self.member_prefix = str(member_prefix)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.cooldown_s = float(cooldown_s)
        self.poll_s = max(0.05, float(poll_s))
        self.join_grace_s = float(join_grace_s)
        self.scale_up_windows = max(1, int(scale_up_windows))
        self.scale_quiet_s = float(scale_quiet_s)
        self.scale_alerts = tuple(scale_alerts)
        self.max_respawn_backoff_s = float(max_respawn_backoff_s)
        self._slots: Dict[int, _Slot] = {}
        #: scale-down victims whose drain->stop is still running on a
        #: background thread: no longer managed, but their handles must
        #: stay reachable (slots()) so an owner tearing the fleet down
        #: mid-drain doesn't orphan the process.
        self._retiring: Dict[int, _Slot] = {}
        #: monotonic: indices are NEVER reused — a scale-up racing a
        #: still-draining scale-down of the same index would put two
        #: live processes behind one member id.
        self._next_index = 0
        self._lock = make_lock("fleet.supervisor")
        self._burn_streak = 0
        self._quiet_since: Optional[float] = None
        self._last_action = 0.0       # global scaling cooldown stamp
        self._events: List[Dict] = []
        self._c_respawns = counter("fleet.supervisor.respawns")
        self._c_scale_ups = counter("fleet.supervisor.scale_ups")
        self._c_scale_downs = counter("fleet.supervisor.scale_downs")
        self._c_cooldown = counter("fleet.supervisor.skipped_cooldown")
        self._g_slots = gauge("fleet.supervisor.slots")
        self._g_live = gauge("fleet.supervisor.live")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- slot management -----------------------------------------------------
    def adopt(self, index: int, handle, scaled_up: bool = False) -> None:
        """Register an ALREADY-RUNNING replica under supervision (the
        bench/fleet_main spawned the baseline fleet before arming the
        supervisor)."""
        with self._lock:
            slot = _Slot(index, handle,
                         f"{self.member_prefix}{index}", scaled_up,
                         time.monotonic())
            slot.pending_since = None     # already joined
            self._slots[index] = slot
            self._next_index = max(self._next_index, index + 1)
            self._g_slots.set(len(self._slots))

    def slots(self) -> Dict[int, object]:
        """Every handle this supervisor is responsible for — managed
        slots AND scale-down victims mid-drain (the owner's teardown
        must stop those too or they outlive it as orphans). Indices
        never collide: they are monotonic across both maps."""
        with self._lock:
            out = {i: s.handle for i, s in self._retiring.items()}
            out.update({i: s.handle for i, s in self._slots.items()})
            return out

    def events(self) -> List[Dict]:
        """Action log (respawn/scale_up/scale_down dicts with reasons) —
        what the recovery drill embeds in its record."""
        with self._lock:
            return list(self._events)

    def _note(self, kind: str, **fields) -> None:
        fields.update(kind=kind, t_unix=time.time())
        self._events.append(fields)
        log.info("fleet supervisor: %s %s", kind,
                 {k: v for k, v in fields.items()
                  if k not in ("kind", "t_unix")})

    # -- decision core (deterministically drivable) --------------------------
    def tick(self, stats: Optional[Dict] = None,
             now: Optional[float] = None) -> None:
        """One supervision pass. ``stats`` is a ``Fleet_Stats`` payload
        (None = fetch from the view); ``now`` a monotonic stamp (tests
        pin it)."""
        now = time.monotonic() if now is None else now
        if stats is None:
            stats = self.view.stats()
        if stats is None:
            return                  # router unreachable: hold position
        rows = stats.get("replicas", {})
        router_alerts = {a.get("name") for a in
                         stats.get("router_alerts", [])}
        heartbeat_loss = "fleet.heartbeat_loss" in router_alerts
        with self._lock:
            self._replace_dead(rows, heartbeat_loss, now)
            self._maybe_scale(rows, now)
            self._g_slots.set(len(self._slots))
            self._g_live.set(sum(1 for s in self._slots.values()
                                 if s.member_id in rows))

    def _replace_dead(self, rows: Dict, heartbeat_loss: bool,
                      now: float) -> None:
        for slot in list(self._slots.values()):
            if slot.member_id in rows:
                slot.pending_since = None
                slot.missing_since = None
                slot.respawn_backoff_s = 1.0      # healthy: reset backoff
                continue
            process_dead = not _alive(slot.handle)
            trigger = None
            if process_dead:
                trigger = "process_exit"
            elif slot.pending_since is not None:
                # Fresh spawn still warming/joining: its grace outranks
                # even a (possibly stale) heartbeat-loss alert — the
                # alert the ORIGINAL death raised may still be resolving
                # while the replacement warms, and killing the warming
                # replacement for it would crash-loop the slot.
                if now - slot.pending_since < self.join_grace_s:
                    continue
                trigger = "join_timeout"
            elif heartbeat_loss:
                # Established member gone + the router's detector says a
                # death happened: replace now (loss means replacement,
                # not removal).
                trigger = "heartbeat_loss"
            else:
                # Missing with no confirmation yet: start the clock and
                # defer to the detector — but not forever (the alert is
                # transient and a slow poll can miss it entirely).
                if slot.missing_since is None:
                    slot.missing_since = now
                    continue
                if now - slot.missing_since < self.join_grace_s:
                    continue
                trigger = "missing_timeout"
            # Replacement path. Backoff gates a crash-looping binary.
            if now - slot.last_respawn < slot.respawn_backoff_s:
                continue
            if not process_dead:
                try:
                    self.stop_fn(slot.handle)     # reap the zombie seat
                except Exception:  # noqa: BLE001 - already half-dead
                    pass
            try:
                slot.handle = self.spawn_fn(slot.index)
            except Exception as e:  # noqa: BLE001 - spawn may transiently
                log.error("fleet supervisor: respawn of slot %d failed: "
                          "%s", slot.index, e)      # fail; backoff+retry
                slot.last_respawn = now
                slot.respawn_backoff_s = min(slot.respawn_backoff_s * 2,
                                             self.max_respawn_backoff_s)
                continue
            slot.pending_since = now
            slot.missing_since = None
            slot.last_respawn = now
            slot.respawn_backoff_s = min(slot.respawn_backoff_s * 2,
                                         self.max_respawn_backoff_s)
            self._c_respawns.inc()
            self._note("respawn", slot=slot.index,
                       member=slot.member_id, trigger=trigger)

    def _scale_alert_firing(self, rows: Dict) -> bool:
        for row in rows.values():
            for a in row.get("alerts", []):
                if a.get("name") in self.scale_alerts:
                    return True
        return False

    def _maybe_scale(self, rows: Dict, now: float) -> None:
        firing = self._scale_alert_firing(rows)
        if firing:
            self._burn_streak += 1
            self._quiet_since = None
        else:
            self._burn_streak = 0
            if self._quiet_since is None:
                self._quiet_since = now
        in_cooldown = now - self._last_action < self.cooldown_s
        # Scale UP: sustained burn, below ceiling, out of cooldown.
        if self._burn_streak >= self.scale_up_windows:
            if len(self._slots) >= self.max_replicas:
                return
            if in_cooldown:
                self._c_cooldown.inc()
                return
            index = self._next_index
            self._next_index += 1
            try:
                handle = self.spawn_fn(index)
            except Exception as e:  # noqa: BLE001 - retry next streak
                log.error("fleet supervisor: scale-up spawn failed: %s", e)
                self._last_action = now
                return
            slot = _Slot(index, handle, f"{self.member_prefix}{index}",
                         scaled_up=True, now=now)
            self._slots[index] = slot
            self._last_action = now
            self._burn_streak = 0          # re-arm: next action needs a
            self._c_scale_ups.inc()        # fresh sustained streak
            self._note("scale_up", slot=index, member=slot.member_id)
            return
        # Scale DOWN: long all-quiet, only slots WE scaled up, floor
        # respected, out of cooldown. Drain first — zero-drop descent.
        if self._quiet_since is None or \
                now - self._quiet_since < self.scale_quiet_s:
            return
        candidates = [s for s in self._slots.values() if s.scaled_up
                      and s.member_id in rows]
        if not candidates or len(self._slots) <= self.min_replicas:
            return
        if in_cooldown:
            self._c_cooldown.inc()
            return
        victim = max(candidates, key=lambda s: s.index)
        self._last_action = now
        self._quiet_since = now            # one step per quiet period
        del self._slots[victim.index]
        self._retiring[victim.index] = victim
        self._c_scale_downs.inc()
        self._note("scale_down", slot=victim.index,
                   member=victim.member_id)
        # Drain + stop off the tick path (a drain cycle takes seconds;
        # the supervisor must keep watching the rest of the fleet).
        threading.Thread(target=self._drain_and_stop, args=(victim,),
                         name="fleet-supervisor-drain",
                         daemon=True).start()

    def _drain_and_stop(self, slot: _Slot) -> None:
        try:
            self.view.drain(slot.member_id, timeout_s=30.0)
        finally:
            try:
                self.stop_fn(slot.handle)
            except Exception as e:  # noqa: BLE001 - stop is best-effort
                log.error("fleet supervisor: stop of slot %d failed: %s",
                          slot.index, e)
            finally:
                with self._lock:
                    self._retiring.pop(slot.index, None)

    # -- loop ----------------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        with watchdog_scope("fleet-supervisor", timeout_s=120.0) as wd:
            # supervisor ticker: control-plane cadence, not a request
            # graftlint: disable=unattributed-wait
            while not self._stop.wait(self.poll_s):
                wd.beat()
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 - the healer must
                    log.error("fleet supervisor tick failed: %s", e)
                    counter("fleet.supervisor.tick_errors").inc()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def status(self) -> Dict:
        # Action counts derive from THIS instance's event log — the
        # telemetry counters are process-global and two supervisors in
        # one process (the bench runs one per drill leg) must not read
        # each other's actions.
        with self._lock:
            by_kind: Dict[str, int] = {}
            for e in self._events:
                by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
            return {
                "slots": sorted(self._slots),
                "scaled_up_slots": sorted(s.index
                                          for s in self._slots.values()
                                          if s.scaled_up),
                "respawns": by_kind.get("respawn", 0),
                "scale_ups": by_kind.get("scale_up", 0),
                "scale_downs": by_kind.get("scale_down", 0),
                "events": list(self._events),
            }
