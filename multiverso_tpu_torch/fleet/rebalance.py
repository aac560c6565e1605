"""Skew actuators: hot-key replication + vnode drain-and-handoff.

Port of ``multiverso_tpu/fleet/rebalance.py``: the same hot-key sets
and migration plans. The traffic sketches and the shard-imbalance alert
are the senses; this module is the muscles (docs/DESIGN.md "Skew
actuation"). Both actuators tick from the router's sweep loop —
heartbeat cadence, the same clock the load gauges advance on — and act
through the ReplicaGroup, so everything they decide ships to clients in
the next routing payload.

* :class:`HotKeyReplicator` — nominates the Space-Saving confident hot
  keys for replication to R extra ring owners. Confidence is a WINDOWED
  traffic share: cumulative merged counts are differentiated per tick,
  a key promotes when its share of the window's served keys crosses
  ``promote_share``, and demotes only after ``demote_windows``
  consecutive windows below ``demote_share`` (promotion hysteresis is
  free — a key that just crossed the bar IS hot; demotion without
  hysteresis would flap on every quiet window). The replica list is the
  ring's successor set, so it survives membership changes by
  recomputation, not protocol.
* :class:`FleetRebalancer` — when imbalance SURVIVES replication (a hot
  range, not a hot key), migrates vnode ownership of the donor's
  hottest arcs to the coldest member via drain → transfer → announce:
  queue a drain directive (new traffic leaves the donor; it finishes
  in-flight work through the member's hot-swap lifecycle, which flushes any
  WAL'd acked state), apply the vnode overrides while the donor is out
  of the ring (transfer), and let the version bump re-publish the table
  (announce) — clients park-and-retry through the flip exactly as they
  do through shard recovery. Supervisor-style hysteresis: ``windows``
  consecutive bad sweeps to arm, ``cooldown_s`` between migrations, one
  migration in flight at a time.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.fleet.membership import ReplicaGroup
from multiverso_tpu_torch.telemetry import counter, gauge
from multiverso_tpu_torch.telemetry.sketch import load_ratio
from multiverso_tpu_torch.utils.log import log


class HotKeyReplicator:
    """Promote/demote confident hot keys into the group's replicated map.

    ``replicas`` is the number of EXTRA owners per hot key (the routing
    payload ships ``1 + replicas`` members, home owner first). ``tick()``
    is cheap enough for heartbeat cadence: one pass over the merged
    heavy-hitter summaries the members already ship."""

    def __init__(self, group: ReplicaGroup, replicas: int = 1,
                 promote_share: float = 0.02,
                 demote_share: Optional[float] = None,
                 demote_windows: int = 3,
                 min_window_keys: int = 200, topk: int = 16):
        self.group = group
        self.replicas = max(1, int(replicas))
        self.promote_share = float(promote_share)
        self.demote_share = float(demote_share) if demote_share is not None \
            else self.promote_share / 2.0
        self.demote_windows = max(1, int(demote_windows))
        self.min_window_keys = int(min_window_keys)
        self.topk = int(topk)
        self._prev: Dict[int, int] = {}
        self._prev_total = 0
        self._hot: Dict[int, int] = {}   # key -> consecutive cold windows
        self.last_shares: Dict[int, float] = {}

    def tick(self) -> Dict[int, List[str]]:
        """One nomination pass; returns (and installs) the replicated
        map. Idempotent when nothing changed — ``set_hot_keys`` only
        bumps the routing version on a real delta."""
        merged, total = self.group.hot_key_counts()
        window = total - self._prev_total
        if window < 0:
            # A member restarted and its counters reset: resynchronize
            # the baseline, judge again next window.
            self._prev, self._prev_total = merged, total
            return self._publish()
        deltas = {k: merged[k] - self._prev.get(k, 0) for k in merged}
        self._prev, self._prev_total = merged, total
        if window < self.min_window_keys:
            return self._publish()   # too little traffic to judge
        shares = {k: d / window for k, d in deltas.items() if d > 0}
        self.last_shares = shares
        for key, share in shares.items():
            if share >= self.promote_share:
                self._hot[key] = 0
        for key in list(self._hot):
            if shares.get(key, 0.0) < self.demote_share:
                self._hot[key] += 1
                if self._hot[key] >= self.demote_windows:
                    del self._hot[key]       # left the confident set
            else:
                self._hot[key] = 0
        if len(self._hot) > self.topk:
            keep = sorted(self._hot,
                          key=lambda k: -shares.get(k, 0.0))[:self.topk]
            self._hot = {k: self._hot[k] for k in keep}
        return self._publish()

    def _publish(self) -> Dict[int, List[str]]:
        ring = self.group.ring
        if not len(ring):
            mapping: Dict[int, List[str]] = {}
        else:
            mapping = {k: ring.replica_set(k, 1 + self.replicas)
                       for k in self._hot}
        self.group.set_hot_keys(mapping)
        return mapping


class FleetRebalancer:
    """Vnode drain-and-handoff migration, armed by sustained imbalance.

    ``drain_fn`` (optional) replaces the built-in drain-wait — tests
    inject a synchronous stub. ``tick(rates)`` consumes the same
    per-member keys-rate dict ``publish_load_gauges`` returns, so the
    rebalancer and the imbalance alert literally read one signal."""

    def __init__(self, group: ReplicaGroup,
                 ratio: float = 1.5, windows: int = 3,
                 cooldown_s: float = 10.0, move_vnodes: int = 4,
                 drain_timeout_s: float = 60.0,
                 drain_fn: Optional[Callable[[str], bool]] = None):
        self.group = group
        self.ratio = float(ratio)
        self.windows = max(1, int(windows))
        self.cooldown_s = float(cooldown_s)
        self.move_vnodes = max(1, int(move_vnodes))
        self.drain_timeout_s = float(drain_timeout_s)
        self._drain_fn = drain_fn
        self._streak = 0
        self._last_action = -float("inf")
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.migrations_started = 0
        self._c_migrations = counter("fleet.rebalance.migrations")
        self._c_completed = counter("fleet.rebalance.completed")
        self._c_stalled = counter("fleet.rebalance.stalled")
        self._g_streak = gauge("fleet.rebalance.streak")

    # -- decision ------------------------------------------------------------
    def tick(self, rates: Dict[str, float],
             now: Optional[float] = None) -> Optional[Tuple[str, str]]:
        """One hysteresis step; starts (and returns) a ``(donor,
        target)`` migration when armed, else None. Deterministic given
        ``now`` — the chaos/tier-1 tests drive it with a fake clock."""
        now = time.monotonic() if now is None else now
        if self._worker is not None and self._worker.is_alive():
            return None              # one handoff in flight at a time
        if len(rates) < 2 or load_ratio(list(rates.values())) < self.ratio:
            self._streak = 0
            self._g_streak.set(0)
            return None
        self._streak += 1
        self._g_streak.set(self._streak)
        if self._streak < self.windows:
            return None
        if now - self._last_action < self.cooldown_s:
            return None
        donor = max(rates, key=lambda m: rates[m])
        target = min(rates, key=lambda m: rates[m])
        if donor == target:
            return None
        arcs = self._pick_arcs(donor)
        if not arcs:
            return None
        self._streak = 0
        self._g_streak.set(0)
        self._last_action = now
        self.migrations_started += 1
        self._c_migrations.inc()
        log.info("fleet: rebalance migrating %d arc(s) %s -> %s",
                 len(arcs), donor, target)
        self._worker = threading.Thread(
            target=self._migrate, args=(donor, target, arcs),
            name="fleet-rebalance", daemon=True)
        self._worker.start()
        return donor, target

    def _pick_arcs(self, donor: str) -> List[Tuple[str, int]]:
        """The donor's hottest vnode arcs, ranked by merged heavy-hitter
        traffic falling on them; blind fallback (its first un-overridden
        arcs) when no sketch data attributes the heat."""
        ring = self.group.ring
        if donor not in ring:
            return []
        merged, _total = self.group.hot_key_counts()
        weights: Dict[Tuple[str, int], int] = {}
        if merged:
            keys = np.fromiter(merged.keys(), dtype=np.int64,
                               count=len(merged))
            owners = ring.owner_indices(keys)
            arc_ids = ring.arc_ids(keys)
            for key, oi, arc in zip(keys.tolist(), owners.tolist(),
                                    arc_ids):
                if ring.members[oi] == donor:
                    weights[arc] = weights.get(arc, 0) + merged[key]
        if weights:
            ranked = sorted(weights, key=lambda a: -weights[a])
            return ranked[:self.move_vnodes]
        overridden = {(m, v) for m, v, _t in ring.overrides}
        return [(donor, v) for v in range(ring.vnodes)
                if (donor, v) not in overridden][:self.move_vnodes]

    # -- actuation -----------------------------------------------------------
    def _migrate(self, donor: str, target: str,
                 arcs: List[Tuple[str, int]]) -> None:
        self.group.set_migrations({donor: 1, target: 1})
        ok = False
        try:
            if self._drain_fn is not None:
                # Injected drive (tests): run the whole cycle, then flip.
                self._drain_fn(donor)
                self._apply(arcs, target)
                ok = True
                return
            # DRAIN: queue the directive — the donor leaves the ring on
            # its next heartbeat and finishes in-flight work through the
            # hot-swap lifecycle (quiesce flushes WAL'd acked state).
            before = self.group.drains_completed(donor)
            if before is None:
                return
            self.group.drain(donor)
            # TRANSFER: flip arc ownership while the donor is quiescing;
            # by the time it rejoins, the migrated arcs already point at
            # the target. ANNOUNCE is the version bump this causes.
            self._apply(arcs, target)
            # Wait out the donor's drain cycle — exponential backoff off
            # the stop Event, not a constant-interval poll (the
            # poll-loop-no-backoff shape).
            deadline = time.monotonic() + self.drain_timeout_s
            delay = 0.01
            # rebalancer drain-cycle wait: requests keep flowing on the
            # donor's still-open serving path, none block here
            # graftlint: disable=unattributed-wait
            while not self._stop.wait(delay):
                done = self.group.drains_completed(donor)
                if done is None:
                    return      # donor died mid-drain; sweep took it —
                                # the overrides stand, ownership is
                                # already with the target.
                if done > before and not self.group.is_draining(donor):
                    ok = True
                    return
                if time.monotonic() > deadline:
                    return
                delay = min(delay * 2.0, 1.0)
        finally:
            (self._c_completed if ok else self._c_stalled).inc()
            self.group.set_migrations({})
            log.info("fleet: rebalance %s -> %s %s", donor, target,
                     "complete" if ok else "stalled")

    def _apply(self, arcs: List[Tuple[str, int]], target: str) -> None:
        cur = {(m, v): t for m, v, t in self.group.vnode_overrides()}
        for place, vnode in arcs:
            if target == place:
                cur.pop((place, vnode), None)   # handing back home
            else:
                cur[(place, vnode)] = target
        self.group.apply_vnode_overrides(
            [(m, v, t) for (m, v), t in cur.items()])

    # -- lifecycle -----------------------------------------------------------
    @property
    def migrating(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def join(self, timeout_s: float = 10.0) -> bool:
        """Test hook: wait for the in-flight migration to settle."""
        worker = self._worker
        if worker is not None:
            worker.join(timeout=timeout_s)
            return not worker.is_alive()
        return True

    def close(self) -> None:
        self._stop.set()
        self.join(timeout_s=5.0)
