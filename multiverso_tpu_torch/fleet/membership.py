"""Replica-group membership: join/leave/heartbeat over the DCN framing.

Port of ``multiverso_tpu/fleet/membership.py``.

Two halves of one protocol (``Fleet_*`` MsgTypes, ``core/actor.py``):

* :class:`ReplicaGroup` — the ROUTER-side authority. Tracks members,
  their last heartbeat and load stats, computes health scores, sweeps the
  dead (``liveness_misses`` missed heartbeats), and maintains a
  monotonically-versioned routing table. The consistent-hash ring is a
  pure function of the live non-draining member ids (``hashring.py``), so
  clients rebuild the identical ring from the shipped id list.
* :class:`FleetMember` — the REPLICA-side agent embedded in a serving
  process. One daemon thread dials the router (capped-backoff connect),
  joins, then heartbeats at the router-assigned cadence, reporting the
  load stats its own ``serve.*`` gauges already export. Heartbeat REPLIES
  carry directives: ``drain`` starts the rolling-swap lifecycle (finish
  in-flight batches -> hot-swap checkpoint -> re-warm every bucket
  executable -> rejoin), ``rejoin`` re-registers after a router restart.

The member keeps SERVING throughout a drain — draining only removes it
from the ring so new traffic routes elsewhere; requests that still arrive
(stale client tables, in-flight hedges) are answered, which is why a
rolling fleet upgrade drops zero requests.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from multiverso_tpu_torch.core.actor import Message, MsgType
from multiverso_tpu_torch.fleet.hashring import HashRing
from multiverso_tpu_torch.fleet.health import (STAT_FIELDS, health_score,
                                               local_stats, metrics_payload)
from multiverso_tpu_torch.parallel.net import (pack_json_blob, recv_message,
                                               send_message, unpack_json_blob)
from multiverso_tpu_torch.telemetry import counter, gauge, span, watchdog_scope
from multiverso_tpu_torch.utils.log import check, log
from multiverso_tpu_torch.utils.locks import make_lock


class MemberInfo:
    """Router-side record of one replica."""

    __slots__ = ("id", "host", "port", "stats", "last_seen", "joined_at",
                 "directive", "metrics", "history")

    #: Rate window: counter deltas are differentiated over the oldest
    #: retained sample within this horizon — long enough to smooth
    #: heartbeat jitter, short enough that fleet_top tracks load shifts.
    RATE_WINDOW_S = 5.0

    def __init__(self, member_id: str, host: str, port: int):
        self.id = member_id
        self.host = host
        self.port = int(port)
        self.stats: Dict[str, float] = {}
        self.last_seen = time.monotonic()
        self.joined_at = time.monotonic()
        self.directive = "none"
        #: Latest compact metric snapshot from the heartbeat ({} until
        #: the first metrics-bearing beat arrives).
        self.metrics: Dict = {}
        #: (t_monotonic, requests, replies, shed) samples for rates.
        self.history: "collections.deque" = collections.deque(maxlen=64)

    def observe_metrics(self, metrics: Dict, now: float) -> None:
        self.metrics = metrics
        self.history.append((now, float(metrics.get("requests", 0)),
                             float(metrics.get("replies", 0)),
                             float(metrics.get("shed", 0)),
                             float(metrics.get("keys", 0))))
        # Keep at least TWO samples even when the heartbeat interval
        # exceeds the window — rates() needs a baseline, and a sparse
        # heartbeat must degrade to "rate over one beat", not to zeros.
        while len(self.history) > 2 and now - self.history[0][0] \
                > self.RATE_WINDOW_S:
            self.history.popleft()

    def rates(self) -> Dict[str, float]:
        """QPS / shed-rate / served-keys rate over the retained window
        (zeros until two samples exist — rates need a baseline, not a
        guess)."""
        if len(self.history) < 2:
            return {"qps": 0.0, "request_rate": 0.0, "shed_rate": 0.0,
                    "keys_rate": 0.0}
        t0, req0, rep0, shed0, keys0 = self.history[0]
        t1, req1, rep1, shed1, keys1 = self.history[-1]
        dt = max(t1 - t0, 1e-6)
        d_req = max(req1 - req0, 0.0)
        d_shed = max(shed1 - shed0, 0.0)
        return {"qps": round(max(rep1 - rep0, 0.0) / dt, 3),
                "request_rate": round(d_req / dt, 3),
                "shed_rate": round(d_shed / max(d_req + d_shed, 1.0), 5),
                "keys_rate": round(max(keys1 - keys0, 0.0) / dt, 3)}

    @property
    def draining(self) -> bool:
        return bool(self.stats.get("draining", 0.0))

    @property
    def step(self) -> float:
        return float(self.stats.get("replica_step", -1.0))

    @property
    def drains_completed(self) -> int:
        return int(self.stats.get("drains_completed", 0.0))


class ReplicaGroup:
    """Membership + health + ring, versioned. Thread-safe."""

    def __init__(self, vnodes: int = 64, heartbeat_ms: float = 100.0,
                 liveness_misses: int = 5):
        check(heartbeat_ms > 0, "heartbeat interval must be positive")
        self.vnodes = int(vnodes)
        self.heartbeat_ms = float(heartbeat_ms)
        self.liveness_misses = max(1, int(liveness_misses))
        self._lock = make_lock("fleet.membership")
        self._members: Dict[str, MemberInfo] = {}
        self._version = 0
        self._stats_seq = 0     # bumps per metrics-bearing heartbeat
        self._ring = HashRing((), vnodes=self.vnodes)
        # Skew actuation state (docs/DESIGN.md "Skew actuation"), owned
        # here because both ship in the routing payload: replicated hot
        # keys (key -> ordered member list, home owner first) and vnode
        # ownership overrides ((placing member, vnode) -> target).
        self._hot_replicas: Dict[int, List[str]] = {}
        self._overrides: Dict[Tuple[str, int], str] = {}
        #: Per-member count of migrations currently in flight (donor and
        #: target both count one per active handoff) — display state for
        #: fleet_top's REBAL column, no routing semantics.
        self._migrations: Dict[str, int] = {}
        self._g_members = gauge("fleet.members")
        self._g_version = gauge("fleet.ring_version")
        self._c_joins = counter("fleet.joins")
        self._c_heartbeats = counter("fleet.heartbeats")
        self._c_dead = counter("fleet.member_dead")
        self._g_hot = gauge("fleet.hotkey.replicated")
        self._g_overrides = gauge("fleet.rebalance.overrides")

    # -- protocol handlers ---------------------------------------------------
    def join(self, member_id: str, host: str, port: int) -> Dict:
        with self._lock:
            fresh = member_id not in self._members
            info = MemberInfo(member_id, host, port)
            self._members[member_id] = info
            self._bump_locked()
            self._c_joins.inc()
            if fresh:
                log.info("fleet: member %s joined at %s:%d (now %d)",
                         member_id, host, port, len(self._members))
            return {"ok": True, "version": self._version,
                    "heartbeat_ms": self.heartbeat_ms,
                    "liveness_misses": self.liveness_misses}

    def heartbeat(self, member_id: str, stats: Dict[str, float],
                  metrics: Optional[Dict] = None) -> Dict:
        with self._lock:
            info = self._members.get(member_id)
            self._c_heartbeats.inc()
            if info is None:
                # Router restarted (or swept this member): ask it to
                # re-register rather than silently resurrecting it here —
                # the join reply re-delivers the cadence contract.
                return {"directive": "rejoin", "version": self._version}
            was_draining = info.draining
            info.stats = {k: float(stats.get(k, 0.0)) for k in STAT_FIELDS}
            info.last_seen = time.monotonic()
            if metrics:
                info.observe_metrics(dict(metrics), info.last_seen)
                self._stats_seq += 1
            directive = info.directive
            # Directive delivery is the TCP reply — clear it now. A
            # sub-heartbeat drain (quiesce + warm finish before the next
            # beat) must not be re-delivered forever; completion is
            # tracked by the member's monotonic drains_completed stat,
            # not by catching the draining=1 window in flight.
            info.directive = "none"
            if info.draining != was_draining:
                self._bump_locked()           # ring membership changed
            return {"directive": directive, "version": self._version}

    def leave(self, member_id: str) -> Dict:
        with self._lock:
            if self._members.pop(member_id, None) is not None:
                self._bump_locked()
                log.info("fleet: member %s left (now %d)", member_id,
                         len(self._members))
            return {"ok": True, "version": self._version}

    def sweep(self) -> List[str]:
        """Remove members whose heartbeat is older than
        ``liveness_misses`` intervals; returns the ids removed."""
        horizon = self.liveness_misses * self.heartbeat_ms / 1e3
        now = time.monotonic()
        dead: List[str] = []
        with self._lock:
            for mid, info in list(self._members.items()):
                if now - info.last_seen > horizon:
                    del self._members[mid]
                    dead.append(mid)
            if dead:
                self._bump_locked()
                self._c_dead.inc(len(dead))
        for mid in dead:
            log.warning("fleet: member %s missed %d heartbeats — removed",
                        mid, self.liveness_misses)
        return dead

    def publish_load_gauges(self) -> Dict[str, float]:
        """Per-replica served-key rates -> the two registry gauges the
        shard-imbalance alert rule reads (``fleet.shard_load_ratio`` /
        ``fleet.shard_keys_rate``). Called from the router's sweep loop
        so the ratio series advances whether or not anyone pulls
        ``Fleet_Stats``; live (non-draining) members only — a draining
        replica's fading rate is a planned event, not skew."""
        from multiverso_tpu_torch.telemetry.sketch import load_ratio
        with self._lock:
            members = [m for m in self._members.values()
                       if not m.draining]
        rates = {m.id: m.rates()["keys_rate"] for m in members}
        total = sum(rates.values())
        ratio = load_ratio(list(rates.values())) if len(rates) >= 2 \
            else 1.0
        gauge("fleet.shard_keys_rate").set(total)
        gauge("fleet.shard_load_ratio").set(ratio)
        return rates

    # -- control -------------------------------------------------------------
    def drain(self, member_id: str) -> None:
        """Queue a drain directive; delivered on the next heartbeat."""
        with self._lock:
            check(member_id in self._members,
                  f"unknown fleet member '{member_id}'")
            self._members[member_id].directive = "drain"
            counter("fleet.drains").inc()

    def member_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def is_draining(self, member_id: str) -> Optional[bool]:
        with self._lock:
            info = self._members.get(member_id)
            return None if info is None else \
                (info.draining or info.directive == "drain")

    def drains_completed(self, member_id: str) -> Optional[int]:
        """The member's monotonic drain-cycle count (None if gone)."""
        with self._lock:
            info = self._members.get(member_id)
            return None if info is None else info.drains_completed

    # -- routing table -------------------------------------------------------
    def _bump_locked(self) -> None:
        self._version += 1
        routable = sorted(m.id for m in self._members.values()
                          if not m.draining)
        # Overrides ride along unconditionally: HashRing drops any whose
        # placer/target is not routable (the fail-safe revert).
        self._ring = HashRing(routable, vnodes=self.vnodes,
                              overrides=[(m, v, t) for (m, v), t
                                         in self._overrides.items()])
        self._g_members.set(len(self._members))
        self._g_version.set(self._version)

    # -- skew actuation (docs/DESIGN.md "Skew actuation") --------------------
    def hot_key_counts(self) -> Tuple[Dict[int, int], int]:
        """Merged CUMULATIVE heavy-hitter counts across live members
        (counts sum per key — SpaceSaving's merge rule) plus the total
        served-keys count: the replicator differentiates these into
        per-window traffic shares."""
        with self._lock:
            members = [m for m in self._members.values() if not m.draining]
        merged: Dict[int, int] = {}
        total = 0
        for m in members:
            met = m.metrics
            total += int(met.get("keys", 0))
            for key, cnt in met.get("hot_keys", []):
                merged[int(key)] = merged.get(int(key), 0) + int(cnt)
        return merged, total

    def set_hot_keys(self, mapping: Dict[int, List[str]]) -> None:
        """Replace the replicated-hot-key map (key -> ordered member
        list, home owner first). Called from the router's sweep tick;
        bumps the routing version only when the map actually changed so
        a steady confident set doesn't churn client tables."""
        mapping = {int(k): [str(m) for m in v] for k, v in mapping.items()}
        with self._lock:
            if mapping == self._hot_replicas:
                return
            promoted = len(set(mapping) - set(self._hot_replicas))
            demoted = len(set(self._hot_replicas) - set(mapping))
            self._hot_replicas = mapping
            self._bump_locked()
        if promoted:
            counter("fleet.hotkey.promotions").inc(promoted)
        if demoted:
            counter("fleet.hotkey.demotions").inc(demoted)
        self._g_hot.set(len(mapping))

    def hot_keys(self) -> Dict[int, List[str]]:
        with self._lock:
            return {k: list(v) for k, v in self._hot_replicas.items()}

    def apply_vnode_overrides(
            self, triples: Iterable[Tuple[str, int, str]]) -> None:
        """Replace ALL vnode ownership overrides (the rebalancer's
        transfer+announce step: the rebuilt ring and version bump make
        every client park-and-retry onto the new owner)."""
        staged = {(str(m), int(v)): str(t) for m, v, t in triples}
        with self._lock:
            if staged == self._overrides:
                return
            self._overrides = staged
            self._bump_locked()
        self._g_overrides.set(len(staged))

    def vnode_overrides(self) -> List[Tuple[str, int, str]]:
        with self._lock:
            return sorted((m, v, t) for (m, v), t
                          in self._overrides.items())

    def set_migrations(self, per_member: Dict[str, int]) -> None:
        """Display-plane only (fleet_top REBAL column): per-member count
        of handoffs in flight. No version bump — nothing routes on it."""
        with self._lock:
            self._migrations = {str(k): int(v)
                                for k, v in per_member.items() if v}

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def ring(self) -> HashRing:
        with self._lock:
            return self._ring

    def routing_payload(self) -> Dict:
        """JSON-able routing table for ``Fleet_Route`` replies: ids,
        addresses, health scores. Clients rebuild the ring from the ids."""
        with self._lock:
            members = list(self._members.values())
            version = self._version
            hot = {str(k): list(v) for k, v in self._hot_replicas.items()}
            overrides = sorted([m, v, t] for (m, v), t
                               in self._overrides.items())
        max_step = max([m.step for m in members], default=-1.0)
        return {
            "version": version,
            "vnodes": self.vnodes,
            "heartbeat_ms": self.heartbeat_ms,
            # Skew actuation, shipped so clients rebuild the IDENTICAL
            # effective ring: replicated hot keys (JSON keys must be
            # strings; ordered member list, home owner first) and vnode
            # ownership overrides.
            "hot_keys": hot,
            "overrides": overrides,
            "members": [{
                "id": m.id, "host": m.host, "port": m.port,
                "health": round(health_score(m.stats, max_step), 6),
                "draining": m.draining, "step": m.step,
                # Monotonic per-member drain-cycle count: an operator
                # polling the table can tell a rolling drain finished
                # (every baseline member's count ticked) without any
                # extra protocol state.
                "drains_completed": m.drains_completed,
            } for m in members],
        }

    def stats_payload(self) -> Dict:
        """Versioned CLUSTER-WIDE metric rollup for ``Fleet_Stats``
        (fleet_top, benches): per-replica rates + stage percentiles from
        the heartbeat metric snapshots, and a fleet summary whose
        counters/rates are exact SUMS of the per-replica records (the
        tier-1 smoke asserts the sums match) with stage percentiles
        merged count-weighted — the same documented approximation the
        telemetry report CLI uses."""
        with self._lock:
            members = list(self._members.values())
            version = self._stats_seq
            hot_lists = list(self._hot_replicas.values())
            n_overrides = len(self._overrides)
            migrations = dict(self._migrations)
        max_step = max([m.step for m in members], default=-1.0)
        # REBAL column inputs: how many replicated hot keys each member
        # serves (as home owner OR extra replica) + handoffs in flight.
        hot_count: Dict[str, int] = {}
        for repl in hot_lists:
            for mid in repl:
                hot_count[mid] = hot_count.get(mid, 0) + 1
        per: Dict[str, Dict] = {}
        for m in members:
            met, rates = m.metrics, m.rates()
            per[m.id] = {
                "host": m.host, "port": m.port,
                "health": round(health_score(m.stats, max_step), 6),
                "draining": m.draining,
                "drains_completed": m.drains_completed,
                "hot_replicated": hot_count.get(m.id, 0),
                "migrations": migrations.get(m.id, 0),
                "qps": rates["qps"],
                "request_rate": rates["request_rate"],
                "shed_rate": rates["shed_rate"],
                # Data-plane load (traffic sketch, shipped on the
                # heartbeat): served-keys rate = this replica's shard
                # load, skew = its top-1 key's traffic share, hot_keys
                # = its heaviest hitters [[key, count], ...].
                "keys_rate": rates["keys_rate"],
                "keys": int(met.get("keys", 0)),
                "skew": float(met.get("top1_share", 0.0)),
                "hot_keys": list(met.get("hot_keys", [])),
                "requests": int(met.get("requests", 0)),
                "replies": int(met.get("replies", 0)),
                "shed": int(met.get("shed", 0)),
                "cancelled": int(met.get("cancelled", 0)),
                "queue_depth": float(met.get("queue_depth", 0.0)),
                "inflight": float(met.get("inflight", 0.0)),
                "pipeline_inflight": float(met.get("pipeline_inflight",
                                                   0.0)),
                "pipeline_inflight_max": float(
                    met.get("pipeline_inflight_max", 0.0)),
                "cache_hits": int(met.get("cache_hits", 0)),
                "watchdog_trips": int(met.get("watchdog_trips", 0)),
                "slo_ms": float(met.get("slo_ms", 0.0)),
                "slo_violations": int(met.get("slo_violations", 0)),
                "alerts": list(met.get("alerts", [])),
                "stages": dict(met.get("stages", {})),
                # Attribution layer passthroughs (telemetry/
                # critical_path.py, roofline.py): the replica's roofline
                # verdict (fleet_top BOUND column) and its slowest-
                # request phase ledgers (fleet_top --exemplars).
                "roofline": dict(met.get("roofline", {}) or {}),
                "exemplars": list(met.get("exemplars", []) or []),
            }
        fleet: Dict = {
            "replicas": len(per),
            "qps": round(sum(p["qps"] for p in per.values()), 3),
            "request_rate": round(sum(p["request_rate"]
                                      for p in per.values()), 3),
            "requests": sum(p["requests"] for p in per.values()),
            "replies": sum(p["replies"] for p in per.values()),
            "shed": sum(p["shed"] for p in per.values()),
            "cancelled": sum(p["cancelled"] for p in per.values()),
            "queue_depth": round(sum(p["queue_depth"]
                                     for p in per.values()), 3),
            "inflight": round(sum(p["inflight"] for p in per.values()), 3),
            "pipeline_inflight": round(sum(p["pipeline_inflight"]
                                           for p in per.values()), 3),
            "cache_hits": sum(p["cache_hits"] for p in per.values()),
            "watchdog_trips": sum(p["watchdog_trips"]
                                  for p in per.values()),
            "slo_violations": sum(p["slo_violations"]
                                  for p in per.values()),
        }
        total = fleet["requests"] + fleet["shed"]
        fleet["shed_rate"] = round(fleet["shed"] / total, 5) if total \
            else 0.0
        # Fleet-wide data-plane load: total served-keys rate, the
        # p99-to-mean shard-load ratio (1.0 = balanced; the imbalance
        # alert's input), and the heaviest hitters merged across
        # replicas (counts sum per key — SpaceSaving's merge rule).
        from multiverso_tpu_torch.telemetry.sketch import load_ratio
        member_rates = [p["keys_rate"] for p in per.values()
                        if not p["draining"]] or \
            [p["keys_rate"] for p in per.values()]
        fleet["keys_rate"] = round(sum(p["keys_rate"]
                                       for p in per.values()), 3)
        fleet["shard_load_ratio"] = round(load_ratio(member_rates), 4)
        merged_hot: Dict[int, int] = {}
        for p in per.values():
            for key, count in p["hot_keys"]:
                merged_hot[key] = merged_hot.get(key, 0) + int(count)
        fleet["hot_keys"] = sorted(([k, c] for k, c in merged_hot.items()),
                                   key=lambda kc: -kc[1])[:5]
        # Skew actuator status (fleet_top REBAL; not per-row sums — a
        # replicated key appears on several members by design).
        fleet["hotkey_replicated"] = len(hot_lists)
        fleet["rebalance"] = {"overrides": n_overrides,
                              "migrations": sum(migrations.values())}
        # The ROUTER's own alert engine (heartbeat-loss fires HERE — the
        # dead replica cannot report its own absence) plus the sum of
        # replica-reported firing alerts: fleet_top's ALERTS column.
        from multiverso_tpu_torch.telemetry import active_alert_summaries
        router_alerts = active_alert_summaries()
        fleet["alerts_active"] = sum(len(p["alerts"])
                                     for p in per.values()) \
            + len(router_alerts)
        stages: Dict[str, Dict] = {}
        for p in per.values():
            for key, s in p["stages"].items():
                agg = stages.setdefault(key, {"count": 0, "_wp": [0.0] * 3})
                n = int(s.get("count", 0))
                agg["count"] += n
                for i, q in enumerate(("p50", "p95", "p99")):
                    agg["_wp"][i] += float(s.get(q, 0.0)) * n
        for agg in stages.values():
            n = max(agg["count"], 1)
            agg["p50"], agg["p95"], agg["p99"] = \
                (round(w / n, 4) for w in agg.pop("_wp"))
        fleet["stages"] = stages
        # Fleet-wide slowest-request ledgers: the per-member exemplar
        # reservoirs merged slowest-first, each tagged with its member —
        # "why was fleet p99 high" answered from one rollup read.
        merged_ex = [dict(e, member=mid)
                     for mid, p in per.items() for e in p["exemplars"]]
        fleet["exemplars"] = sorted(
            merged_ex, key=lambda e: -float(e.get("total_ms", 0.0)))[:8]
        from multiverso_tpu_torch.telemetry import get_registry
        return {"schema": "multiverso_tpu.fleet_stats/v1",
                "version": version,
                "time_unix": time.time(),
                "heartbeat_ms": self.heartbeat_ms,
                "router_alerts": router_alerts,
                # Top-level, NOT in the fleet block: the fleet block's
                # counters are exact sums of the per-replica rows (the
                # tier-1 smoke asserts it) and the router is not a row.
                "router_watchdog_trips": get_registry().counter(
                    "telemetry.watchdog.trips").value,
                "replicas": per,
                "fleet": fleet}


class FleetMember:
    """Replica-side membership agent + drain lifecycle executor.

    ``service`` is the process's :class:`ServingService` (supplies the
    advertised address, the quiesce barrier, and bucket warm-up);
    ``swap_fn`` runs between quiesce and warm-up during a drain —
    typically ``CheckpointReplica.refresh`` for a rolling checkpoint
    swap. The heartbeat loop, the reconnect backoff, and the drain worker
    are all daemon threads joined by :meth:`close`."""

    def __init__(self, router: Tuple[str, int], service,
                 member_id: Optional[str] = None,
                 swap_fn: Optional[Callable[[], object]] = None,
                 drain_timeout_s: float = 30.0):
        self.router = (str(router[0]), int(router[1]))
        self.service = service
        self.member_id = member_id or \
            f"{service.address[0]}:{service.address[1]}#{os.getpid()}"
        self.swap_fn = swap_fn
        self.drain_timeout_s = float(drain_timeout_s)
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._msg_id = 0
        self._heartbeat_s = 0.1
        # Instance-local drain state is authoritative (the telemetry
        # gauge is export-only: the registry is process-global and two
        # members in one test process must not alias).
        self._drain_active = False
        self._drains_done = 0
        self._g_draining = gauge("fleet.draining")
        self._g_draining.set(0.0)
        self._c_drains = counter("fleet.member_drains")
        self._drain_thread: Optional[threading.Thread] = None
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-member", daemon=True)

    def start(self) -> "FleetMember":
        self._thread.start()
        return self

    # -- wire ----------------------------------------------------------------
    def _rpc(self, msg_type: int, payload: Dict) -> Dict:
        check(self._sock is not None, "fleet member is not connected")
        self._msg_id += 1
        send_message(self._sock, Message(
            type=msg_type, msg_id=self._msg_id,
            data=[pack_json_blob(payload)]))
        reply = recv_message(self._sock)
        if reply is None:
            raise OSError("fleet router closed the connection")
        if reply.type == MsgType.Reply_Error:
            reason = reply.data[0].tobytes().decode() if reply.data else "?"
            raise OSError(f"fleet router rejected request: {reason}")
        return unpack_json_blob(reply.data[0]) if reply.data else {}

    def _join(self) -> None:
        from multiverso_tpu_torch.serving.client import connect_with_backoff
        # A rejoin (router swept us, or asked us to re-register) must not
        # leak the previous socket — each leak also pins a dead conn slot
        # + reader thread on the router until MAX_CONNS starves joins.
        self._close_sock()
        self._sock = connect_with_backoff(*self.router, attempts=6)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        host, port = self.service.address
        reply = self._rpc(MsgType.Fleet_Join, {
            "id": self.member_id, "host": host, "port": port})
        self._heartbeat_s = float(reply.get("heartbeat_ms", 100.0)) / 1e3
        log.info("fleet member %s: joined router %s:%d (heartbeat %.0fms)",
                 self.member_id, self.router[0], self.router[1],
                 self._heartbeat_s * 1e3)

    # -- heartbeat loop ------------------------------------------------------
    def _loop(self) -> None:
        # Wedge watchdog: the loop's own RPC is what keeps this replica
        # in the ring — a heartbeat thread stuck in a recv against a
        # silent router is indistinguishable from a dead replica to the
        # fleet, and exactly what the postmortem should show. 240s: the
        # timeout must ride out _join's WORST-case re-dial against a
        # packet-dropping peer (connect_with_backoff attempts=6 with
        # ~30s connect timeouts + backoff sleeps ~ 180s) — a healthy
        # retry loop must never be named as wedged.
        with watchdog_scope("fleet-heartbeat", timeout_s=240.0) as wd:
            self._run_heartbeat_loop(wd)

    def _run_heartbeat_loop(self, wd) -> None:
        while not self._stop.is_set():
            wd.beat()
            try:
                if self._sock is None:
                    self._join()
                self._stop.wait(self._heartbeat_s)
                if self._stop.is_set():
                    return
                b = self.service.batcher(0)
                stats = local_stats(b.max_queue, b.max_batch,
                                    getattr(b, "pipeline_depth", 0))
                stats["draining"] = 1.0 if self._drain_active else 0.0
                stats["drains_completed"] = float(self._drains_done)
                reply = self._rpc(MsgType.Fleet_Heartbeat, {
                    "id": self.member_id, "stats": stats,
                    # Compact metric snapshot riding every beat: the
                    # router's Fleet_Stats rollup is built from these.
                    "metrics": metrics_payload()})
                directive = reply.get("directive", "none")
                if directive == "drain":
                    self._begin_drain()
                elif directive == "rejoin":
                    self._join()
            except (IOError, OSError) as e:
                if self._stop.is_set():
                    return
                log.warning("fleet member %s: router connection lost (%s); "
                            "re-dialing", self.member_id, e)
                self._close_sock()
                self._stop.wait(0.2)

    # -- drain lifecycle -----------------------------------------------------
    def _begin_drain(self) -> None:
        if self._drain_thread is not None and self._drain_thread.is_alive():
            return              # a drain is already running
        self._drain_active = True
        self._g_draining.set(1.0)
        self._drain_thread = threading.Thread(
            target=self._drain, name="fleet-drain", daemon=True)
        self._drain_thread.start()

    def _drain(self) -> None:
        """Finish in-flight batches, hot-swap, re-warm, rejoin. The
        service keeps answering throughout — drain changes ROUTING, not
        availability."""
        self._c_drains.inc()
        with span("fleet.drain", member=self.member_id):
            try:
                if not self.service.quiesce(self.drain_timeout_s):
                    log.warning("fleet member %s: drain quiesce timed out "
                                "after %.1fs; swapping anyway",
                                self.member_id, self.drain_timeout_s)
                if self.swap_fn is not None:
                    self.swap_fn()
                self.service.warmup()
            except Exception as e:  # noqa: BLE001 - a failed swap must
                # re-enter the ring rather than leave the replica parked
                # in draining state forever (the old snapshot still
                # serves correctly).
                log.error("fleet member %s: drain swap failed: %s",
                          self.member_id, e)
            finally:
                self._drains_done += 1
                self._drain_active = False
                self._g_draining.set(0.0)
        log.info("fleet member %s: drain complete — rejoining ring",
                 self.member_id)

    # -- lifecycle -----------------------------------------------------------
    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            # Let the heartbeat loop finish its in-flight RPC before we
            # share its socket for the goodbye (two writers on one framed
            # stream would interleave).
            self._thread.join(timeout=2)
        if not self._thread.is_alive() and self._sock is not None:
            try:
                self._rpc(MsgType.Fleet_Leave, {"id": self.member_id})
            except (IOError, OSError):
                pass            # best-effort: the sweep will reap us
        self._close_sock()      # also breaks a recv the loop is stuck in
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=self.drain_timeout_s + 5)
