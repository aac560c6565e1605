"""Fleet client: ring-routed, health-balanced, hedged serving requests.

Port of ``multiverso_tpu/fleet/client.py``.

The smart-client half of the fleet design: the router owns MEMBERSHIP
(who is alive, who is draining, how loaded everyone is) and ships it as a
versioned routing table; the client owns the DATA PATH (direct replica
connections — the router never proxies a hot-path byte unless asked to).

Routing policy:

* **Row lookups** route by ring ownership. ``split=True`` partitions the
  requested rows by their consistent-hash owner and fans sub-lookups to
  each owner concurrently (the generalization of
  ``RoutedLookupClient`` — correct when replicas hold row PARTITIONS).
  ``split=False`` (default) sends the whole request to the ring owner of
  the request's combined key hash — the cache-affinity policy for a
  REPLICATED fleet where any member can answer and sticky routing keeps
  hot rows hot.
* **Replica-agnostic requests** (LM decode) go to the healthiest member.

Every dispatch is a :class:`~multiverso_tpu_torch.fleet.hedge.HedgedCall` over
a preference list of DISTINCT replicas: a reply slower than the adaptive
p95 threshold triggers a second attempt elsewhere, first reply wins, the
loser is discarded; a dead replica (typed
:class:`~multiverso_tpu_torch.serving.client.ReplicaUnavailableError`) fails
over immediately and is locally suspected until the routing table
confirms its fate — so a SIGKILLed replica costs at most the requests
that were in flight on it at kill time.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from multiverso_tpu_torch.core.actor import Message, MsgType
from multiverso_tpu_torch.fleet.hashring import HashRing, _splitmix64
from multiverso_tpu_torch.fleet.hedge import (AdaptiveDelay, HedgeBudget,
                                              HedgedCall, HedgeScheduler,
                                              default_scheduler)
from multiverso_tpu_torch.parallel.net import (pack_json_blob, recv_message,
                                               send_message, unpack_json_blob)
from multiverso_tpu_torch.serving.client import (ReplicaUnavailableError,
                                                 ServingClient, backoff_delays,
                                                 connect_with_backoff)
from multiverso_tpu_torch.telemetry import counter, emit_span, histogram
from multiverso_tpu_torch.telemetry import context as trace_context
from multiverso_tpu_torch.telemetry.sketch import record_keys
from multiverso_tpu_torch.telemetry.context import TraceContext
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check, log

_SUSPECT_TTL_S = 1.0    # local quarantine until the router confirms death

_UNSET = object()       # "resolve the trace context here" sentinel


def _resolve_root() -> Optional[TraceContext]:
    """Root (or child-of-ambient) context for one logical fleet request.
    The AMBIENT case is the router's data proxy: its fleet client must
    continue the trace the proxied frame carried, not start a new one."""
    cur = trace_context.current_context()
    if cur is not None:
        return trace_context.child_of(cur)
    return trace_context.maybe_new_root()


class RoutingTable:
    """One immutable snapshot of the fleet's routing state. Ranked order
    is precomputed once — ``ranked()`` sits on the per-request path.

    Skew-actuation state rides the same payload (docs/DESIGN.md "Skew
    actuation"): vnode ownership ``overrides`` feed the ring rebuild (so
    router and clients agree on migrated arcs), and ``hot_replicas``
    holds each replicated hot key's member list PRE-FILTERED by the
    HotRowCache freshness rule — a member may serve a replicated key iff
    ``fleet_max_step - member_step <= hot_staleness`` (an unversioned
    fleet, ``max_step < 0``, is always fresh). Filtering at build time
    keeps the per-request path to a dict probe."""

    __slots__ = ("version", "vnodes", "members", "by_id", "ring",
                 "overrides", "hot_replicas", "_ranked")

    def __init__(self, payload: Dict, hot_staleness: float = 0.0):
        self.version = int(payload.get("version", 0))
        self.vnodes = int(payload.get("vnodes", 64))
        self.members: List[Dict] = list(payload.get("members", []))
        self.by_id = {m["id"]: m for m in self.members}
        routable = sorted(m["id"] for m in self.members
                          if not m.get("draining")
                          and m.get("health", 0.0) > 0.0)
        self.overrides: List[Tuple[str, int, str]] = [
            (str(m), int(v), str(t))
            for m, v, t in payload.get("overrides", [])]
        self.ring = HashRing(routable, vnodes=self.vnodes,
                             overrides=self.overrides)
        live = [m for m in self.members if m["id"] in self.ring.members]
        live.sort(key=lambda m: (-float(m.get("health", 0.0)), m["id"]))
        self._ranked = [m["id"] for m in live]
        steps = {m["id"]: float(m.get("step", -1.0)) for m in self.members}
        max_step = max(steps.values(), default=-1.0)
        self.hot_replicas: Dict[int, List[str]] = {}
        for key, mids in (payload.get("hot_keys") or {}).items():
            fresh = [m for m in mids
                     if m in self.ring
                     and (max_step < 0 or (steps.get(m, -1.0) >= 0
                          and max_step - steps[m] <= hot_staleness))]
            if fresh:
                self.hot_replicas[int(key)] = fresh

    def ranked(self, exclude: Sequence[str] = ()) -> List[str]:
        """Member ids by descending health, the routable ones only."""
        if not exclude:
            return self._ranked
        skip = set(exclude)
        return [m for m in self._ranked if m not in skip]

    def replica_pref(self, member_id: str, n_replicas: int = 2
                     ) -> List[str]:
        """Per-partition replica set as a failover preference: the
        partition OWNER first, then its ring successors (the members that
        inherit its arcs if it leaves — in split mode, the ones holding
        this partition's replica copies), then everyone else by health."""
        succ = self.ring.successors(member_id, max(0, n_replicas - 1)) \
            if member_id in self.ring else []
        rest = self.ranked(exclude=(member_id, *succ))
        return [member_id] + succ + rest

    def addr(self, member_id: str) -> Tuple[str, int]:
        m = self.by_id[member_id]
        return (m["host"], int(m["port"]))


class _RouterFeed:
    """Pulls the routing table from a FleetRouter over ``Fleet_Route``
    (persistent connection, re-dialed with backoff on loss)."""

    def __init__(self, addr: Tuple[str, int]):
        self.addr = (str(addr[0]), int(addr[1]))
        self._sock = None
        self._msg_id = 0
        # Two locks, deliberately: _io_lock serializes the whole
        # dial+request+reply exchange (one fetch at a time on the one
        # persistent socket), while _state_lock guards only the small
        # shared state (_sock publication, the reconnect flag, the
        # closed bit). Control ops — consume_reconnected(), close() —
        # take _state_lock alone, so they never wait out a 4-attempt
        # backoff dial or a parked recv the way they did when one lock
        # covered both. Order: _io_lock -> _state_lock, never reversed.
        self._io_lock = make_lock("fleet.feed.io")
        self._state_lock = make_lock("fleet.feed.state")
        self._reconnected = False
        self._closed = False

    def consume_reconnected(self) -> bool:
        """True once after each re-dial: a restarted router's version
        counter restarts too, so the consumer must accept the next table
        even if its version regressed."""
        with self._state_lock:
            fresh, self._reconnected = self._reconnected, False
            return fresh

    def fetch(self) -> Dict:
        with self._io_lock:
            with self._state_lock:
                if self._closed:
                    raise OSError("routing feed is closed")
                sock = self._sock
            if sock is None:
                # _io_lock (not _state_lock) held across the dial ON
                # PURPOSE: it serializes exactly this exchange, and a
                # concurrent close() must stay free to interrupt it.
                # graftlint: disable=lock-held-across-blocking
                sock = connect_with_backoff(*self.addr, attempts=4)
                with self._state_lock:
                    if self._closed:        # close() raced the dial
                        try:
                            sock.close()
                        except OSError:
                            pass
                        raise OSError("routing feed is closed")
                    self._sock = sock
                    self._reconnected = True
            try:
                self._msg_id += 1
                # Same contract: _io_lock IS the exchange serializer.
                # graftlint: disable=lock-held-across-blocking
                send_message(sock, Message(
                    type=MsgType.Fleet_Route, msg_id=self._msg_id,
                    data=[pack_json_blob({})]))
                # graftlint: disable=lock-held-across-blocking
                reply = recv_message(sock)
            except (IOError, OSError):
                self._drop(sock)
                raise
            if reply is None or not reply.data:
                self._drop(sock)
                raise OSError("fleet router closed the routing feed")
            return unpack_json_blob(reply.data[0])

    def _drop(self, sock) -> None:
        try:
            sock.close()
        except OSError:
            pass
        with self._state_lock:
            if self._sock is sock:
                self._sock = None

    def close(self) -> None:
        """Idempotent, and deliberately NOT serialized behind fetch():
        closing the socket out from under an in-flight exchange is the
        wakeup — the blocked recv raises instead of waiting out a dead
        router."""
        with self._state_lock:
            self._closed = True
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                # shutdown() — not just close() — is what actually wakes
                # a thread parked in recv on this socket; a bare close
                # only drops the fd refcount and can leave the reader
                # blocked until the peer speaks.
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class _GroupFeed:
    """In-process routing feed straight off a ReplicaGroup (the router's
    own data plane, and tests, skip the TCP hop)."""

    def __init__(self, group):
        self.group = group

    def fetch(self) -> Dict:
        return self.group.routing_payload()

    def close(self) -> None:
        pass


def fetch_fleet_stats(router: Tuple[str, int],
                      timeout_s: float = 10.0) -> Dict:
    """One ``Fleet_Stats`` pull: the router's versioned cluster-wide
    metric rollup (per-replica QPS/shed/queue/stage percentiles + fleet
    sums). The data feed behind ``apps/fleet_top.py`` and the bench's
    rollup embed."""
    sock = connect_with_backoff(*router, attempts=4,
                                timeout_s=timeout_s)
    try:
        send_message(sock, Message(type=MsgType.Fleet_Stats, msg_id=1,
                                   data=[pack_json_blob({})]))
        reply = recv_message(sock)
        if reply is None or not reply.data:
            raise OSError("fleet router closed the stats channel")
        if reply.type == MsgType.Reply_Error:
            raise OSError("fleet router rejected stats pull: "
                          + reply.data[0].tobytes().decode())
        return unpack_json_blob(reply.data[0])
    finally:
        sock.close()


def request_drain(router: Tuple[str, int],
                  member_id: Optional[str] = None,
                  timeout_s: float = 60.0) -> Dict:
    """Operator-side drain trigger: ask the router (over ``Fleet_Drain``)
    to drain one member, or rolling-drain the whole fleet when
    ``member_id`` is None. Returns the router's ack; poll the routing
    table (``Fleet_Route`` / :meth:`FleetClient.routing`) for per-member
    ``drains_completed`` to observe completion."""
    sock = connect_with_backoff(*router, attempts=4)
    try:
        payload: Dict = {"timeout_s": float(timeout_s)}
        if member_id is not None:
            payload["id"] = str(member_id)
        send_message(sock, Message(type=MsgType.Fleet_Drain, msg_id=1,
                                   data=[pack_json_blob(payload)]))
        reply = recv_message(sock)
        if reply is None or not reply.data:
            raise OSError("fleet router closed the drain channel")
        if reply.type == MsgType.Reply_Error:
            raise OSError("fleet router rejected drain: "
                          + reply.data[0].tobytes().decode())
        return unpack_json_blob(reply.data[0])
    finally:
        sock.close()


class FleetClient:
    """Routed + hedged client over a replica fleet.

    ``router`` is either a ``(host, port)`` of a FleetRouter's control
    listener or a :class:`~multiverso_tpu_torch.fleet.membership.ReplicaGroup`
    for in-process use. ``hedge`` is ``"adaptive"`` (p95-tracking delay),
    a fixed delay in ms, or ``"off"``. ``max_attempts`` bounds the
    distinct replicas one logical request may touch (primary + hedges +
    failover). ``rpc_timeout_ms`` (``-rpc_timeout_ms``) arms a per-RPC
    deadline: an attempt with no reply inside the budget is abandoned —
    its member suspected, the request jitter-retried against the next
    ring owner — instead of blocking on a half-dead (SIGSTOPped,
    half-partitioned) shard until the caller's whole timeout burns."""

    def __init__(self, router, runner_id: int = 0,
                 refresh_s: float = 0.25,
                 hedge: Union[str, float] = "adaptive",
                 max_attempts: int = 3,
                 scheduler: Optional[HedgeScheduler] = None,
                 rpc_timeout_ms: Optional[float] = None,
                 hot_staleness: float = 0.0):
        from multiverso_tpu_torch.fleet.membership import ReplicaGroup
        self._feed = _GroupFeed(router) if isinstance(router, ReplicaGroup) \
            else _RouterFeed(router)
        self.runner_id = int(runner_id)
        self.max_attempts = max(1, int(max_attempts))
        # Replicated-hot-key read bound, same clock arithmetic as
        # -serve_cache_staleness (0 = only replicas at the fleet max
        # step may serve a replicated key).
        self._hot_staleness = float(hot_staleness)
        self._hot_rr = 0        # round-robin cursor over fresh replicas
        self._c_hot_routed = counter("fleet.hotkey.routed")
        self._hedge_on = hedge != "off"
        self._fixed_delay = None if isinstance(hedge, str) \
            else float(hedge)
        self._delay = AdaptiveDelay()
        self._budget = HedgeBudget()
        self._rpc_timeout_s = None if not rpc_timeout_ms \
            else float(rpc_timeout_ms) / 1e3
        self._c_deadline = counter("fleet.rpc_deadline_exceeded")
        self._sched = scheduler or default_scheduler()
        self._lock = make_lock("fleet.client")
        self._conns: Dict[str, ServingClient] = {}
        self._suspects: Dict[str, float] = {}
        self._table: Optional[RoutingTable] = None
        self._stop = threading.Event()
        self._h_lat = histogram("fleet.latency.request")
        self._c_requests = counter("fleet.requests")
        self._c_lookup = counter("fleet.route.lookup")
        self._c_decode = counter("fleet.route.decode")
        self._c_sub = counter("fleet.route.subrequests")
        self._c_parked = counter("fleet.route.parked")
        self._c_errors = counter("fleet.errors")
        self._c_cancels = counter("fleet.hedge.cancelled")
        self.refresh()          # fail loudly if the router is unreachable
        self._refresh_s = float(refresh_s)
        self._refresher = threading.Thread(
            target=self._refresh_loop, name="fleet-routing", daemon=True)
        self._refresher.start()

    # -- routing table ------------------------------------------------------
    def refresh(self) -> RoutingTable:
        payload = self._feed.fetch()
        # A re-dialed feed means a (possibly restarted) router whose
        # version counter restarted — its table must win even when the
        # version number regressed, or the client routes to stale
        # addresses forever.
        fresh_feed = getattr(self._feed, "consume_reconnected",
                             lambda: False)()
        table = RoutingTable(payload, hot_staleness=self._hot_staleness)
        with self._lock:
            if self._table is None or fresh_feed \
                    or table.version >= self._table.version:
                self._table = table
            return self._table

    def _refresh_loop(self) -> None:
        misses = 0
        while not self._stop.wait(self._refresh_s):
            try:
                self.refresh()
                misses = 0
            except (IOError, OSError) as e:
                misses += 1
                if misses in (1, 10):   # log the first and the persistent
                    log.warning("fleet client: routing refresh failed "
                                "(%s); serving from last table", e)

    def routing(self) -> RoutingTable:
        with self._lock:
            table = self._table
        check(table is not None, "fleet client has no routing table")
        return table

    # -- connections --------------------------------------------------------
    def _conn(self, member_id: str) -> ServingClient:
        table = self.routing()
        with self._lock:
            cli = self._conns.get(member_id)
            if cli is not None and not cli.dead:
                return cli
            self._conns.pop(member_id, None)
        host, port = table.addr(member_id)
        # Fail fast on a dead replica: one connect try here — the hedge
        # machinery fails over to the next candidate, and the member gets
        # suspected below; the slow multi-attempt backoff is for
        # SINGLE-destination clients with nowhere else to go.
        cli = ServingClient(host, port, connect_attempts=1)
        with self._lock:
            cur = self._conns.setdefault(member_id, cli)
        if cur is not cli:
            cli.close()
        return cur

    def _suspect(self, member_id: str) -> None:
        with self._lock:
            self._suspects[member_id] = time.monotonic() + _SUSPECT_TTL_S
            cli = self._conns.pop(member_id, None)
        if cli is not None:
            cli.close()

    def _candidates(self, pref: List[str]) -> List[str]:
        """Preference order minus locally-suspected members — unless that
        empties the list (better a suspect than nobody). Fast path: no
        suspects (the steady state) touches no lock."""
        if not self._suspects:
            return pref
        now = time.monotonic()
        with self._lock:
            self._suspects = {m: t for m, t in self._suspects.items()
                              if t > now}
            live = [m for m in pref if m not in self._suspects]
        return live or pref

    # -- hedged dispatch ----------------------------------------------------
    def _hedge_delay_ms(self) -> float:
        if self._fixed_delay is not None:
            return self._fixed_delay
        return self._delay.delay_ms()

    def _make_attempt(self, member_id: str, payload: np.ndarray,
                      deadline_ms: float, runner_id: int, idx: int,
                      root: Optional[TraceContext],
                      state: Dict) -> Callable:
        """One attempt launcher. ``state`` is the per-logical-request
        bookkeeping shared with :meth:`request_async`: ``launched`` (how
        many attempts fired — attempt spans read it to tag EVERY sibling
        of a hedged pair ``hedge=1``, not just the duplicate) and
        ``sent`` (attempt idx -> (member, msg_id) for loser cancels)."""
        def attempt(deliver):
            ctx = trace_context.child_of(root, hedge=idx) \
                if root is not None else None
            t_a = time.monotonic()
            with state["lock"]:
                state["launched"] += 1
            try:
                cli = self._conn(member_id)
            except ReplicaUnavailableError:
                self._suspect(member_id)
                raise

            # Exactly-once delivery per attempt: with the rpc deadline
            # armed, a real reply racing the deadline's failover must not
            # reach the hedge state machine twice.
            once = [False]
            timer: List = [None]

            def deliver_once(result) -> bool:
                with state["lock"]:
                    if once[0]:
                        return False
                    once[0] = True
                if timer[0] is not None:
                    timer[0].cancel()
                deliver(result)
                return True

            def cb(res):
                if ctx is not None and ctx.sampled:
                    with state["lock"]:
                        hedged = state["launched"] > 1
                    emit_span("fleet.attempt", ctx, t_a,
                              (time.monotonic() - t_a) * 1e3,
                              member=member_id, attempt=idx,
                              hedge=1 if hedged else 0)
                try:
                    deliver_once(res.wait(timeout=1.0))
                except ReplicaUnavailableError as e:
                    self._suspect(member_id)
                    deliver_once(e)
                except Exception as e:  # noqa: BLE001 - shed/decode errors
                    deliver_once(e)     # belong to the hedge state machine

            try:
                res = cli.request_async(payload, deadline_ms, runner_id,
                                        on_done=cb, trace_ctx=ctx)
                with state["lock"]:
                    state["sent"][idx] = (member_id, res.msg_id)
            except ReplicaUnavailableError:
                self._suspect(member_id)
                raise
            if self._rpc_timeout_s is not None:
                # Per-RPC deadline, JITTERED through the standard backoff
                # schedule (idx-th entry): every client re-routing off the
                # same half-dead shard staggers onto the next ring owner
                # instead of herding there at the same instant.
                slack = backoff_delays(idx + 1)[-1]

                def expire():
                    if deliver_once(ReplicaUnavailableError(
                            f"rpc deadline "
                            f"({1e3 * self._rpc_timeout_s:.0f}ms) "
                            f"exceeded on {member_id}")):
                        self._c_deadline.inc()
                        self._suspect(member_id)

                timer[0] = self._sched.call_later(
                    self._rpc_timeout_s + slack, expire)
        return attempt

    def _cancel_losers(self, winner: int, state: Dict,
                       runner_id: int) -> None:
        """Server-side cancel for hedged losers: the winning reply is in,
        so every OTHER launched attempt is asked to drop its copy at
        admission instead of computing a discarded answer. Best-effort —
        a dead conn or an already-dispatched batch just means the old
        discard-at-client behavior."""
        with state["lock"]:
            losers = [(idx, m, mid) for idx, (m, mid)
                      in state["sent"].items() if idx != winner]
        for _idx, member_id, msg_id in losers:
            with self._lock:
                cli = self._conns.get(member_id)
            if cli is None or cli.dead:
                continue
            cli.cancel(msg_id, runner_id)
            self._c_cancels.inc()

    def request_async(self, payload: np.ndarray, pref: List[str],
                      on_done: Callable, deadline_ms: float = 100.0,
                      runner_id: Optional[int] = None,
                      trace_ctx=_UNSET) -> None:
        """Hedged dispatch of one payload along a replica preference
        list; ``on_done`` receives ``(values, clock)`` or an exception
        instance, exactly once. This is the TRACE ROOT of a fleet
        request unless ``trace_ctx`` hands one in (split lookups): one
        ``fleet.request`` span per logical request, one ``fleet.attempt``
        child per launched attempt (hedged duplicates are siblings
        tagged ``hedge=1``), and the attempt context rides the wire so
        replica-side spans parent under the attempt."""
        rid = self.runner_id if runner_id is None else int(runner_id)
        root = _resolve_root() if trace_ctx is _UNSET else trace_ctx
        pref = self._candidates(pref)[:self.max_attempts]
        if not pref:
            on_done(ReplicaUnavailableError("fleet has no live replicas"))
            return
        self._c_requests.inc()
        self._budget.on_request()
        t0 = time.monotonic()
        state: Dict = {"lock": threading.Lock(), "launched": 0, "sent": {}}

        def done(result):
            failed = isinstance(result, BaseException)
            ms = (time.monotonic() - t0) * 1e3
            if failed:
                self._c_errors.inc()
            else:
                self._delay.observe(ms)
                self._h_lat.observe(ms)
            if root is not None:
                # Tail exemplars: errors/sheds and slow requests record
                # even when the head decision was "don't sample".
                force = failed or ms > trace_context.slow_ms()
                if failed:
                    emit_span("fleet.request", root, t0, ms, force=force,
                              outcome=type(result).__name__)
                else:
                    emit_span("fleet.request", root, t0, ms, force=force)
            # The JAX client also offers the request to the fleet plane's
            # tail-exemplar reservoir here; the reservoir is not ported
            # yet (ROADMAP A11).
            on_done(result)

        def settled(winner: int, launched: int):
            if winner >= 0 and launched > 1:
                self._cancel_losers(winner, state, rid)

        attempts = [self._make_attempt(m, payload, deadline_ms, rid, i,
                                       root, state)
                    for i, m in enumerate(pref)]
        HedgedCall(attempts, done, delay_ms=self._hedge_delay_ms(),
                   scheduler=self._sched, hedge=self._hedge_on,
                   allow_hedge=self._budget.try_spend,
                   on_settled=settled).launch()

    # -- lookups ------------------------------------------------------------
    def _affinity_pref(self, rows: np.ndarray,
                       table: RoutingTable) -> List[str]:
        """Ring owner of the request's combined key hash first, then the
        rest by health — sticky per key-set, balanced across sets.

        Hot-key replication relaxes stickiness: when EVERY requested row
        is a replicated hot key (all-or-nothing, mirroring the cache's
        all-or-nothing admission), the request round-robins across the
        union of the rows' FRESH replica lists (table-build filtered by
        the HotRowCache staleness rule) with the home owner as failover;
        otherwise the classic affinity route."""
        if rows.size and len(table.ring):
            rep = int(_splitmix64(rows.astype(np.uint64)).sum()
                      % np.uint64(2**63 - 1))
            owner = table.ring.owner(rep)
            hot = table.hot_replicas
            if hot and all(int(r) in hot for r in rows):
                cand: List[str] = []
                for r in rows:
                    for m in hot[int(r)]:
                        if m not in cand:
                            cand.append(m)
                if cand:
                    self._hot_rr = (self._hot_rr + 1) % 1_000_003
                    pick = cand[self._hot_rr % len(cand)]
                    self._c_hot_routed.inc()
                    rest = [m for m in [owner]
                            + table.ranked(exclude=(owner,))
                            if m != pick]
                    return [pick] + rest
            return [owner] + table.ranked(exclude=(owner,))
        return table.ranked()

    def lookup_async(self, rows, on_done: Callable,
                     deadline_ms: float = 100.0, split: bool = False,
                     runner_id: Optional[int] = None,
                     _deadline: Optional[float] = None,
                     _root=_UNSET) -> None:
        """Row lookup; ``on_done`` gets ``(values, clock)`` or exception,
        exactly once. ``split=True`` fans rows out to their ring owners
        and stitches replies back in request order."""
        rows = np.asarray(rows, dtype=np.int32).reshape(-1)
        table = self.routing()
        if _deadline is None:
            self._c_lookup.inc()
            # Router-/client-side half of the traffic microscope: the key
            # stream AS ROUTED (affinity + split fan-out), before any
            # cache or shed — what key-affinity rebalancing re-shards by.
            record_keys("fleet.route", rows, rows.nbytes)
            _deadline = time.monotonic() + deadline_ms / 1e3
        if _root is _UNSET:
            # Resolve the trace root ONCE, before any park detour, so
            # park spans and the eventual fleet.request/fleet.lookup
            # land in the same trace (the scheduler thread that resumes
            # a parked request has no ambient context to inherit).
            _root = _resolve_root()
        if not len(table.ring):
            # Park-and-retry through the flip: mid-handoff (donor
            # draining, survivor health-scored 0 under the redirected
            # load) or mid-recovery the table can be MOMENTARILY empty,
            # and the announce that repopulates it is heartbeats away —
            # re-resolve off the scheduler until the request deadline
            # instead of failing a request the flip would have served.
            if time.monotonic() + 0.05 < _deadline:
                self._c_parked.inc()
                t_park = time.monotonic()

                def _resume(_rows=rows, _r=_root):
                    # Phase ledger: the park detour is its own phase —
                    # measured at resume so scheduler jitter is counted.
                    if _r is not None and _r.sampled:
                        emit_span("fleet.park", trace_context.child_of(_r),
                                  t_park,
                                  (time.monotonic() - t_park) * 1e3)
                    self.lookup_async(_rows, on_done, deadline_ms, split,
                                      runner_id, _deadline=_deadline,
                                      _root=_r)
                self._sched.call_later(0.05, _resume)
            else:
                on_done(ReplicaUnavailableError(
                    "fleet has no live replicas"))
            return
        if not split or rows.size == 0:
            self.request_async(rows, self._affinity_pref(rows, table),
                               on_done, deadline_ms, runner_id,
                               trace_ctx=_root)
            return
        parts = table.ring.partition(rows.astype(np.int64))
        self._c_sub.inc(len(parts))
        # ONE trace for the whole split lookup: the sub-requests become
        # fleet.request children of this fleet.lookup root, so a stitched
        # trace shows the fan-out to every owner replica.
        lroot = _root
        t0 = time.monotonic()
        state = {"remaining": len(parts), "out": None, "clock": None,
                 "done": False}
        state_lock = threading.Lock()

        def sub_done(result, pos):
            with state_lock:
                if state["done"]:
                    return
                if isinstance(result, BaseException):
                    state["done"] = True
                    err = result
                else:
                    values, clock = result
                    if state["out"] is None:
                        state["out"] = np.empty(
                            (len(rows),) + values.shape[1:], values.dtype)
                    state["out"][pos] = values
                    state["clock"] = clock if state["clock"] is None \
                        else min(state["clock"], clock)
                    state["remaining"] -= 1
                    if state["remaining"]:
                        return
                    state["done"] = True
                    err = None
            if lroot is not None:
                ms = (time.monotonic() - t0) * 1e3
                force = err is not None or ms > trace_context.slow_ms()
                emit_span("fleet.lookup", lroot, t0, ms, force=force,
                          parts=len(parts))
            on_done(err if err is not None
                    else (state["out"], state["clock"]))

        for member_id, pos in parts.items():
            # Per-partition replica set: the sub-request fails over
            # along the partition's OWN successor list before falling
            # back to health order.
            pref = table.replica_pref(member_id)
            sub_ctx = trace_context.child_of(lroot) \
                if lroot is not None else None
            self.request_async(
                rows[pos], pref,
                lambda result, _pos=pos: sub_done(result, _pos),
                deadline_ms, runner_id, trace_ctx=sub_ctx)

    def lookup(self, rows, deadline_ms: float = 100.0,
               split: bool = False, timeout: Optional[float] = 30.0,
               runner_id: Optional[int] = None) -> np.ndarray:
        """Synchronous routed lookup; returns the value rows."""
        values, _ = self._sync(
            lambda cb: self.lookup_async(rows, cb, deadline_ms, split,
                                         runner_id), timeout)
        return values

    # -- decode -------------------------------------------------------------
    def generate_async(self, tokens, on_done: Callable,
                       deadline_ms: float = 1000.0,
                       runner_id: Optional[int] = None) -> None:
        """Replica-agnostic request (LM decode): healthiest member first."""
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        self._c_decode.inc()
        self.request_async(tokens, self.routing().ranked(), on_done,
                           deadline_ms, runner_id)

    def generate(self, tokens, deadline_ms: float = 1000.0,
                 timeout: Optional[float] = 60.0,
                 runner_id: Optional[int] = None) -> np.ndarray:
        values, _ = self._sync(
            lambda cb: self.generate_async(tokens, cb, deadline_ms,
                                           runner_id), timeout)
        return values

    # -- plumbing -----------------------------------------------------------
    @staticmethod
    def _sync(start: Callable, timeout: Optional[float]):
        event = threading.Event()
        slot: List = []

        def cb(result):
            slot.append(result)
            event.set()

        start(cb)
        check(event.wait(timeout), "fleet request timed out")
        if isinstance(slot[0], BaseException):
            raise slot[0]
        return slot[0]

    def close(self) -> None:
        self._stop.set()
        self._refresher.join(timeout=5)
        self._feed.close()
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for cli in conns:
            cli.close()
