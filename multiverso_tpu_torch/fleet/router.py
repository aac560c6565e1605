"""FleetRouter: the fleet's front end — membership service + data proxy.

Port of ``multiverso_tpu/fleet/router.py``.

One TCP listener, two planes:

* **Control plane** — ``Fleet_Join``/``Fleet_Heartbeat``/``Fleet_Leave``
  from replica members (``membership.FleetMember``) and ``Fleet_Route``
  from clients pulling the versioned routing table. A sweeper daemon
  reaps members that miss ``liveness_misses`` heartbeats.
* **Data plane (optional, ``proxy=True``)** — plain ``Serve_Request``
  frames from ordinary :class:`~multiverso_tpu_torch.serving.ServingClient`
  users who neither know nor care that a fleet sits behind the address.
  The proxy routes with the SAME policy engine smart clients use (an
  embedded :class:`~multiverso_tpu_torch.fleet.client.FleetClient` fed
  in-process from the ReplicaGroup — zero routing RPCs): row lookups go
  to their ring owner, replica-agnostic requests to the healthiest
  member, and proxied requests inherit hedging + failover for free.

Routing which proxy requests count as "row lookups" is declared per
runner id at construction (``lookup_runners``); everything else is
treated as replica-agnostic (decode).

:meth:`rolling_drain` is the fleet-upgrade coordinator: drain one member
(finish in-flight -> hot-swap -> re-warm -> rejoin), wait for it to
return to the ring, move to the next — at no point does the ring lose
more than one member, and no request is dropped.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Sequence

import numpy as np

from multiverso_tpu_torch.core.actor import Message, MsgType
from multiverso_tpu_torch.fleet.membership import ReplicaGroup
from multiverso_tpu_torch.parallel.net import (
    pack_json_blob, pack_serve_payload, recv_message, send_message,
    unpack_json_blob, unpack_trace_ctx)
from multiverso_tpu_torch.telemetry import activate, counter, gauge, span
from multiverso_tpu_torch.utils.log import check, log
from multiverso_tpu_torch.utils.locks import make_lock


class FleetRouter:
    """Fleet membership authority + optional serving proxy."""

    MAX_CONNS = 512

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 vnodes: int = 64, heartbeat_ms: float = 100.0,
                 liveness_misses: int = 5, proxy: bool = True,
                 lookup_runners: Sequence[int] = (0,),
                 hotkey_replicas: int = 0, rebalance: bool = False,
                 rebalance_ratio: float = 1.5,
                 rebalance_windows: int = 3,
                 rebalance_cooldown_s: float = 10.0,
                 rebalance_vnodes: int = 4):
        self.group = ReplicaGroup(vnodes=vnodes, heartbeat_ms=heartbeat_ms,
                                  liveness_misses=liveness_misses)
        self._lookup_runners = frozenset(int(r) for r in lookup_runners)
        # Skew actuators (fleet/rebalance.py), ticked from the sweep
        # loop so decisions advance on the same clock as the load gauges
        # they read. Both off by default — flags arm them.
        self.replicator = None
        if int(hotkey_replicas) > 0:
            from multiverso_tpu_torch.fleet.rebalance import HotKeyReplicator
            self.replicator = HotKeyReplicator(
                self.group, replicas=int(hotkey_replicas))
        self.rebalancer = None
        if rebalance:
            from multiverso_tpu_torch.fleet.rebalance import FleetRebalancer
            self.rebalancer = FleetRebalancer(
                self.group, ratio=float(rebalance_ratio),
                windows=int(rebalance_windows),
                cooldown_s=float(rebalance_cooldown_s),
                move_vnodes=int(rebalance_vnodes))
        self._proxy_client = None
        self._proxy_on = bool(proxy)
        self._drain_thread = None
        self._lock = make_lock("fleet.router")
        self._running = True
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.address = self._listener.getsockname()
        self._conns: Dict[socket.socket, threading.Lock] = {}
        self._g_conns = gauge("fleet.router.connections")
        self._c_proxied = counter("fleet.router.proxied")
        self._c_route_pulls = counter("fleet.router.route_pulls")
        self._c_stats_pulls = counter("fleet.router.stats_pulls")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-accept", daemon=True)
        self._accept_thread.start()
        self._sweep_stop = threading.Event()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         name="fleet-sweep", daemon=True)
        self._sweeper.start()
        log.info("fleet router listening at %s:%d (proxy=%s)",
                 self.address[0], self.address[1], self._proxy_on)

    # -- proxy client (lazy: needs at least the group to exist) -------------
    def _proxy(self):
        with self._lock:
            if self._proxy_client is None:
                from multiverso_tpu_torch.fleet.client import FleetClient
                self._proxy_client = FleetClient(self.group)
            return self._proxy_client

    # -- connection handling -------------------------------------------------
    def _accept_loop(self) -> None:
        # Blocks in accept(); liveness is owned by close()'s listener
        # teardown, and a beat here could only report kernel readiness.
        # graftlint: disable=daemon-loop-no-watchdog
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if len(self._conns) >= self.MAX_CONNS:
                    conn.close()
                    continue
                self._conns[conn] = make_lock("fleet.router.conn")
                self._g_conns.set(len(self._conns))
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="fleet-conn", daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            # Blocks in recv_message(); a silent control connection is
            # normal, and close() breaks the recv by dropping the conn.
            # graftlint: disable=daemon-loop-no-watchdog
            while self._running:
                try:
                    msg = recv_message(conn)
                except (IOError, OSError):
                    break
                if msg is None:
                    break
                try:
                    self._handle(conn, msg)
                except Exception as e:  # noqa: BLE001 - a bad control
                    # frame answers an error; dropping the socket would
                    # kill an innocent member's heartbeat channel.
                    log.error("fleet router: request %d failed: %s",
                              msg.msg_id, e)
                    self._reply_error(conn, msg, f"bad request: {e}")
        finally:
            self._drop(conn)

    def _handle(self, conn: socket.socket, msg: Message) -> None:
        if msg.type == MsgType.Fleet_Join:
            req = unpack_json_blob(msg.data[0])
            reply = self.group.join(str(req["id"]), str(req["host"]),
                                    int(req["port"]))
            self._reply_json(conn, msg, MsgType.Reply_Fleet_Join, reply)
        elif msg.type == MsgType.Fleet_Heartbeat:
            req = unpack_json_blob(msg.data[0])
            reply = self.group.heartbeat(str(req["id"]),
                                         dict(req.get("stats", {})),
                                         req.get("metrics"))
            self._reply_json(conn, msg, MsgType.Reply_Fleet_Heartbeat,
                             reply)
        elif msg.type == MsgType.Fleet_Route:
            self._c_route_pulls.inc()
            self._reply_json(conn, msg, MsgType.Reply_Fleet_Route,
                             self.group.routing_payload())
        elif msg.type == MsgType.Fleet_Stats:
            self._c_stats_pulls.inc()
            self._reply_json(conn, msg, MsgType.Reply_Fleet_Stats,
                             self.group.stats_payload())
        elif msg.type == MsgType.Fleet_Leave:
            req = unpack_json_blob(msg.data[0])
            self._reply_json(conn, msg, MsgType.Reply_Fleet_Leave,
                             self.group.leave(str(req["id"])))
        elif msg.type == MsgType.Fleet_Drain:
            req = unpack_json_blob(msg.data[0]) if msg.data else {}
            self._reply_json(conn, msg, MsgType.Reply_Fleet_Drain,
                             self._start_drain(req))
        elif msg.type == MsgType.Serve_Request and self._proxy_on:
            self._proxy_request(conn, msg)
        else:
            self._reply_error(conn, msg, f"unknown message type {msg.type}")

    # -- data-plane proxy ----------------------------------------------------
    def _proxy_request(self, conn: socket.socket, msg: Message) -> None:
        check(bool(msg.data), "request carries no payload")
        payload = np.asarray(msg.data[0])
        deadline_ms = float(msg.data[1][0]) if len(msg.data) > 1 \
            and msg.data[1].size else 100.0
        # A trace context on the proxied frame continues through the
        # embedded fleet client: the proxy hop and every replica span
        # parent under the ORIGINAL client's trace, not a router-local
        # one — that is what makes "where did this request spend its
        # time" answerable across all three processes.
        wire_ctx = unpack_trace_ctx(msg.data[2]) if len(msg.data) > 2 \
            else None
        self._c_proxied.inc()
        fleet = self._proxy()

        def relay(result, _conn=conn, _msg=msg):
            if isinstance(result, BaseException):
                self._reply_error(_conn, _msg, str(result))
                return
            values, clock = result
            reply = _msg.create_reply()
            reply.data = [np.asarray([int(clock), 0], dtype=np.int64),
                          *pack_serve_payload(np.asarray(values))]
            self._send(_conn, reply)

        with activate(wire_ctx), \
                span("fleet.proxy", runner=msg.table_id):
            if msg.table_id in self._lookup_runners:
                fleet.lookup_async(payload, relay, deadline_ms,
                                   runner_id=msg.table_id)
            else:
                fleet.generate_async(payload, relay, deadline_ms,
                                     runner_id=msg.table_id)

    # -- drain orchestration -------------------------------------------------
    def _start_drain(self, req: Dict) -> Dict:
        """Wire-level drain trigger (``Fleet_Drain``): an OPERATOR —
        not just code sharing the router's process — can start a rolling
        fleet upgrade. Runs on a background thread; progress is
        observable through ``Fleet_Route`` (per-member ``draining`` +
        monotonic ``drains_completed``). One drive at a time."""
        member_id = req.get("id")
        timeout_s = float(req.get("timeout_s", 60.0))
        with self._lock:
            if self._drain_thread is not None and \
                    self._drain_thread.is_alive():
                return {"started": False, "reason": "drain already running"}
            if member_id is not None and \
                    member_id not in self.group.member_ids():
                return {"started": False,
                        "reason": f"unknown member '{member_id}'"}

            def drive():
                if member_id is None:
                    self.rolling_drain(timeout_s_per_member=timeout_s)
                else:
                    self.drain(str(member_id), timeout_s=timeout_s)

            self._drain_thread = threading.Thread(
                target=drive, name="fleet-drain", daemon=True)
            self._drain_thread.start()
        return {"started": True,
                "members": self.group.member_ids(),
                "rolling": member_id is None}

    def drain(self, member_id: str, timeout_s: float = 60.0) -> bool:
        """Drain ONE member and wait for its cycle to complete (the
        member's monotonic drains_completed stat ticking past its
        pre-drain value — robust to drains faster than a heartbeat).
        Returns False if the cycle never completed inside the timeout
        (the member keeps serving whatever it has; the ring keeps
        excluding it while it reports draining)."""
        before = self.group.drains_completed(member_id)
        check(before is not None, f"unknown fleet member '{member_id}'")
        self.group.drain(member_id)
        deadline = time.monotonic() + timeout_s
        delay = 0.01
        while time.monotonic() < deadline:
            done = self.group.drains_completed(member_id)
            if done is None:
                return False          # died mid-drain; sweep took it
            if done > before and not self.group.is_draining(member_id):
                return True           # full cycle: out and back in
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)
        return False

    def rolling_drain(self, timeout_s_per_member: float = 60.0) -> bool:
        """Drain every current member, one at a time — the zero-downtime
        fleet upgrade. Stops (returns False) on the first member that
        fails to complete its cycle."""
        for member_id in self.group.member_ids():
            log.info("fleet: rolling drain -> %s", member_id)
            if not self.drain(member_id, timeout_s=timeout_s_per_member):
                log.error("fleet: rolling drain stalled at %s", member_id)
                return False
        return True

    # -- plumbing ------------------------------------------------------------
    def _sweep_loop(self) -> None:
        from multiverso_tpu_torch.telemetry import watchdog_scope
        interval = self.group.heartbeat_ms / 1e3
        # The sweeper IS the fleet's failure detector: a stuck sweep
        # means dead replicas stay routable — watchdog it like every
        # other daemon loop (telemetry/flight.py).
        with watchdog_scope("fleet-sweeper",
                            timeout_s=max(30.0, 60 * interval)) as wd:
            while not self._sweep_stop.wait(interval):
                wd.beat()
                self.group.sweep()
                # Shard-load gauges for the imbalance alert rule: the
                # sweeper already runs at heartbeat cadence, so the
                # ratio series is as fresh as liveness itself.
                rates = self.group.publish_load_gauges()
                # Skew actuation on the same clock: nominate/demote hot
                # keys, then migrate vnodes if imbalance survives the
                # replication (both no-ops when not armed).
                if self.replicator is not None:
                    self.replicator.tick()
                if self.rebalancer is not None:
                    self.rebalancer.tick(rates)

    def _reply_json(self, conn: socket.socket, msg: Message,
                    reply_type: int, payload: Dict) -> None:
        reply = Message(src=msg.dst, dst=msg.src, type=reply_type,
                        table_id=msg.table_id, msg_id=msg.msg_id,
                        data=[pack_json_blob(payload)])
        self._send(conn, reply)

    def _reply_error(self, conn: socket.socket, msg: Message,
                     reason: str) -> None:
        err = Message(src=msg.dst, dst=msg.src, type=MsgType.Reply_Error,
                      table_id=msg.table_id, msg_id=msg.msg_id,
                      data=[np.frombuffer(reason.encode(), dtype=np.uint8)])
        self._send(conn, err)

    def _send(self, conn: socket.socket, reply: Message) -> None:
        send_lock = self._conns.get(conn)
        if send_lock is None:
            return          # connection already gone
        try:
            with send_lock:
                send_message(conn, reply)
        except OSError:
            self._drop(conn)

    def _drop(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.pop(conn, None)
            self._g_conns.set(len(self._conns))
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        self._running = False
        self._sweep_stop.set()
        if self.rebalancer is not None:
            self.rebalancer.close()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            proxy = self._proxy_client
            self._proxy_client = None
        for conn in conns:
            self._drop(conn)
        if proxy is not None:
            proxy.close()
        self._sweeper.join(timeout=5)
