"""Serving clients: threaded, concurrent in-flight requests.

Port of ``multiverso_tpu/serving/client.py``. ``RoutedLookupClient``
(shard routing for the lookup runners) waits with them (ROADMAP A9).

:class:`ServingClient` multiplexes any number of concurrent requests over
ONE persistent connection — a reader thread routes replies to waiters by
msg_id (the Worker-side Communicator contract, reused for the read path).
Replies legitimately arrive out of order; a shed request completes its
waiter with a :class:`ShedError` instead of a timeout. Transport failures
are TYPED: a refused/reset connect retries with capped exponential backoff
and then surfaces as :class:`ReplicaUnavailableError` (an ``OSError``
subclass), so callers can tell "dead replica — fail over" apart from "bad
request — surface it".

"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from multiverso_tpu_torch.core.actor import Message, MsgType
from multiverso_tpu_torch.parallel.net import (pack_trace_ctx, recv_message,
                                               send_message,
                                               unpack_serve_payload)
from multiverso_tpu_torch.serving.batcher import ShedError
from multiverso_tpu_torch.telemetry import context as trace_context
from multiverso_tpu_torch.telemetry import emit_span
from multiverso_tpu_torch.telemetry.context import TraceContext
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check, log


class ReplicaUnavailableError(OSError):
    """The serving replica is unreachable: connect refused/reset after
    retries, or an established connection died mid-request. Distinct from
    :class:`ShedError` (the replica is healthy but rejected the request) so
    a fleet client can fail over instead of surfacing a bad-request."""


# Transient connect failures worth retrying: a replica mid-restart refuses,
# a listener backlog overflow resets. Anything else (EHOSTUNREACH, bad
# address) surfaces immediately.
_TRANSIENT_CONNECT = (ConnectionRefusedError, ConnectionResetError,
                      ConnectionAbortedError, socket.timeout)


#: Backoff cap and jitter fraction for :func:`connect_with_backoff`.
#: Jitter is load-bearing, not cosmetic: after a router/replica restart
#: EVERY disconnected client re-dials on the same schedule — identical
#: deterministic delays synchronize the whole fleet into reconnect
#: stampedes that land on the freshly-bound listener's backlog together
#: (and refused connects re-synchronize the next wave). Each retry
#: sleeps a uniform draw from ``[(1 - jitter) * delay, delay]`` so the
#: waves decorrelate while the CAP still bounds total dial time.
BACKOFF_CAP_S = 0.5
BACKOFF_JITTER = 0.5


def backoff_delays(attempts: int, base_delay_s: float = 0.05,
                   cap_s: float = BACKOFF_CAP_S,
                   jitter: float = BACKOFF_JITTER,
                   rng=None) -> "List[float]":
    """The retry-sleep schedule ``connect_with_backoff`` uses, exposed as
    a pure function so tests pin the envelope: delay ``i`` is uniform in
    ``[(1 - jitter) * d_i, d_i]`` with ``d_i = min(base * 2^i, cap)``."""
    import random as _random
    rng = rng or _random
    out = []
    for i in range(max(0, int(attempts) - 1)):
        d = min(base_delay_s * (2 ** i), cap_s)
        out.append(d * (1.0 - jitter * rng.random()))
    return out


def connect_with_backoff(host: str, port: int, attempts: int = 4,
                         base_delay_s: float = 0.05,
                         timeout_s: float = 30.0) -> socket.socket:
    """``socket.create_connection`` with capped exponential backoff —
    JITTERED (see :data:`BACKOFF_JITTER`) — over transient refusals.
    Raises :class:`ReplicaUnavailableError` once the attempts are spent —
    the caller knows it is a DEAD REPLICA, not a bad request."""
    attempts = max(1, int(attempts))
    delays = backoff_delays(attempts, base_delay_s)
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return socket.create_connection((host, port), timeout=timeout_s)
        except _TRANSIENT_CONNECT as e:
            last = e
            if i + 1 < attempts:
                # reconnect backoff during failover: the fleet layer
                # attributes this interval as its fleet.park span
                # graftlint: disable=unattributed-wait
                time.sleep(delays[i])
    raise ReplicaUnavailableError(
        f"replica {host}:{port} unavailable after {attempts} connect "
        f"attempts: {last}")


class ServeResult:
    """Waiter for one in-flight request. ``add_callback`` registers a
    completion hook (fired on the reader thread — reply, server error, or
    lost connection alike); a callback added after completion fires
    immediately on the caller's thread."""

    __slots__ = ("event", "slot", "_callbacks", "_cb_lock", "msg_id",
                 "ctx")

    def __init__(self):
        self.event = threading.Event()
        self.slot: List[object] = []
        self._callbacks: List[Callable[["ServeResult"], None]] = []
        self._cb_lock = make_lock("serve.result.cb")
        #: Wire id of the request this result waits on — what
        #: :meth:`ServingClient.cancel` takes to cancel a hedged loser.
        self.msg_id = -1
        #: Trace context of the request (None untraced) — the reader
        #: thread emits the ``serve.deliver`` phase span under it.
        self.ctx: Optional[TraceContext] = None

    def add_callback(self, fn: Callable[["ServeResult"], None]) -> None:
        with self._cb_lock:
            if not self.event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)        # already complete: fire now, outside the lock

    def _complete(self) -> None:
        with self._cb_lock:
            self.event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception as e:  # noqa: BLE001 - a callback raise must
                # not kill the reader loop delivering sibling replies
                log.error("serve client: completion callback failed: %s", e)

    def wait(self, timeout: Optional[float] = 60.0):
        """Returns ``(values, clock)``; raises :class:`ShedError` when the
        server shed the request, :class:`ReplicaUnavailableError` on a
        lost connection."""
        # whole-residency wait: the root serve.client span measures it
        # and the phase ledger decomposes it — not a hidden phase
        # graftlint: disable=unattributed-wait
        check(self.event.wait(timeout), "serve request timed out")
        if not self.slot:
            raise ReplicaUnavailableError(
                "connection to serving service lost")
        msg = self.slot[0]
        if msg.type == MsgType.Reply_Error:
            reason = msg.data[0].tobytes().decode() if msg.data else "?"
            raise ShedError("server", reason)
        clock = int(msg.data[0][0])
        values = unpack_serve_payload(msg.data[1:])
        return values, clock


def _emit_client_span(res: "ServeResult", ctx: TraceContext,
                      t_send: float) -> None:
    """Root-span emission for a plain (fleet-less) client request —
    fires on the reader thread at completion. Unsampled requests record
    only when the outcome is a tail exemplar (shed / lost connection /
    slower than ``-telemetry_slow_ms``)."""
    dur_ms = (time.monotonic() - t_send) * 1e3
    outcome = ""
    if not res.slot:
        outcome = "error"
    elif res.slot[0].type == MsgType.Reply_Error:
        outcome = "shed"
    force = bool(outcome) or dur_ms > trace_context.slow_ms()
    if outcome:
        emit_span("serve.client", ctx, t_send, dur_ms, force=force,
                  outcome=outcome)
    else:
        emit_span("serve.client", ctx, t_send, dur_ms, force=force)


class ServingClient:
    """One persistent connection; thread-safe concurrent requests."""

    # Random 48-bit start: a restarted client can't collide with its
    # previous incarnation's in-flight ids on a long-lived server conn.
    _msg_counter = int.from_bytes(os.urandom(6), "little")
    _counter_lock = make_lock("serve.client.msgid")

    def __init__(self, host: str, port: int, connect_attempts: int = 4):
        self._sock = connect_with_backoff(host, port,
                                          attempts=connect_attempts)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = make_lock("serve.client.send")
        self._waiters: Dict[int, ServeResult] = {}
        self._waiters_lock = make_lock("serve.client.waiters")
        self._dead = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="serve-client", daemon=True)
        self._reader.start()

    @classmethod
    def _next_msg_id(cls) -> int:
        with cls._counter_lock:
            cls._msg_counter += 1
            return cls._msg_counter

    def request_async(self, payload: np.ndarray,
                      deadline_ms: float = 100.0,
                      runner_id: int = 0,
                      on_done: Optional[Callable[[ServeResult], None]]
                      = None,
                      trace_ctx: Optional[TraceContext] = None
                      ) -> ServeResult:
        """``on_done`` (optional) fires on the reader thread at completion
        — success, server error, and lost connection alike — so a fleet
        client or proxy can hedge/relay without a thread per request.

        Trace context: an explicit ``trace_ctx`` (fleet attempts) or the
        thread's current context propagates to the server as one extra
        wire blob; with neither, this client IS the trace root — it draws
        the head sampling decision and records a ``serve.client`` span at
        completion (force-recorded for shed/error/slow outcomes even
        when unsampled: the tail exemplars)."""
        if self._dead:
            raise ReplicaUnavailableError(
                "connection to serving service is closed")
        ctx = trace_ctx
        owns_root = False
        if ctx is None:
            ctx = trace_context.current_context()
            if ctx is None:
                ctx = trace_context.maybe_new_root()
                owns_root = ctx is not None
        data = [np.ascontiguousarray(payload),
                np.asarray([deadline_ms], dtype=np.float64)]
        if ctx is not None:
            data.append(pack_trace_ctx(ctx))
        msg = Message(type=MsgType.Serve_Request, table_id=runner_id,
                      msg_id=self._next_msg_id(), data=data)
        result = ServeResult()
        result.msg_id = msg.msg_id
        result.ctx = ctx
        if owns_root:
            t_send = time.monotonic()
            result.add_callback(
                lambda res, _ctx=ctx, _t=t_send: _emit_client_span(
                    res, _ctx, _t))
        if on_done is not None:
            result.add_callback(on_done)
        with self._waiters_lock:
            self._waiters[msg.msg_id] = result
        t_wire0 = time.monotonic()
        try:
            with self._send_lock:
                # _send_lock exists to serialize frame writes on the one
                # shared socket — the wire wait IS the serialized step.
                # graftlint: disable=lock-held-across-blocking
                send_message(self._sock, msg)
        except OSError as e:
            with self._waiters_lock:
                self._waiters.pop(msg.msg_id, None)
            raise ReplicaUnavailableError(
                f"send to serving service failed: {e}") from e
        if ctx is not None and ctx.sampled:
            # Phase ledger: the request-side wire leg (serialization +
            # socket write, including the send-lock wait).
            emit_span("serve.send", trace_context.child_of(ctx), t_wire0,
                      (time.monotonic() - t_wire0) * 1e3)
        return result

    def cancel(self, msg_id: int, runner_id: int = 0) -> None:
        """Best-effort server-side cancel of an in-flight request (the
        hedged-loser path): the server drops it at admission if it has
        not reached the device. No reply of its own — a successfully
        cancelled request completes its waiter with
        ``ShedError("cancelled")`` via the original msg_id."""
        msg = Message(type=MsgType.Serve_Cancel, table_id=runner_id,
                      msg_id=msg_id, data=[])
        try:
            with self._send_lock:
                # Same frame-serialization contract as request_async.
                # graftlint: disable=lock-held-across-blocking
                send_message(self._sock, msg)
        except OSError:
            pass    # dead conn: the waiter completes via the read loop

    def lookup(self, keys, deadline_ms: float = 100.0,
               runner_id: int = 0,
               timeout: Optional[float] = 60.0) -> np.ndarray:
        """Synchronous row lookup; returns the value rows."""
        values, _ = self.request_async(
            np.asarray(keys, dtype=np.int32), deadline_ms,
            runner_id).wait(timeout)
        return values

    def generate(self, tokens, deadline_ms: float = 1000.0,
                 runner_id: int = 0,
                 timeout: Optional[float] = 60.0) -> np.ndarray:
        """Synchronous greedy decode; returns the generated token ids."""
        values, _ = self.request_async(
            np.asarray(tokens, dtype=np.int32), deadline_ms,
            runner_id).wait(timeout)
        return values

    def _read_loop(self) -> None:
        try:
            while True:
                msg = recv_message(self._sock)
                if msg is None:
                    break
                t_arrive = time.monotonic()
                with self._waiters_lock:
                    waiter = self._waiters.pop(msg.msg_id, None)
                if waiter is not None:
                    waiter.slot.append(msg)
                    waiter._complete()
                    wctx = waiter.ctx
                    if wctx is not None and wctx.sampled:
                        # Phase ledger: client-side delivery — reply
                        # arrival through every completion callback.
                        emit_span("serve.deliver",
                                  trace_context.child_of(wctx), t_arrive,
                                  (time.monotonic() - t_arrive) * 1e3)
        except OSError:
            pass
        self._dead = True
        with self._waiters_lock:
            pending = list(self._waiters.values())
            self._waiters.clear()
        for waiter in pending:
            waiter._complete()      # empty slot -> ReplicaUnavailableError

    @property
    def dead(self) -> bool:
        """True once the connection is lost; a pool should discard and
        re-dial rather than keep submitting into the dead socket."""
        return self._dead

    def close(self) -> None:
        """Close the connection and wait up to 10 s for the reader thread
        (``shutdown`` wakes its blocked ``recv``)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=10.0)
