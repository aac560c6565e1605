"""Request-level serving service over the DCN binary framing.

Port of ``multiverso_tpu/serving/service.py``.

Reuses ``parallel/net.py``'s message framing (the same single-buffer
header + size-prefixed-blob layout the PS request path speaks) with the
``Serve_Request``/``Serve_Reply`` message kinds: a request carries the
payload array (row ids / prompt tokens) plus a float64 meta blob
``[deadline_ms]``; the reply carries ``[meta(int64 [clock, shed]),
marker, values]`` where the value payload may ride as bf16 halves behind
``-serve_wire_dtype=bf16`` (``net.pack_serve_payload``). A shed request
answers with ``Reply_Error`` + a reason string blob, so the client's
waiter fails loudly instead of riding out its deadline.

Threading: one accept thread + one reader thread per connection (serving
connections are few and long-lived — a client multiplexes its concurrent
requests over one socket by msg_id). Replies are written by the batcher's
completion callback under a per-connection send lock, so in-flight
requests complete OUT OF ORDER and a slow decode never convoys a cheap
lookup behind it.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch.core.actor import Message, MsgType
from multiverso_tpu_torch.parallel.net import (pack_serve_payload,
                                               recv_message, send_message,
                                               unpack_trace_ctx)
from multiverso_tpu_torch.serving.batcher import DynamicBatcher, ShedError
from multiverso_tpu_torch.telemetry import (activate, child_of, counter,
                                            emit_span, gauge, histogram)
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check, log


def _wire_dtype() -> str:
    from multiverso_tpu_torch.utils.configure import flag_or
    return flag_or("serve_wire_dtype", "f32")


def _flag_or(name: str, default):
    """Flag value, or ``default`` when flags are unparsed (bare library
    use — unit tests construct services without ``mv.init``)."""
    from multiverso_tpu_torch.utils.configure import flag_or
    return flag_or(name, default)


class ServingService:
    """Owns runners + their batchers; serves framed requests over TCP."""

    MAX_CONNS = 256

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._batchers: Dict[int, DynamicBatcher] = {}
        self._runners: Dict[int, object] = {}
        self._lock = make_lock("serve.service")
        self._running = True
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.address = self._listener.getsockname()
        self._conns: Dict[socket.socket, threading.Lock] = {}
        # In-flight requests by (conn identity, msg_id): the lookup table
        # Serve_Cancel needs to reach a queued request's cancel token.
        # Entries are popped in on_done, which the batcher fires exactly
        # once per admitted request — the map is bounded by true inflight.
        self._inflight: Dict[Tuple[int, int],
                             Tuple[DynamicBatcher, object]] = {}
        self._inflight_lock = make_lock("serve.inflight")
        self._g_conns = gauge("serve.connections")
        self._c_replies = counter("serve.replies")
        self._c_cancel_req = counter("serve.cancel.requests")
        self._c_cancel_miss = counter("serve.cancel.miss")
        self._h_reply = histogram("serve.latency.reply")
        self._h_total = histogram("serve.latency.total")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serve-accept", daemon=True)
        self._accept_thread.start()

    # -- runner registry ----------------------------------------------------
    def register_runner(self, runner, runner_id: int = 0,
                        buckets: Sequence[int] = (8, 16, 32, 64),
                        max_batch: int = 8, max_wait_ms: float = 2.0,
                        max_queue: int = 64, pipeline_depth=None,
                        continuous: Optional[bool] = None,
                        paged: Optional[bool] = None,
                        kv_dtype: Optional[str] = None,
                        kv_page: Optional[int] = None,
                        kv_pages: Optional[int] = None,
                        prefix_entries: Optional[int] = None) -> None:
        """``pipeline_depth``: in-flight dispatch window (int, or "auto"
        for the measured-latency decision table; None reads the
        ``-serve_pipeline_depth`` flag). ``continuous``: iteration-level
        continuous batching for decode runners that support it (None
        reads ``-serve_continuous``); ignored for runners without the
        per-step contract. ``paged``/``kv_dtype``/``kv_page``/
        ``kv_pages``/``prefix_entries``: the decode memory hierarchy
        (docs/SERVING.md) — None reads ``-serve_paged_kv`` /
        ``-serve_kv_dtype`` / ``-serve_kv_page`` / ``-serve_kv_pages`` /
        ``-serve_prefix_cache``."""
        if pipeline_depth is None:
            pipeline_depth = _flag_or("serve_pipeline_depth", "auto")
        if continuous is None:
            continuous = bool(_flag_or("serve_continuous", False))
        if paged is None:
            paged = bool(_flag_or("serve_paged_kv", False))
        if kv_dtype is None:
            kv_dtype = str(_flag_or("serve_kv_dtype", "f32"))
        if kv_page is None:
            kv_page = int(_flag_or("serve_kv_page", 16))
        if kv_pages is None:
            kv_pages = int(_flag_or("serve_kv_pages", 0))
        if prefix_entries is None:
            prefix_entries = int(_flag_or("serve_prefix_cache", 0))
        # Config validation OUTSIDE the degrade guard below: a bad flag
        # combination must fail bring-up loudly — only a genuine
        # checkpoint-layout incompatibility degrades to drain batching.
        from multiverso_tpu_torch.serving.quant import storage_dtype
        kv_dtype = storage_dtype(kv_dtype)
        check(int(kv_page) >= 1, "-serve_kv_page must be >= 1")
        check(kv_dtype == "f32" or paged,
              "-serve_kv_dtype requires -serve_paged_kv")
        check(int(prefix_entries) == 0 or paged,
              "-serve_prefix_cache requires -serve_paged_kv")
        # Reserve the id under the lock, BUILD OUTSIDE it, publish under
        # it again. Batcher construction spawns dispatcher threads and —
        # with pipeline_depth="auto" — runs a measured device-sync
        # probe; holding the registry lock across that convoyed
        # quiesce()/warmup() and every concurrent registration behind
        # one runner's bring-up (lock-held-across-blocking caught it).
        with self._lock:
            check(runner_id not in self._batchers
                  and runner_id not in self._runners,
                  f"runner id {runner_id} already registered")
            self._runners[runner_id] = runner       # reserves the id
        batcher = None
        try:
            if continuous and hasattr(runner, "params_ref"):
                from multiverso_tpu_torch.serving.continuous import \
                    ContinuousBatcher
                try:
                    batcher = ContinuousBatcher(
                        runner, buckets, max_batch=max_batch,
                        max_queue=max_queue, paged=paged,
                        kv_dtype=kv_dtype, page=kv_page,
                        pool_pages=kv_pages or None,
                        prefix_entries=prefix_entries)
                except Exception as e:  # noqa: BLE001 - an unsupported
                    # checkpoint layout (MoE / pipeline attention_lm)
                    # must DEGRADE to drain batching, not crash serving
                    # bring-up.
                    log.warning(
                        "-serve_continuous: runner %s does not support "
                        "continuous decode (%s); degrading to drain "
                        "batching", getattr(runner, "name", "?"), e)
            if batcher is None:
                batcher = DynamicBatcher(
                    runner, buckets, max_batch=max_batch,
                    max_wait_ms=max_wait_ms, max_queue=max_queue,
                    pipeline_depth=pipeline_depth)
        except BaseException:
            with self._lock:        # un-reserve on a failed build
                self._runners.pop(runner_id, None)
            raise
        with self._lock:
            self._batchers[runner_id] = batcher

    def batcher(self, runner_id: int = 0) -> DynamicBatcher:
        return self._batchers[runner_id]

    # -- fleet lifecycle hooks ----------------------------------------------
    def quiesce(self, timeout_s: float = 30.0) -> bool:
        """Wait for every batcher to reach a quiet instant (empty queue,
        no batch mid-dispatch). The fleet drain barrier: a replica calls
        this before hot-swapping its checkpoint so no in-flight batch
        straddles the swap. The listener stays up — requests arriving
        during a drain are still served, never dropped."""
        with self._lock:
            batchers = list(self._batchers.values())
        deadline = time.monotonic() + max(0.0, timeout_s)
        for b in batchers:
            if not b.quiesce(max(0.0, deadline - time.monotonic())):
                return False
        return True

    def warmup(self) -> int:
        """Drive one zero batch per (runner, bucket) straight through each
        runner — compiles/refreshes every bucket executable so the first
        real request after bring-up or a checkpoint swap never pays a
        trace. Returns the number of executables warmed."""
        with self._lock:
            pairs = [(self._runners[rid], b)
                     for rid, b in self._batchers.items()]
        warmed = 0
        for runner, b in pairs:
            if hasattr(b, "warmup"):
                # Continuous decode owns its own executables (prefill +
                # step per bucket) — warm those, not the drain decode.
                warmed += b.warmup()
                continue
            dtype = getattr(runner, "payload_dtype", np.int32)
            pad_id = getattr(runner, "pad_id", 0)
            for bucket in b.ladder.buckets:
                mat = np.full((b.max_batch, bucket), pad_id, dtype=dtype)
                runner.run(mat, np.zeros(b.max_batch, dtype=np.int32))
                warmed += 1
        return warmed

    # -- connection handling -------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if len(self._conns) >= self.MAX_CONNS:
                    conn.close()
                    continue
                self._conns[conn] = make_lock("serve.conn")
                self._g_conns.set(len(self._conns))
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="serve-conn", daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            while self._running:
                try:
                    msg = recv_message(conn)
                except (IOError, OSError):
                    break
                if msg is None:
                    break
                if msg.type == MsgType.Serve_Cancel:
                    self._cancel(conn, msg)
                    continue
                if msg.type != MsgType.Serve_Request:
                    self._reply_error(conn, msg, "unknown message type")
                    continue
                try:
                    self._handle(conn, msg)
                except Exception as e:  # noqa: BLE001 - a bad request
                    # answers with an error; dropping the socket would
                    # abandon every OTHER in-flight request multiplexed
                    # on this connection.
                    log.error("serving: request %d failed: %s",
                              msg.msg_id, e)
                    self._reply_error(conn, msg, f"bad request: {e}")
        finally:
            self._drop(conn)

    def _handle(self, conn: socket.socket, msg: Message) -> None:
        t0 = time.monotonic()
        batcher = self._batchers.get(msg.table_id)
        if batcher is None:
            self._reply_error(conn, msg, f"no runner {msg.table_id}")
            return
        if not msg.data:
            self._reply_error(conn, msg, "request carries no payload")
            return
        payload = msg.data[0]
        deadline_ms = float(msg.data[1][0]) if len(msg.data) > 1 \
            and msg.data[1].size else 100.0
        # Third blob (optional): the client's trace context. The server's
        # residency span is a child of it; the batcher inherits the server
        # span as the parent for the per-stage spans.
        wire_ctx = unpack_trace_ctx(msg.data[2]) if len(msg.data) > 2 \
            else None
        server_ctx = child_of(wire_ctx) if wire_ctx is not None else None
        runner = self._runners[msg.table_id]
        runner_name = getattr(runner, "name", "?")
        inflight_key = (id(conn), msg.msg_id)

        done_flag: list = []

        def on_done(result, _conn=conn, _msg=msg, _t0=t0):
            t1 = time.monotonic()
            with self._inflight_lock:
                done_flag.append(1)
                self._inflight.pop(inflight_key, None)
            shed_reason = result.reason if isinstance(result, ShedError) \
                else ""
            if shed_reason:
                self._reply_error(_conn, _msg, str(result))
            else:
                reply = _msg.create_reply()
                # A hot-row cache hit carries the stamp of the bytes it
                # actually serves (StampedRows); everything else reports
                # the runner's last-batch clock. Using runner.clock()
                # for hits let a staleness>0 reply claim a NEWER version
                # than its rows.
                stamp = getattr(result, "clock_stamp", None)
                clock = float(stamp) if stamp is not None else \
                    float(getattr(runner, "clock", lambda: -1.0)())
                # Retired BSP worlds report an INF clock (every worker
                # finished); the wire meta is int64, so stamp the
                # "no finite version" sentinel instead of overflowing.
                clock_i = int(clock) if np.isfinite(clock) else -1
                meta = np.asarray([clock_i, 0], dtype=np.int64)
                reply.data = [meta, *pack_serve_payload(
                    np.asarray(result), _wire_dtype())]
                self._send(_conn, reply)
                self._c_replies.inc()
            now = time.monotonic()
            self._h_reply.observe((now - t1) * 1e3)
            self._h_total.observe((now - _t0) * 1e3)
            if server_ctx is not None:
                if server_ctx.sampled:
                    emit_span("serve.reply", child_of(server_ctx), t1,
                              (now - t1) * 1e3)
                # Sheds force-record the residency span even when
                # head-unsampled — the tail exemplar is the point.
                if shed_reason:
                    emit_span("serve.request", server_ctx, _t0,
                              (now - _t0) * 1e3, force=True,
                              runner=runner_name, shed=shed_reason)
                else:
                    emit_span("serve.request", server_ctx, _t0,
                              (now - _t0) * 1e3, runner=runner_name)

        with activate(server_ctx):
            token = batcher.submit_callback(payload, deadline_ms, on_done)
        if token is not None:
            with self._inflight_lock:
                # A fast request can complete (popping the key) before
                # this insert runs; registering it anyway would leak the
                # entry forever. done_flag is written under this same
                # lock, so the check-and-insert is race-free.
                if not done_flag:
                    self._inflight[inflight_key] = (batcher, token)

    def _cancel(self, conn: socket.socket, msg: Message) -> None:
        """Serve_Cancel: a hedged winner landed elsewhere — drop the
        loser at admission if it has not reached the device. Best-effort
        and reply-less: a successfully cancelled request answers its
        ORIGINAL msg_id with Reply_Error("cancelled") via the batcher's
        delivery path, a too-late cancel changes nothing."""
        self._c_cancel_req.inc()
        with self._inflight_lock:
            entry = self._inflight.get((id(conn), msg.msg_id))
        if entry is None:
            self._c_cancel_miss.inc()
            return
        batcher, token = entry
        if not batcher.cancel(token):
            self._c_cancel_miss.inc()

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
        _shut(conn)

    def close(self) -> None:
        """Stop listening, drop every connection and close every batcher;
        waits up to 10 s for the accept thread."""
        self._running = False
        _shut(self._listener)
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            self._drop(conn)
        with self._lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.close()
        self._accept_thread.join(timeout=10.0)


def _shut(sock: socket.socket) -> None:
    """Shut a socket down, then close it: ``shutdown`` wakes a thread
    blocked in its ``accept``/``recv``, which ``close`` alone does not."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass
