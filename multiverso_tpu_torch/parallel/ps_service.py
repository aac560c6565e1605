"""Cross-process async parameter server (host TCP service).

Port of ``multiverso_tpu/parallel/ps_service.py``: the same threads, wire
messages, BSP gate, reply cache, deferred requests, write-ahead log,
snapshots, membership directory and wire filters, over shards that keep
their tables on the card in the port's ``ServerStore``. The dispatcher
hands the store numpy arrays, and the store applies them with the port's
row routes (B2 on a ``use_pallas`` sgd or default table, the fused
stateful kernel on a ``use_pallas`` stateful one, ``add_rows_sorted`` and
B4 or the combine's fold otherwise). Every read is the store's
``read_rows`` (B1 for a float32 table) or ``read``, issued under the
store lock, then one device-to-host copy (:func:`_host`). Decoded wire
blobs are fresh writable arrays (``parallel/net.py``), so no host buffer
the wire layer reuses reaches an asynchronous copy. An error of the card
(a CUDA error raised on the dispatcher) fails the request with
``Reply_Error``, is kept in :attr:`PSService.fatal`, and stops the
dispatcher: it is never swallowed by the service's loop.

This is the reference's core architecture at multi-node scale — SURVEY.md §7
"hard part (a)": N worker processes push deltas / pull parameters against
tables sharded across server processes, per-request, asynchronously. Roles:

* :class:`PSService` — the Server+Communicator analog: a listener thread
  accepts peer connections; per-connection reader threads deserialize
  requests and dispatch to the owning shard (which applies the
  updater on the local device), then reply on the same connection.
* :class:`PeerClient` — the Worker-side Communicator: one persistent
  connection per server process, a reader thread routing replies to
  waiters by msg_id (the reference's Waiter contract: a request completes
  when ALL touched servers replied).
* :class:`DistributedArrayTable` / :class:`DistributedMatrixTable` — worker
  handles that partition requests with the reference's offset arithmetic
  (contiguous / row ranges), serve the local shard directly (LocalForward),
  and fan out the rest over the wire.

Consistency contract = the reference's async mode: adds are applied by the
owning server in arrival order; gets see whatever has been applied (no
clocks). BSP across processes should use the collective path instead.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import queue as _queue_mod
import selectors
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.core.actor import Message, MsgType
from multiverso_tpu_torch.core.options import AddOption, GetOption
from multiverso_tpu_torch.core.table import ServerStore
from multiverso_tpu_torch.core.updater import get_updater
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.parallel.net import recv_message, send_message
from multiverso_tpu_torch.runtime.ffi import DeltaBuffer
from multiverso_tpu_torch.telemetry import counter, gauge
from multiverso_tpu_torch.telemetry.sketch import record_keys
from multiverso_tpu_torch.utils.configure import get_flag
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.utils.log import check, log
from multiverso_tpu_torch.utils.quantization import OneBitsFilter, SparseFilter
from multiverso_tpu_torch.utils.locks import make_lock, make_rlock


def reference_server_offsets(size: int, num_servers: int) -> Tuple[int, ...]:
    """The reference's contiguous partition: even split, last server takes the
    remainder (``src/table/array_table.cpp:98-108``). Returned offsets have
    length num_servers + 1. (A copy of ``multiverso_tpu/parallel/mesh.py``'s,
    whose module imports jax.)"""
    each = size // num_servers if num_servers else size
    offsets = [min(i * each, size) for i in range(num_servers)]
    offsets.append(size)
    return tuple(offsets)


def _host(values) -> np.ndarray:
    """A store read as a host array: one device-to-host copy of a tensor
    (a bfloat16 table widens to float32), a numpy array as it is."""
    if isinstance(values, np.ndarray):
        return values
    from multiverso_tpu_torch.core.table import host_array
    return host_array(values)


def _host_f32(values) -> np.ndarray:
    """A client's delta as a float32 host array: a tensor, on the card or
    on the host, is read to the host first (what a model pushes, e.g.
    logreg's ``PSModel``)."""
    import torch
    if isinstance(values, torch.Tensor):
        values = _host(values.detach())
    return np.asarray(values, dtype=np.float32)


def is_device_error(e: BaseException) -> bool:
    """True for an error raised by the card (a CUDA error surfaced by
    torch), which must fail the run, not just the request."""
    name = type(e).__name__
    return name in ("AcceleratorError", "OutOfMemoryError") or (
        isinstance(e, RuntimeError) and "CUDA" in str(e))


class _TableSyncGate:
    """SyncServer clock gating for one table shard (ref src/server.cpp:68-222).

    Per-worker vector clocks for adds and gets; a request that is ahead of
    the lagging workers is CACHED (per-worker FIFO, preserving each
    worker's program order) and drained when the laggards catch up — the
    reference's cache-and-drain, which is mandatory here for the same
    reason it was there: the single dispatcher thread must never block on
    a gate whose unlocking traffic arrives through the same loop. Worker
    identity travels in the request exactly as the reference's
    AddOption/GetOption worker_id does (``updater.h:10-110``,
    ``sparse_matrix_table.cpp:36-43``): Adds carry it in the option
    scalars, BSP Gets append a worker-id blob; a message without either
    falls back to the sending rank.
    """

    def __init__(self, num_workers: int):
        from multiverso_tpu_torch.core.sync_coordinator import VectorClock
        self._n = num_workers
        self._adds = VectorClock(num_workers)
        self._gets = VectorClock(num_workers)
        self.cached: Dict[int, "collections.deque"] = \
            collections.defaultdict(collections.deque)
        # Elastic membership (Control_Elastic): retired slots reusable by
        # later joins, and a version stamp drills can watch re-form on.
        self._free: List[int] = []
        self.version = 0

    def worker_of(self, msg: Message) -> int:
        if msg.type == MsgType.Request_Add and len(msg.data) > 1:
            w = int(msg.data[1][0])         # AddOption scalars, worker_id
        elif msg.type == MsgType.Request_Get and len(msg.data) > 1 \
                and msg.data[1].size:
            w = int(msg.data[1][0])         # GetOption analog blob
        else:
            w = max(msg.src, 0)
        return w % self._n    # an unstamped id must not kill the dispatcher

    def admissible(self, msg: Message) -> bool:
        if self.cached[self.worker_of(msg)]:
            return False        # program order: earlier ops still cached
        return self.head_admissible(msg)

    def head_admissible(self, msg: Message) -> bool:
        """Clock algebra only (used when draining a worker's queue head).

        Add from w applies only while w's get count is not ahead of the
        global min (ref ProcessAdd caching rule); Get from w serves only
        while w's add count is not ahead (ref ProcessGet) — so every
        worker's i-th Get sees identical parameters (src/server.cpp:61-67).
        """
        w = self.worker_of(msg)
        if msg.type == MsgType.Request_Add:
            return self._gets.value(w) <= self._gets.min()
        return self._adds.value(w) <= self._adds.min()

    def tick(self, msg: Message) -> None:
        if msg.type == MsgType.Request_Add:
            self._adds.tick(self.worker_of(msg))
        else:
            self._gets.tick(self.worker_of(msg))

    def finish(self, worker: int) -> None:
        """Server_Finish_Train: clocks to infinity so stragglers drain
        (ref src/server.cpp:190-213)."""
        self._adds.finish(worker % self._n)
        self._gets.finish(worker % self._n)

    # -- elastic membership (mirrors SyncCoordinator.join/leave) ----------
    def join(self, worker: "Optional[int]" = None) -> int:
        """Admit one worker into the LIVE clock group at the epoch floor;
        returns its slot id. All calls run on the single dispatcher
        thread, so membership flips atomically between ops. With an
        explicit ``worker`` the slot chosen by the membership LEADER
        (server 0) is adopted verbatim — every server must agree on the
        joiner's identity, so only the leader allocates ids."""
        inf = float("inf")
        add_floor, get_floor = self._adds.min(), self._gets.min()
        if add_floor == inf:            # group fully retired: newcomer
            add_floor = 0.0             # restarts the clocks from zero
        if get_floor == inf:
            get_floor = 0.0
        # Join at the COMMON floor, not each vector's independent min:
        # the independent mins can describe a mid-round hybrid state no
        # worker occupies, and a joiner initialized there deadlocks the
        # gates by issuing one op out of phase (see
        # SyncCoordinator.join — the elastic fuzz caught this).
        add_floor = get_floor = min(add_floor, get_floor)
        if worker is None:
            if self._free:
                w = min(self._free)     # deterministic reuse order
                self._free.remove(w)
            else:
                w = self._adds.add_slot()
                self._gets.add_slot()
        else:
            w = int(worker)
            while self._adds.size() <= w:   # pad to the leader's slot
                s = self._adds.add_slot(inf)    # count with retired
                self._gets.add_slot(inf)        # (joinable) slots
                self._free.append(s)
            if w in self._free:
                self._free.remove(w)
        self._adds.set(w, add_floor)
        self._gets.set(w, get_floor)
        self._n = self._adds.size()
        self.version += 1
        return w

    def leave(self, worker: int) -> None:
        """Retire a worker's clocks (the finish_train algebra) and free
        its slot for a later :meth:`join`. The leaver's still-gated cached
        ops are DROPPED: once its clocks are infinite they can never
        drain, and a graceful leaver has already waited out its ops (a
        SIGKILL-shaped one has no waiter left to answer)."""
        w = worker % self._n
        self._adds.finish(w)
        self._gets.finish(w)
        self.cached.pop(w, None)
        if w not in self._free:
            self._free.append(w)
        self.version += 1

    def status(self) -> Dict[str, object]:
        """Membership snapshot for drills/rollups (slots incl. retired)."""
        return {"slots": self._n, "free": sorted(self._free),
                "version": self.version}


# Dispatch-queue sentinel: re-examine deferred (early-arrival) requests.
_RECHECK = object()


class _SnapshotReq:
    """Dispatch-queue item: capture ``(store_state(), wal lsn)`` ON the
    dispatcher thread, atomically with respect to applies — the only
    thread that both applies adds and assigns WAL lsns. A snapshot taken
    anywhere else could include an add the captured lsn excludes (replay
    would double-apply it) or vice versa (replay would lose it)."""

    __slots__ = ("table_id", "event", "out")

    def __init__(self, table_id: int):
        self.table_id = table_id
        self.event = threading.Event()
        self.out: Dict[str, object] = {}

# Row-key sentinel on a Request_Get: BSP clock tick only, serve no rows
# (sent by row-routed tables to servers owning none of the touched rows so
# every worker's clock advances on every server uniformly).
TICK_GET_KEY = -2

# Row-key sentinel on a Request_Get: serve exactly the rows STALE for the
# requesting worker and mark them fresh — the reference SparseMatrixTable's
# server-side incremental whole-table Get (src/table/
# sparse_matrix_table.cpp:184-258) carried here over DCN. The worker id
# rides in the GetOption blob (msg.data[1]).
STALE_GET_KEY = -3

# Keyed variant: data = [[-4], [wid], keys] — serve only the STALE subset
# of the requested rows and mark those fresh (the reference's keyed
# UpdateGetState branch, :244-253). Reply carries the served rows' GLOBAL
# ids so the client knows which of its cached rows were refreshed.
STALE_ROWS_GET_KEY = -4


@functools.lru_cache(maxsize=256)
def _sketch_surface(table_id: int, kind: str) -> str:
    """Cached traffic-sketch surface name for one table shard's op
    stream (no per-request f-string on the dispatch path; surface
    cardinality = 2 x registered tables, hub-bounded)."""
    return f"ps.table_{table_id}.{kind}"


class _SparseShardState:
    """Per-worker staleness bitmap for one sparse table shard (ref
    ``up_to_date_[worker][row]``, sparse_matrix_table.cpp:184-197 — there
    per server process, here per PSService shard). All access is on the
    single dispatcher thread; no lock needed.

    Add semantics are the reference's EXACT UpdateAddState (:199-223):
    touched rows go stale for every worker EXCEPT the writer, whose bits
    are LEFT UNCHANGED. Forcing the writer's rows fresh would be a race:
    if another worker wrote the row after the writer's last pull, the
    writer's cache is missing that delta and only a re-pull can fix it —
    an own-write must not mask it. Plain-add clients additionally mirror
    their own delta into their cache (so rows that WERE fresh stay both
    fresh and correct); for stale rows and stateful updaters the next
    pull ships server truth, own delta included.
    """

    def __init__(self, num_workers: int, num_rows: int):
        self.stale = np.ones((num_workers, num_rows), dtype=bool)

    def on_add(self, local_rows: np.ndarray, worker: int) -> None:
        if 0 <= worker < self.stale.shape[0]:
            keep = self.stale[worker, local_rows].copy()
            self.stale[:, local_rows] = True
            self.stale[worker, local_rows] = keep
        else:       # unattributable writer: everyone is stale
            self.stale[:, local_rows] = True

    def take_stale(self, worker: int) -> np.ndarray:
        """Rows stale for ``worker``; marks them fresh (ref
        UpdateGetState, :226-258)."""
        w = worker % self.stale.shape[0]
        rows = np.flatnonzero(self.stale[w]).astype(np.int32)
        self.stale[w, rows] = False
        return rows

    def take_stale_among(self, worker: int,
                         local_rows: np.ndarray) -> np.ndarray:
        """The STALE subset of ``local_rows`` for ``worker``; marks those
        fresh (the reference's keyed UpdateGetState branch, :244-253)."""
        w = worker % self.stale.shape[0]
        local_rows = np.asarray(local_rows, dtype=np.int64)
        stale = local_rows[self.stale[w, local_rows]]
        self.stale[w, stale] = False
        return stale.astype(np.int32)


class PSService:
    """Owns local table shards; serves Get/Add requests from peers.

    Thread budget is FIXED at two regardless of world size (VERDICT r1
    weak #5 hardening): a selector IO thread reads every connection via the
    incremental frame decoder, and ONE dispatcher thread applies requests
    and writes replies. Single-threaded dispatch is also the reference's
    ordering model (the Server actor's mailbox loop, ``src/actor.cpp:14-55``
    — requests apply in arrival order). Backpressure: the IO→dispatch queue
    is bounded; when it fills, the IO thread stops draining sockets and TCP
    flow control pushes back on the senders.
    """

    MAX_QUEUE = 256       # undispatched requests before backpressure
    MAX_CONNS = 1024      # accepted connections (beyond: refused)
    MAX_WRITE_BUF = 64 << 20   # per-connection unread replies; beyond: drop
    DEDUP_WINDOW = 256         # remembered served msg_ids PER SOURCE rank
    DEDUP_MAX_BYTES = 32 << 20  # per-source reply-cache byte budget

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 register_timeout: float = 30.0):
        self._tables: Dict[int, Tuple[ServerStore, int]] = {}
        self._sync: Dict[int, _TableSyncGate] = {}
        self._sparse: Dict[int, _SparseShardState] = {}
        self._directory: Dict[int, Tuple[str, int]] = {}
        self.rank: Optional[int] = None
        self._lock = make_lock("ps.service")
        self._register_timeout = register_timeout
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.address = self._listener.getsockname()
        self._running = True
        self._reg_stop = threading.Event()   # interrupts registration retry
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ, None)
        self._decoders: Dict[socket.socket, bytearray] = {}
        # Sockets the dispatcher wants torn down; only the IO thread touches
        # the selector/_decoders (single-writer rule — a foreign-thread
        # unregister during select() is a race).
        self._to_drop: "collections.deque[socket.socket]" = \
            collections.deque()
        # Reply bytes the dispatcher wants written. The IO thread owns ALL
        # socket writes (per-connection buffers + EVENT_WRITE), so one
        # stalled peer can only fill its own buffer — it can never block
        # the dispatcher and freeze other clients' tables (VERDICT r3
        # weak #2). The wake socketpair interrupts select() so replies
        # don't wait out the poll interval.
        self._to_send: "collections.deque[Tuple[socket.socket, bytes]]" = \
            collections.deque()
        self._write_bufs: Dict[socket.socket, list] = {}
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        # Non-blocking writer too: with the socketpair buffer full a wake
        # is already pending, and a blocking send here could deadlock the
        # dispatcher against an IO thread stuck on the bounded queue.
        self._wake_w.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, None)
        # Table ops that arrived before their shard registered: parked here
        # (never blocking the dispatcher) and re-examined on registration
        # or deadline expiry.
        self._deferred: \
            "collections.deque[Tuple[socket.socket, Message, float]]" = \
            collections.deque()
        # Connections with a parked message: LATER messages on the same
        # connection defer behind it, preserving the per-connection FIFO
        # that read-your-writes rests on.
        self._deferred_socks: set = set()
        self._next_sweep = 0.0
        # Exactly-once elastic retries: an Add that was applied but whose
        # reply was lost (peer resends the SAME msg on a new connection) is
        # answered from this cache instead of re-applied (VERDICT r3
        # weak #3). Windows are PER SOURCE so one busy peer's traffic
        # can't evict another's entry before its retransmit lands.
        self._applied: "Dict[int, collections.OrderedDict[int, Message]]" \
            = {}
        self._applied_bytes: Dict[int, int] = {}
        self._queue: "_queue_mod.Queue" = _queue_mod.Queue(
            maxsize=self.MAX_QUEUE)
        # Telemetry: pending-request depth + per-worker add-stream lag
        # (docs/OBSERVABILITY.md). Counts/gauges are dispatcher-thread only.
        self._g_queue_depth = gauge("ps_service.queue_depth")
        self._g_deferred_depth = gauge("ps_service.deferred_depth")
        self._worker_add_counts: Dict[int, int] = {}
        self._top_add_count = 0
        self._staleness_gauges: Dict[int, object] = {}
        # Workers that declared Finish_Train: their add stream has
        # legitimately stopped, so the leader sweep must not keep growing
        # their published lag (a phantom ps.straggler alert would latch
        # FOREVER — the lag only ever grows and the alert can never
        # resolve). A crashed worker that never said goodbye keeps
        # aging on purpose: from this layer it is indistinguishable from
        # a wedge, which is exactly what the straggler alert is for.
        self._retired_staleness: set = set()
        # Write-ahead delta log (core/wal.py; armed via attach_wal).
        # _wal_restore_lsn: per-table "checkpoint covers lsn <= L" marks
        # from load_state; _wal_snapshot_lsn: per-table lsn of the last
        # snapshot taken (what wal_checkpoint prunes up to);
        # _wal_replayed_upto makes replay_wal idempotent.
        self._wal = None
        self._wal_sync = False
        self._wal_replaying = False
        self._wal_restore_lsn: Dict[int, int] = {}
        self._wal_snapshot_lsn: Dict[int, int] = {}
        self._wal_replayed_upto = 0
        #: The card's error that failed a request on the dispatcher (see
        #: ``_fail_device``); None while the service is healthy.
        self.fatal: Optional[BaseException] = None
        #: Directory registration threads (``enable_directory``), joined
        #: by ``close`` with the IO and dispatch threads.
        self._reg_threads: List[threading.Thread] = []
        self._io_thread = threading.Thread(target=self._io_loop, daemon=True)
        self._dispatch_thread = threading.Thread(target=self._dispatch_loop,
                                                 daemon=True)
        self._io_thread.start()
        self._dispatch_thread.start()

    @property
    def num_service_threads(self) -> int:
        """Observable bound for tests: always 2 (IO + dispatch)."""
        return sum(t.is_alive() for t in (self._io_thread,
                                          self._dispatch_thread))

    # -- shard registry -----------------------------------------------------
    def register_shard(self, table_id: int, store: ServerStore,
                       row_offset: int = 0, sync_workers: int = 0,
                       sparse_workers: int = 0,
                       sparse_rows: int = 0) -> None:
        """``sync_workers > 0`` arms BSP clock gating for this table
        (SyncServer mode, selected by ``-sync=true`` exactly as the
        reference chooses its server subclass, src/server.cpp:224-231).
        ``sparse_workers > 0`` arms server-side per-worker staleness
        tracking over ``sparse_rows`` REAL shard rows (not the padded
        store height — an empty shard must track 0 rows, or its padding
        row would ship as a phantom global row)."""
        with self._lock:
            # Gate BEFORE table: _gate_for's lock-free fast path treats
            # "in _tables but not in _sync" as a registered async table.
            if sync_workers > 0:
                self._sync.setdefault(table_id, _TableSyncGate(sync_workers))
            if sparse_workers > 0:
                self._sparse.setdefault(
                    table_id,
                    _SparseShardState(sparse_workers, max(sparse_rows, 0)))
            self._tables[table_id] = (store, row_offset)
        # Wake the dispatcher so any requests parked on this table replay.
        try:
            self._queue.put_nowait(_RECHECK)
        except _queue_mod.Full:
            pass    # dispatcher is busy; the periodic sweep will catch up

    # -- write-ahead delta log (core/wal.py; docs/DURABILITY.md) -------------
    @property
    def wal_active(self) -> bool:
        return self._wal is not None

    def attach_wal(self, directory: str, flush_interval_ms: float = 25.0,
                   sync_acks: bool = False):
        """Arm the write-ahead delta log: every accepted ``Request_Add``
        appends one CRC-framed record. ``sync_acks`` fsyncs before the
        reply (no acked-write-loss window, per-record fsync cost);
        default is group commit every ``flush_interval_ms`` (an abrupt
        kill may lose at most that window of ACKED adds — the documented
        trade). Call BEFORE announcing this seat (``enable_directory``),
        like checkpoint restore: recovery order is attach -> restore ->
        replay -> announce."""
        from multiverso_tpu_torch.core import wal as wal_mod
        check(self._wal is None, "WAL already attached")
        self._wal = wal_mod.WriteAheadLog(
            directory, flush_interval_ms=flush_interval_ms)
        self._wal_sync = bool(sync_acks)
        return self._wal

    def note_wal_restore(self, table_id: int, lsn: int) -> None:
        """A checkpoint restore covered this table's deltas up to ``lsn``
        (from the payload's ``wal_meta``): replay must skip them — and
        the appender must never RE-ISSUE them (the checkpoint may cover
        lsns whose records died unfsynced in the crash; fresh adds
        assigned those numbers would be skipped by the NEXT recovery)."""
        self._wal_restore_lsn[table_id] = max(
            self._wal_restore_lsn.get(table_id, 0), int(lsn))
        if self._wal is not None:
            self._wal.ensure_lsn_at_least(lsn)

    def _wal_log_add(self, msg: Message, opt: AddOption,
                     stamped: bool = False) -> None:
        """Log one APPLIED add, with the option AS APPLIED (staleness
        stamped server-side must replay bitwise, so the record carries
        the stamped value, not the wire original). Dispatcher-thread
        only, immediately after the apply — record order IS apply order.
        Fast path: the option was NOT rewritten, so the frame the IO
        loop pinned (``msg.raw``) IS the record — no re-serialization."""
        if self._wal is None or self._wal_replaying:
            return
        try:
            if not stamped and msg.raw is not None:
                self._wal.append(msg.raw, sync=self._wal_sync)
                return
            from multiverso_tpu_torch.parallel.net import pack_message
            logged = Message(src=msg.src, dst=msg.dst, type=msg.type,
                             table_id=msg.table_id, msg_id=msg.msg_id,
                             data=[msg.data[0], _opt_to_array(opt),
                                   *msg.data[2:]])
            self._wal.append(pack_message(logged), sync=self._wal_sync)
        except (OSError, ValueError) as e:
            # The delta is ALREADY APPLIED: letting a failed append
            # (ENOSPC, EIO on the sync-ack fsync) unwind would drop the
            # connection before the reply/dedup cache land, and the
            # peer's retransmit would DOUBLE-APPLY — trading a bounded,
            # loudly-counted durability hole for silent state
            # divergence on the exactly-once plane. Consistency wins:
            # ack proceeds, the gap is visible in ps.wal.append_errors.
            counter("ps.wal.append_errors").inc()
            log.error("wal: append failed (add applied, NOT journaled — "
                      "durability gap until next checkpoint): %s", e)

    def replay_wal(self) -> Dict[str, int]:
        """Recovery: replay the attached WAL's tail through the normal
        dispatch path. Per-record filter: skip records a checkpoint
        restore already covers (``note_wal_restore``) and records already
        replayed (idempotent — replay twice == replay once). Replayed
        adds also repopulate the exactly-once reply cache, so a peer that
        never saw its ack retransmits into a dedup hit instead of a
        double-apply. MUST run after every shard registered + restored
        and BEFORE this seat is announced (no concurrent live traffic)."""
        from multiverso_tpu_torch.core import wal as wal_mod
        from multiverso_tpu_torch.parallel.net import parse_frame
        check(self._wal is not None, "no WAL attached")
        applied = skipped = 0
        self._wal_replaying = True
        try:
            for lsn, payload in wal_mod.replay(
                    self._wal.directory,
                    since_lsn=self._wal_replayed_upto):
                try:
                    msg, _ = parse_frame(bytearray(payload))
                except Exception:  # noqa: BLE001 - CRC passed but the
                    # payload codec failed (version skew): drop the
                    # record loudly rather than kill recovery.
                    log.error("wal: unparseable record at lsn %d "
                              "dropped", lsn)
                    continue
                if msg is None or msg.type != MsgType.Request_Add:
                    skipped += 1
                    continue
                if lsn <= self._wal_restore_lsn.get(msg.table_id, 0):
                    # The checkpoint already holds this delta — but the
                    # PEER may never have seen its ack (snapshot landed,
                    # reply died with the process). Cache a reply WITHOUT
                    # re-applying, so its retransmit dedups instead of
                    # double-applying on top of the restored state.
                    self._remember_reply(msg, msg.create_reply())
                    skipped += 1
                    continue
                per = self._applied.get(msg.src)
                if per is not None and msg.msg_id in per:
                    skipped += 1    # duplicate within the log
                    continue
                reply = self._dispatch(msg)
                if reply is not None:
                    self._remember_reply(msg, reply)
                applied += 1
        finally:
            self._wal_replaying = False
        self._wal_replayed_upto = max(self._wal_replayed_upto,
                                      self._wal.lsn)
        counter_val = {"applied": applied, "skipped": skipped}
        gauge("ps.wal.replayed").set(applied)
        log.info("wal: replay applied %d records, skipped %d",
                 applied, skipped)
        return counter_val

    def snapshot_table(self, table_id: int,
                       timeout: float = 120.0) -> Tuple[Dict, int]:
        """``(store_state payload, wal lsn)`` captured atomically on the
        dispatcher thread (see :class:`_SnapshotReq`). Falls back to a
        direct (non-lsn) snapshot when no WAL is attached."""
        entry = self._tables.get(table_id)
        check(entry is not None, f"unknown table {table_id}")
        if self._wal is None:
            return entry[0].store_state(), 0
        req = _SnapshotReq(table_id)
        try:
            # Bounded put: a wedged dispatcher behind a FULL queue must
            # surface as the timeout error below, not hang the caller
            # forever in the enqueue itself.
            self._queue.put(req, timeout=timeout)
        except _queue_mod.Full:
            check(False, "snapshot request could not be enqueued "
                  "(dispatch queue full — dispatcher wedged?)")
        check(req.event.wait(timeout), "snapshot request timed out "
              "(dispatcher dead or wedged)")
        err = req.out.get("error")
        if err is not None:
            raise RuntimeError(f"snapshot of table {table_id} failed: "
                               f"{err}")
        lsn = int(req.out["lsn"])
        self._wal_snapshot_lsn[table_id] = lsn
        return req.out["payload"], lsn

    def wal_checkpoint(self) -> None:
        """Post-checkpoint log truncation: rotate to a fresh segment and
        prune sealed segments every table's newest snapshot covers.
        Purely space reclamation — recovery filters by lsn, so a crash
        between checkpoint and prune (or a prune that never runs) can
        never double-apply."""
        if self._wal is None:
            return
        self._wal.rotate()
        lsns = [self._wal_snapshot_lsn.get(t, 0) for t in self._tables]
        self._wal.prune(min(lsns) if lsns else 0)

    # -- server loops --------------------------------------------------------
    def _io_loop(self) -> None:
        from multiverso_tpu_torch.parallel.net import parse_frame
        from multiverso_tpu_torch.telemetry import watchdog_scope
        # Wedge watchdog (telemetry/flight.py). Generous timeout: the
        # bounded-queue put below legitimately blocks while the
        # dispatcher digests a backlog — that is backpressure, and only
        # minutes of it is a wedge worth a postmortem.
        with watchdog_scope("ps-io", timeout_s=120.0) as wd:
            self._run_io(parse_frame, wd)

    def _run_io(self, parse_frame, wd) -> None:
        while self._running:
            wd.beat()
            while self._to_drop:
                self._drop_conn(self._to_drop.popleft())
            self._stage_outgoing()
            try:
                events = self._selector.select(timeout=0.2)
            except OSError:
                return
            for key, mask in events:
                sock = key.fileobj
                if sock is self._listener:
                    try:
                        conn, _ = self._listener.accept()
                    except OSError:
                        continue
                    if len(self._decoders) >= self.MAX_CONNS:
                        conn.close()    # refuse: connection cap reached
                        continue
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
                    # Non-blocking is load-bearing: a blocking send() to a
                    # stalled peer would freeze the whole IO thread.
                    conn.setblocking(False)
                    self._decoders[conn] = bytearray()
                    self._selector.register(conn, selectors.EVENT_READ,
                                            None)
                    continue
                if sock is self._wake_r:
                    try:
                        while sock.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                if mask & selectors.EVENT_WRITE:
                    self._flush_writes(sock)
                if not mask & selectors.EVENT_READ:
                    continue
                try:
                    chunk = sock.recv(1 << 18)
                except (BlockingIOError, InterruptedError):
                    continue    # spurious readiness on a non-blocking conn
                except OSError:
                    chunk = b""
                if not chunk:
                    self._drop_conn(sock)
                    continue
                buf = self._decoders.get(sock)
                if buf is None:     # dropped between select() and here
                    continue
                buf.extend(chunk)
                while True:
                    try:
                        msg, consumed = parse_frame(buf)
                    except Exception:  # noqa: BLE001 - ANY malformed frame
                        # (bad magic raises IOError, but a bogus dtype tag
                        # or shape raises TypeError/ValueError from numpy)
                        # must cost the sender its connection, never the
                        # IO thread.
                        self._drop_conn(sock)
                        break
                    if msg is None:
                        break
                    if self._wal is not None and \
                            msg.type == MsgType.Request_Add:
                        # Pin the received frame so the WAL can append
                        # the wire bytes VERBATIM (one memcpy here vs a
                        # ~14us re-serialization on the dispatch hot
                        # path — measured 2x the whole remaining append
                        # cost).
                        msg.raw = bytes(buf[:consumed])
                    del buf[:consumed]
                    # Bounded queue: blocks when the dispatcher lags, which
                    # stops socket draining -> TCP backpressure upstream.
                    self._queue.put((sock, msg))

    # Compact a write buffer's consumed prefix only once it exceeds this
    # (amortized O(1) drain — `del buf[:sent]` per send would be O(n^2)
    # on the single IO thread while a connection is backlogged).
    _COMPACT_AT = 8 << 20

    def _stage_outgoing(self) -> None:
        """Move dispatcher-produced reply bytes into per-connection write
        buffers and arm EVENT_WRITE. IO-thread only. Entries are
        ``[bytearray, offset]`` — offset marks the already-sent prefix."""
        while self._to_send:
            sock, payload = self._to_send.popleft()
            if sock not in self._decoders:
                continue    # connection already gone
            entry = self._write_bufs.get(sock)
            if entry is None:
                entry = self._write_bufs[sock] = [bytearray(), 0]
            unread = len(entry[0]) - entry[1]
            if unread > self.MAX_WRITE_BUF:
                # The peer had ALREADY let more than the cap pile up before
                # this reply (so one legitimately huge reply — a >64MB
                # shard Get — never trips this on a healthy, draining
                # connection): it is not reading. Cut it loose; its
                # waiters fail fast client-side.
                log.warning("ps_service: dropping stalled peer "
                            "(%d reply bytes unread)", unread)
                self._drop_conn(sock)
                continue
            entry[0].extend(payload)
            try:
                self._selector.modify(
                    sock, selectors.EVENT_READ | selectors.EVENT_WRITE, None)
            except (KeyError, ValueError, OSError):
                self._drop_conn(sock)

    def _flush_writes(self, sock: socket.socket) -> None:
        """Write as much buffered reply data as the socket accepts; disarm
        EVENT_WRITE when drained. IO-thread only."""
        entry = self._write_bufs.get(sock)
        if entry is None:
            try:
                self._selector.modify(sock, selectors.EVENT_READ, None)
            except (KeyError, ValueError, OSError):
                pass
            return
        buf, off = entry
        try:
            sent = sock.send(memoryview(buf)[off:off + (1 << 20)])
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop_conn(sock)
            return
        off += sent
        if off >= len(buf):
            # pop, not del: close() runs _drop_conn from the caller's
            # thread and may race this entry away mid-shutdown.
            self._write_bufs.pop(sock, None)
            try:
                self._selector.modify(sock, selectors.EVENT_READ, None)
            except (KeyError, ValueError, OSError):
                self._drop_conn(sock)
            return
        if off > self._COMPACT_AT:
            del buf[:off]
            off = 0
        entry[1] = off

    def _wake_io(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass

    def _drop_conn(self, sock: socket.socket) -> None:
        try:
            self._selector.unregister(sock)
        except (KeyError, OSError, ValueError):
            pass    # already closed/unregistered (shutdown races)
        self._decoders.pop(sock, None)
        self._write_bufs.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass

    def _maybe_stamp_staleness(self, store, opt: AddOption) -> AddOption:
        """DCN leg of ``-staleness_adaptive`` (docs/DESIGN.md): stamp the
        server-observed add lag of this worker (the same counts feeding
        the ``ps_service.staleness.worker_<w>`` gauges) onto the option a
        staleness-aware updater will see — the async-mode analog of the
        sync coordinator's vector-clock lag. Dispatcher-thread only; an
        already-stamped option (client measured it closer to the source)
        passes through."""
        updater = getattr(store, "updater", None)   # host KV maps have none
        if (opt.staleness >= 0 or not get_flag("staleness_adaptive")
                or not getattr(updater, "staleness_aware", False)):
            return opt
        lag = self._top_add_count - self._worker_add_counts.get(
            opt.worker_id, 0)
        return dataclasses.replace(opt, staleness=float(max(lag, 0)))

    def _note_worker_add(self, worker: int) -> None:
        """Per-worker staleness: how many applied Adds the slowest push
        stream trails the fastest by — the async-mode analog of the BSP
        vector-clock lag (in sync mode the gated apply order makes the two
        coincide). Dispatcher-thread only. The full-sweep refresh (which
        keeps a stalled straggler's lag growing in snapshots) runs only
        when the LEADER advances; otherwise just the sender's gauge moves
        — O(1) amortized on the throughput-critical dispatch thread."""
        self._retired_staleness.discard(worker)   # an add un-retires
        n = self._worker_add_counts.get(worker, 0) + 1
        self._worker_add_counts[worker] = n
        g = self._staleness_gauges.get(worker)
        if g is None:
            g = self._staleness_gauges[worker] = gauge(
                f"ps_service.staleness.worker_{worker}")
        if n > self._top_add_count:
            self._top_add_count = n
            for w, c in self._worker_add_counts.items():
                gw = self._staleness_gauges.get(w)
                if gw is None:
                    gw = self._staleness_gauges[w] = gauge(
                        f"ps_service.staleness.worker_{w}")
                gw.set(0.0 if w in self._retired_staleness else n - c)
        else:
            g.set(self._top_add_count - n)

    def _retire_worker_staleness(self, worker: int) -> None:
        """A worker said Finish_Train (for ANY table): its add stream is
        winding down, so stop publishing its lag — zero the gauge now and
        skip it in leader sweeps, or the ps.straggler alert latches a
        permanently-firing phantom naming a worker that left cleanly.
        A worker still training OTHER tables un-retires on its very next
        add (``_note_worker_add``) and the sweep restores its true lag.
        Dispatcher-thread only, like all staleness accounting."""
        self._retired_staleness.add(worker)
        g = self._staleness_gauges.get(worker)
        if g is not None:
            g.set(0.0)

    def _dispatch_loop(self) -> None:
        from multiverso_tpu_torch.telemetry import watchdog_scope
        # Wedge watchdog: the dispatcher applies device updates — a
        # kernel that never returns wedges every table this shard
        # serves. 120s rides out any legitimate big-table dispatch.
        with watchdog_scope("ps-dispatcher", timeout_s=120.0) as wd:
            self._run_dispatch(wd)

    def _run_dispatch(self, wd) -> None:
        while True:
            wd.beat()
            self._g_queue_depth.set(self._queue.qsize())
            self._g_deferred_depth.set(len(self._deferred))
            # Sweep parked requests on EVERY pass (rate-limited), not just
            # on queue lulls — sustained traffic must not starve deferred
            # deadlines/replays (their Reply_Error is what keeps BSP's
            # no-deadline waiters from hanging silently).
            if self._deferred and time.monotonic() >= self._next_sweep:
                self._replay_deferred()
                self._next_sweep = time.monotonic() + 0.25
            try:
                # Bounded get (was: block forever on an idle queue) so an
                # idle dispatcher still beats its watchdog, and parked
                # requests' deadlines expire even with no new traffic.
                item = self._queue.get(timeout=0.5)
            except _queue_mod.Empty:
                if not self._running:
                    return      # closed while close() found the queue full
                continue
            if item is None:
                return
            if item is _RECHECK:
                self._replay_deferred()
                continue
            if isinstance(item, _SnapshotReq):
                # Atomic (payload, lsn) capture: no add can interleave —
                # this thread is the only one that applies them.
                try:
                    store, _ = self._tables[item.table_id]
                    item.out["payload"] = store.store_state()
                    item.out["lsn"] = self._wal.lsn if self._wal else 0
                except Exception as e:  # noqa: BLE001 - surface to the
                    item.out["error"] = e   # waiter, keep dispatching
                finally:
                    item.event.set()
                continue
            sock, msg = item
            if self.fatal is not None and msg.type in (
                    MsgType.Request_Add, MsgType.Request_Get):
                self._send_error(sock, msg)   # the card failed: fail fast
                continue
            try:
                self._dispatch_one(sock, msg)
            except Exception as e:  # noqa: BLE001 - malformed request must
                if is_device_error(e):       # not kill the dispatcher,
                    self._fail_device(sock, msg, e)  # but the card's
                    continue                 # errors fail the run
                log.error("ps_service: dispatch of type %d failed: %s",
                          msg.type, e)
                self._to_drop.append(sock)
                self._wake_io()

    def _send_error(self, sock: socket.socket, msg: Message) -> None:
        self._send_reply(sock, Message(src=msg.dst, dst=msg.src,
                                       type=MsgType.Reply_Error,
                                       table_id=msg.table_id,
                                       msg_id=msg.msg_id))

    def _fail_device(self, sock: socket.socket, msg: Message,
                     e: BaseException) -> None:
        """An error of the card while applying or reading: the request
        fails with ``Reply_Error``, the error is kept in :attr:`fatal`
        (``check_fatal`` raises it; ``ps_shard_main`` exits non-zero on
        it), and every later table op is refused the same way."""
        log.error("ps_service: device error on table %d (type %d): %s",
                  msg.table_id, msg.type, e)
        if self.fatal is None:
            self.fatal = e
        self._send_error(sock, msg)

    def check_fatal(self) -> None:
        """Raise the card's error that stopped this service, if any."""
        if self.fatal is not None:
            raise RuntimeError(
                f"PS service failed on a device error: {self.fatal}"
            ) from self.fatal

    def _dispatch_one(self, sock: socket.socket, msg: Message) -> None:
        unregistered = msg.table_id not in self._tables and (
            msg.type in (MsgType.Request_Add, MsgType.Request_Get)
            or (msg.type in (MsgType.Server_Finish_Train,
                             MsgType.Control_Elastic)
                and msg.table_id >= 0))
        if unregistered or sock in self._deferred_socks:
            # Peers may send traffic before this process registers the
            # table (the reference serializes this with a barrier after
            # MV_CreateTable). Park the request — NEVER block the
            # dispatcher on registration (VERDICT r3 weak #2) — and replay
            # it when register_shard wakes us. A connection with a parked
            # message parks EVERYTHING behind it: serving a later Get
            # before an earlier parked Add would break the per-connection
            # FIFO read-your-writes contract.
            self._deferred.append(
                (sock, msg, time.monotonic() + self._register_timeout))
            self._deferred_socks.add(sock)
            return
        if msg.type in (MsgType.Request_Add, MsgType.Request_Get):
            # Exactly-once for elastic retries: a resent, already-served
            # request is answered from the reply cache, not re-applied —
            # Adds would corrupt updater state, and EITHER type would
            # double-tick a BSP clock.
            per_src = self._applied.get(msg.src)
            cached = per_src.get(msg.msg_id) if per_src else None
            if cached is not None:
                self._send_reply(sock, cached)
                return
        gate = self._gate_for(msg)
        if gate is not None and not gate.admissible(msg):
            q = gate.cached[gate.worker_of(msg)]
            for i, (_, queued) in enumerate(q):
                if (queued.src, queued.msg_id) == (msg.src, msg.msg_id):
                    # Retransmit of a still-cached op (client reconnected):
                    # refresh the reply socket, don't queue a second copy.
                    q[i] = (sock, msg)
                    return
            q.append((sock, msg))
            return
        self._serve(sock, msg, gate)
        if gate is not None or msg.type in (MsgType.Server_Finish_Train,
                                            MsgType.Control_Elastic):
            self._drain_sync_caches()

    def _replay_deferred(self) -> None:
        """Re-dispatch parked requests whose table registered; expire the
        rest past their deadline with an explicit error reply so the
        peer's waiter fails LOUDLY even under BSP's no-deadline waits."""
        now = time.monotonic()
        pending = list(self._deferred)
        self._deferred.clear()
        self._deferred_socks.clear()
        for sock, msg, deadline in pending:
            if sock in self._deferred_socks:
                # An earlier message on this connection is still parked:
                # keep program order, re-park this one behind it.
                self._deferred.append((sock, msg, deadline))
                continue
            is_table_op = (
                msg.type in (MsgType.Request_Add, MsgType.Request_Get)
                or (msg.type in (MsgType.Server_Finish_Train,
                                 MsgType.Control_Elastic)
                    and msg.table_id >= 0))
            if not is_table_op or msg.table_id in self._tables:
                # Table op whose shard arrived, or a control message that
                # was parked purely for connection ordering: serve it.
                try:
                    self._dispatch_one(sock, msg)
                except Exception as e:  # noqa: BLE001 - keep the thread
                    if is_device_error(e):
                        self._fail_device(sock, msg, e)
                        continue
                    log.error("ps_service: deferred dispatch of type %d "
                              "failed: %s", msg.type, e)
                    self._to_drop.append(sock)
                    self._wake_io()
            elif now > deadline:
                log.error("ps_service: unknown table %d (no registration "
                          "within %.0fs)", msg.table_id,
                          self._register_timeout)
                err = Message(src=msg.dst, dst=msg.src,
                              type=MsgType.Reply_Error,
                              table_id=msg.table_id, msg_id=msg.msg_id)
                self._send_reply(sock, err)
            else:
                self._deferred.append((sock, msg, deadline))
                self._deferred_socks.add(sock)

    def _gate_for(self, msg: Message) -> Optional[_TableSyncGate]:
        """Sync gate for a table op, or None (async table / control msg).
        Callers guarantee the table is registered (deferral upstream), so
        these are lock-free dict reads (GIL-atomic; entries only added)."""
        if msg.type not in (MsgType.Request_Add, MsgType.Request_Get):
            return None
        return self._sync.get(msg.table_id)

    def _serve(self, sock: socket.socket, msg: Message,
               gate: Optional[_TableSyncGate]) -> None:
        """Apply + reply + (sync mode) tick the worker's clock. Clock ticks
        AFTER application, mirroring the reference's single-threaded server
        actor which applies and clocks atomically. The reply itself is
        handed to the IO thread — the dispatcher never touches a socket."""
        reply = self._dispatch_control(msg)
        if gate is not None and reply is not None:
            gate.tick(msg)
        if reply is None:
            return
        # Remember replies for non-idempotent requests: all Adds, gated
        # Gets (serving one ticks a BSP clock), and STALE gets (take_stale
        # marks rows fresh — a retransmit after a lost reply would get 0
        # rows back and silently lose those values). Byte-bounded — Get
        # replies carry row payloads.
        stale_get = (msg.type == MsgType.Request_Get and msg.data
                     and msg.data[0].size >= 1
                     and int(msg.data[0][0]) in (STALE_GET_KEY,
                                                 STALE_ROWS_GET_KEY))
        if msg.type == MsgType.Request_Add or stale_get or \
                (gate is not None and msg.type == MsgType.Request_Get):
            self._remember_reply(msg, reply)
        self._send_reply(sock, reply)

    def _remember_reply(self, msg: Message, reply: Message) -> None:
        """Exactly-once reply cache insert + byte-bounded eviction. Shared
        by the live serve path and WAL replay (a recovered shard must
        dedup retransmits of adds it applied before the crash)."""
        per = self._applied.setdefault(msg.src,
                                       collections.OrderedDict())
        per[msg.msg_id] = reply
        nbytes = self._applied_bytes.get(msg.src, 0) \
            + _reply_nbytes(reply)
        while len(per) > self.DEDUP_WINDOW or \
                nbytes > self.DEDUP_MAX_BYTES:
            _, old = per.popitem(last=False)
            nbytes -= _reply_nbytes(old)
        self._applied_bytes[msg.src] = nbytes

    def _send_reply(self, sock: socket.socket, reply: Message) -> None:
        from multiverso_tpu_torch.parallel.net import pack_message
        self._to_send.append((sock, pack_message(reply)))
        self._wake_io()

    def _drain_sync_caches(self) -> None:
        """Re-examine cached out-of-clock requests after any clock movement;
        each served message may unlock others, so loop to fixpoint (ref
        SyncServer's drain of its MtQueues, src/server.cpp:141-188)."""
        progress = True
        while progress:
            progress = False
            with self._lock:
                gates = list(self._sync.values())
            for gate in gates:
                for q in list(gate.cached.values()):
                    while q and gate.head_admissible(q[0][1]):
                        sock, msg = q.popleft()
                        self._serve(sock, msg, gate)
                        progress = True

    def _dispatch(self, msg: Message) -> Optional[Message]:
        entry = self._tables.get(msg.table_id)
        if entry is None:   # only reachable via direct tests/misuse:
            log.error("ps_service: unknown table %d", msg.table_id)
            return None     # _dispatch_one defers unregistered table ops
        store, row_offset = entry
        # Raw-wire stores (host KV maps) carry keys/values verbatim: keys
        # are arbitrary int64 hash-routed (never offset), values keep
        # their dtype (int64 word counts must not round-trip float32).
        raw_wire = getattr(store, "wire_raw", False)
        if msg.type == MsgType.Request_Add:
            # payload: [keys(int32, may be empty = whole shard),
            #           opt scalars(float32[6]; older peers send 5 —
            #           staleness reads as unmeasured), marker,
            #           *filtered delta]
            # No delta blobs at all = BSP clock tick (apply nothing).
            if len(msg.data) == 2 and msg.data[0].size == 0:
                return msg.create_reply()
            with monitor("PS_SERVICE_ADD"):   # ref server.cpp:49 monitor
                keys, opt_arr = msg.data[0], msg.data[1]
                wire_opt = _opt_from_array(opt_arr)
                opt = self._maybe_stamp_staleness(store, wire_opt)
                if raw_wire:
                    store.apply_rows(keys, msg.data[2], opt)
                    record_keys(_sketch_surface(msg.table_id, "add"),
                                keys, msg.data[2].nbytes)
                elif keys.size == 0:
                    delta = unpack_payload(msg.data[2:])  # FilterOut analog
                    store.apply_dense(delta, opt)
                    record_keys(_sketch_surface(msg.table_id, "add"),
                                keys, delta.nbytes)
                else:
                    local = keys.astype(np.int64) - row_offset
                    delta = unpack_payload(msg.data[2:])
                    store.apply_rows(local.astype(np.int32), delta, opt)
                    # GLOBAL row ids into the traffic sketch: hot keys
                    # surface in the id space operators route/shard by.
                    record_keys(_sketch_surface(msg.table_id, "add"),
                                keys, delta.nbytes)
                    st = self._sparse.get(msg.table_id)
                    if st is not None:
                        st.on_add(local, opt.worker_id)
            # Durability: the applied delta goes to the WAL in apply
            # order, with the option AS APPLIED (no-op unless attached).
            self._wal_log_add(msg, opt, stamped=opt is not wire_opt)
            # opt.worker_id is always a non-negative global id here (every
            # sender maps through _gid; AddOption defaults to 0).
            self._note_worker_add(opt.worker_id)
            return msg.create_reply()
        if msg.type == MsgType.Request_Get:
            keys = msg.data[0]
            if keys.size == 1 and int(keys[0]) == TICK_GET_KEY:
                reply = msg.create_reply()   # BSP clock tick: no rows
                reply.data = pack_payload(np.empty(0, np.float32), "none")
                return reply
            mode = _wire_mode()
            if keys.size >= 1 and int(keys[0]) == STALE_ROWS_GET_KEY:
                # Keyed incremental Get: only the stale subset of the
                # requested rows crosses the wire (ref keyed
                # UpdateGetState, :244-253). data = [[-4], [wid], keys].
                st = self._sparse.get(msg.table_id)
                wid = int(msg.data[1][0]) if len(msg.data) > 1 \
                    and msg.data[1].size else 0
                check(st is not None,
                      f"table {msg.table_id} is not sparse-tracked")
                req = msg.data[2].astype(np.int64) - row_offset
                with monitor("PS_SERVICE_GET"):
                    rows = st.take_stale_among(wid, req)
                    values = _host(store.read_rows(rows))
                record_keys(_sketch_surface(msg.table_id, "get"),
                            rows + np.int64(row_offset), values.nbytes)
                reply = msg.create_reply()
                reply.data = [rows + np.int32(row_offset),
                              *pack_payload(values, _reply_mode(mode),
                                            clip=0.0)]
                return reply
            if keys.size == 1 and int(keys[0]) == STALE_GET_KEY:
                # Incremental whole-table Get: exactly the rows stale for
                # this worker cross the wire (ref UpdateGetState), tagged
                # with their GLOBAL row ids.
                st = self._sparse.get(msg.table_id)
                wid = int(msg.data[1][0]) if len(msg.data) > 1 \
                    and msg.data[1].size else 0
                check(st is not None,
                      f"table {msg.table_id} is not sparse-tracked")
                with monitor("PS_SERVICE_GET"):
                    rows = st.take_stale(wid)
                    values = _host(store.read_rows(rows))
                record_keys(_sketch_surface(msg.table_id, "get"),
                            rows + np.int64(row_offset), values.nbytes)
                reply = msg.create_reply()
                reply.data = [rows + np.int32(row_offset),
                              *pack_payload(values, _reply_mode(mode),
                                            clip=0.0)]
                return reply
            with monitor("PS_SERVICE_GET"):   # ref server.cpp:37 monitor
                if raw_wire:
                    values = _host(store.read_rows(keys))
                elif keys.size == 0:
                    values = _host(store.read())
                else:
                    values = _host(store.read_rows(
                        keys.astype(np.int32) - row_offset))
            record_keys(_sketch_surface(msg.table_id, "get"), keys,
                        values.nbytes)
            reply = msg.create_reply()
            if raw_wire:
                reply.data = [np.ascontiguousarray(values)]
                return reply
            # FilterIn on the reply leg (ref ProcessGet,
            # sparse_matrix_table.cpp:261-309); onebit never applies to
            # absolute parameter values.
            reply.data = pack_payload(values, _reply_mode(mode),
                                      clip=0.0)
            return reply
        log.error("ps_service: unhandled type %d", msg.type)
        return None

    # -- membership directory (the Controller analog, ref
    # src/controller.cpp:38-80 — extended: registration is re-admittable,
    # not one-shot, so a restarted rank rejoins without peer intervention).
    def enable_directory(self, rank: int, peers: List[Tuple[str, int]]
                         ) -> None:
        """Adopt a rank identity and join the membership directory.
        Idempotent. EVERY service keeps a directory replica (seeded from
        the static peer list); a starting — or RESTARTING — rank
        registers its current address with every live peer, so lookups
        survive any single seat going down, including rank 0 (the
        reference Controller's one uncovered seat)."""
        if getattr(self, "rank", None) is not None:
            return
        self.rank = rank
        with self._lock:
            for r, addr in enumerate(peers):
                self._directory.setdefault(r, tuple(addr))
            self._directory[rank] = tuple(self.address)
        # Fan the registrations out CONCURRENTLY with a short foreground
        # budget: serial 10s connects to not-yet-listening cross-host
        # peers would block table construction for minutes on a cold
        # start. Stragglers keep RETRYING in the background (daemon
        # threads) until acked or the service closes — a RESTARTED seat's
        # registration is the only way peers rediscover it, and one 3s
        # shot dies under load (a busy dispatcher can take >3s to ack,
        # silently stranding every peer's retry loop on the dead
        # address; caught by the BSP fault drill under a loaded box).
        threads = []
        for r, addr in enumerate(peers):
            if r == rank:
                continue

            def reg(r=r, addr=tuple(addr)):
                deadline = time.monotonic() + 600.0
                delay = 1.0
                # Bounded-lifetime retry (600s deadline, event-
                # interruptible backoff), not a service loop: a wedge
                # here self-resolves at the deadline.
                # graftlint: disable=daemon-loop-no-watchdog
                while self._running and time.monotonic() < deadline:
                    # Re-resolve each attempt: the peer may itself have
                    # re-registered at a new address mid-loop.
                    target = self.lookup(r) or addr
                    try:
                        if not self._running:   # close() raced us: a
                            return              # dead seat must not
                        self._register_with(target, timeout=10)   # re-add
                        return                  # its address to peers
                    except OSError as e:
                        log.warning("directory registration with rank %d "
                                    "failed (retrying): %s", r, e)
                    # Event, not sleep: close() interrupts the backoff.
                    if self._reg_stop.wait(delay):
                        return
                    delay = min(delay * 2, 10.0)

            th = threading.Thread(target=reg, daemon=True)
            th.start()
            threads.append(th)
            self._reg_threads.append(th)
        for th in threads:
            th.join(timeout=3)   # fast path completes inline; rest retry

    def _register_with(self, directory_addr: Tuple[str, int],
                       timeout: float = 10) -> None:
        host, port = self.address
        msg = Message(src=self.rank, type=MsgType.Control_Register,
                      msg_id=0,
                      data=[np.asarray([self.rank, port], dtype=np.int64),
                            np.frombuffer(host.encode(), dtype=np.uint8)])
        with socket.create_connection(directory_addr, timeout=timeout) as s:
            send_message(s, msg)
            if recv_message(s) is None:     # clean EOF = NOT acked
                raise OSError("registration connection closed before ack")

    def lookup(self, rank: int) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self._directory.get(rank)

    def _dispatch_control(self, msg: Message) -> Optional[Message]:
        if msg.type == MsgType.Heartbeat:
            reply = msg.create_reply()
            with self._lock:
                reply.data = [np.asarray(sorted(self._tables),
                                         dtype=np.int64)]
            return reply
        if msg.type == MsgType.Control_Register:
            rank, port = (int(x) for x in msg.data[0])
            host = msg.data[1].tobytes().decode()
            with self._lock:
                self._directory[rank] = (host, port)
            log.info("directory: rank %d re-registered at %s:%d",
                     rank, host, port)
            return msg.create_reply()
        if msg.type == MsgType.Server_Finish_Train:
            # The named worker is done: its clocks go to infinity so
            # laggards can't wait on it (src/server.cpp:190-213; trigger
            # Zoo::FinishTrain, src/zoo.cpp:152-161). Scoped to the
            # message's table when one is named — finishing one table must
            # not retire the worker from other tables' clocks (ADVICE r3);
            # table_id < 0 (mv.finish_train, process-global) retires all.
            w = (int(msg.data[0][0]) if msg.data and msg.data[0].size
                 else max(msg.src, 0))
            self._retire_worker_staleness(w)
            with self._lock:
                if msg.table_id >= 0:
                    # Named table: finish its gate only. Absent gate (async
                    # table, or gate not yet registered) is a no-op — it
                    # must NOT fall back to retiring the worker everywhere.
                    gate = self._sync.get(msg.table_id)
                    gates = [gate] if gate is not None else []
                else:
                    # table_id < 0: retire everywhere. Defensive only —
                    # every current client (DistributedTableBase
                    # .finish_train, which mv.finish_train fans out
                    # through per table) stamps a concrete table_id.
                    gates = list(self._sync.values())
            for gate in gates:
                gate.finish(w)
            return msg.create_reply()
        if msg.type == MsgType.Control_Elastic:
            return self._serve_elastic(msg)
        if msg.type == MsgType.Control_Lookup:
            rank = int(msg.data[0][0])
            addr = self.lookup(rank)
            reply = msg.create_reply()
            if addr is None:
                reply.data = [np.asarray([-1], dtype=np.int64),
                              np.empty(0, dtype=np.uint8)]
            else:
                reply.data = [np.asarray([addr[1]], dtype=np.int64),
                              np.frombuffer(addr[0].encode(),
                                            dtype=np.uint8)]
            return reply
        return self._dispatch(msg)

    def _serve_elastic(self, msg: Message) -> Message:
        """Elastic membership announce (MXNET-MPI, PAPERS.md 1801.03855):
        a worker process joins/leaves this table's server-side BSP clock
        group at runtime. Runs on the dispatcher thread — the only thread
        that touches gates — so membership flips atomically between ops;
        the caller drains unlocked cached ops right after (a leave retires
        clocks to infinity, which may release every gated laggard)."""
        from multiverso_tpu_torch.parallel.net import (pack_json_blob,
                                                       unpack_json_blob)
        reply = msg.create_reply()
        try:
            req = unpack_json_blob(msg.data[0]) if msg.data else {}
        except IOError:
            req = {}
        gate = self._sync.get(msg.table_id)
        op = req.get("op")
        if gate is None:
            # Async table: no clock group to re-form. Loud, not silent —
            # a join that "succeeds" against the wrong mode would strand
            # the worker waiting on gates that don't exist.
            out: Dict[str, object] = {
                "error": f"table {msg.table_id} has no sync gate"}
        elif op == "join":
            worker = req.get("worker")
            out = {"worker": gate.join(None if worker is None
                                       else int(worker))}
            out.update(gate.status())
        elif op == "leave" and req.get("worker") is not None:
            gate.leave(int(req["worker"]))
            out = dict(gate.status())
        elif op == "status":
            out = dict(gate.status())
        else:
            out = {"error": f"bad elastic request {req!r}"}
        reply.data = [pack_json_blob(out)]
        return reply

    def close(self) -> None:
        self._running = False
        self._reg_stop.set()                # interrupt registration retries
        try:
            self._queue.put_nowait(None)    # wake + stop the dispatcher
        except Exception:  # noqa: BLE001 - full queue: dispatcher is live
            pass
        self._wake_io()
        try:
            self._listener.close()
        except OSError:
            pass
        for sock in list(self._decoders):
            self._drop_conn(sock)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        if self._wal is not None:
            # Orderly shutdown seals the log (flush + fsync) — an abrupt
            # kill skips this, which is exactly what recovery handles.
            self._wal.close()
        # Wait (bounded) for the service's threads to end: a daemon thread
        # still running when the interpreter finalizes is ended there by
        # pthread_exit, which can abort the process ("terminate called
        # without an active exception") and turn a seat's orderly exit
        # into SIGABRT.
        me = threading.current_thread()
        for t in (self._io_thread, self._dispatch_thread,
                  *self._reg_threads):
            if t is not me:
                t.join(timeout=10.0)


def _reply_nbytes(reply: Message) -> int:
    return sum(int(np.asarray(b).nbytes) for b in reply.data)


def _opt_to_array(opt: AddOption) -> np.ndarray:
    return np.asarray([opt.worker_id, opt.momentum, opt.learning_rate,
                       opt.rho, opt.lambda_, opt.staleness],
                      dtype=np.float32)


def _opt_from_array(arr: np.ndarray) -> AddOption:
    # Older peers ship 5 scalars (no staleness); absent = unmeasured (-1),
    # which keeps the fixed-lambda DC-ASGD math bitwise.
    return AddOption(worker_id=int(arr[0]), momentum=float(arr[1]),
                     learning_rate=float(arr[2]), rho=float(arr[3]),
                     lambda_=float(arr[4]),
                     staleness=float(arr[5]) if arr.size > 5 else -1.0)


# -- wire payload codec (VERDICT r1 #5) -------------------------------------
# Every float payload (add deltas worker->server, get values server->worker)
# passes through a filter with a side-channel marker blob, the reference's
# FilterIn/FilterOut shape (``sparse_matrix_table.cpp:148-153,261-309``;
# marker analog: the size blob with -1 = raw, ``quantization_util.h:34-57``).
# Marker layout: int64 [mode, ndim, *dims]. Modes:
#   0 raw     — payload as-is
#   1 sparse  — (int32 indices, float32 values); chosen only when >50% of
#               entries are within the clip threshold (the reference's rule)
#   2 onebit  — packed sign bits + two scales, with sender-held error
#               feedback; opt-in (dense array add path only: quantizing
#               absolute values or sparse row deltas would be lossy garbage)
#   3 bf16    — round-to-nearest-even bfloat16 truncation (uint16 wire
#               halves), halving bytes on BOTH legs at bf16 delta/param
#               precision; the middle ground between raw and
#               onebit (no sender state, works for row deltas and gets)
_WIRE_RAW, _WIRE_SPARSE, _WIRE_ONEBIT, _WIRE_BF16 = 0, 1, 2, 3


def _wire_mode() -> str:
    from multiverso_tpu_torch.utils.configure import get_flag
    return get_flag("wire_compression")


def _wire_clip() -> float:
    from multiverso_tpu_torch.utils.configure import get_flag
    return float(get_flag("wire_compression_clip"))


def _marker(mode: int, shape: Tuple[int, ...]) -> np.ndarray:
    return np.asarray([mode, len(shape), *shape], dtype=np.int64)


def _reply_mode(mode: str) -> str:
    """Reply legs carry ABSOLUTE parameter values: onebit would be lossy
    garbage there, so it degrades to lossless sparsify; bf16 stays bf16 —
    opting into it means bf16 read precision on pulls too (that is where
    half the wire bytes are)."""
    if mode == "bf16":
        return "bf16"
    return "sparse" if mode != "none" else "none"


def pack_payload(arr: np.ndarray, mode: str,
                 onebit: "Optional[OneBitsFilter]" = None,
                 clip: Optional[float] = None) -> List[np.ndarray]:
    """Array -> [marker, *blobs]; picks the cheapest admissible encoding.
    ``clip`` overrides the flag — reply legs carry ABSOLUTE parameter
    values and must pass clip=0.0 (lossless sparsify of exact zeros only);
    the user clip threshold is a delta-compression knob."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if mode == "onebit" and onebit is not None:
        bits, pos_scale, neg_scale = onebit.encode(arr)
        return [_marker(_WIRE_ONEBIT, arr.shape), bits,
                np.asarray([pos_scale, neg_scale], dtype=np.float32)]
    if mode in ("sparse", "onebit") and arr.size < (1 << 31):
        compressed, payload, idx = SparseFilter(
            _wire_clip() if clip is None else clip).filter_in(arr)
        if compressed:
            return [_marker(_WIRE_SPARSE, arr.shape), idx, payload]
    if mode == "bf16":
        from multiverso_tpu_torch.utils.quantization import f32_to_bf16_bits
        return [_marker(_WIRE_BF16, arr.shape), f32_to_bf16_bits(arr)]
    return [_marker(_WIRE_RAW, arr.shape), arr]


def unpack_payload(blobs: List[np.ndarray]) -> np.ndarray:
    marker = blobs[0]
    mode, ndim = int(marker[0]), int(marker[1])
    shape = tuple(int(d) for d in marker[2:2 + ndim])
    size = int(np.prod(shape)) if ndim else 1
    if mode == _WIRE_RAW:
        return blobs[1].reshape(shape)
    if mode == _WIRE_SPARSE:
        out = np.zeros(size, dtype=np.float32)
        out[blobs[1]] = blobs[2]
        return out.reshape(shape)
    if mode == _WIRE_ONEBIT:
        return OneBitsFilter.decode(blobs[1], float(blobs[2][0]),
                                    float(blobs[2][1]), size).reshape(shape)
    if mode == _WIRE_BF16:
        from multiverso_tpu_torch.utils.quantization import bf16_bits_to_f32
        return bf16_bits_to_f32(blobs[1]).reshape(shape)
    raise IOError(f"unknown wire payload mode {mode}")


class PeerClient:
    """Persistent connection to one server process; reply routing by msg_id
    (the Worker-side Communicator + Waiter contract)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port), timeout=60)
        # The connect timeout must not become a recv timeout: this is a
        # persistent connection that legitimately sits idle.
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = make_lock("ps.peer.send")
        self._waiters: Dict[int, Tuple[threading.Event, List]] = {}
        self._waiters_lock = make_lock("ps.peer.waiters")
        self._dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def request(self, msg: Message) -> Tuple[threading.Event, List]:
        # A dead reader can never deliver a reply: fail immediately instead
        # of letting the caller ride out its waiter timeout.
        if self._dead:
            raise OSError("connection to peer is closed")
        event = threading.Event()
        slot: List = []
        with self._waiters_lock:
            self._waiters[msg.msg_id] = (event, slot)
        with self._send_lock:
            # _send_lock exists to serialize frame writes on the one
            # shared peer socket — the wire wait IS the serialized step.
            # graftlint: disable=lock-held-across-blocking
            send_message(self._sock, msg)
        return event, slot

    def _read_loop(self) -> None:
        try:
            # Blocks in recv_message() on a deliberately-idle persistent
            # connection; liveness is the peer's to prove (ping()), and
            # socket close breaks the recv on shutdown.
            # graftlint: disable=daemon-loop-no-watchdog
            while True:
                msg = recv_message(self._sock)
                if msg is None:
                    break
                with self._waiters_lock:
                    entry = self._waiters.pop(msg.msg_id, None)
                if entry is not None:
                    event, slot = entry
                    slot.append(msg)
                    event.set()
        except OSError:
            pass
        # Peer went away: mark dead (future requests fail immediately) and
        # release every pending waiter with an empty slot so callers fail
        # fast instead of timing out.
        self._dead = True
        with self._waiters_lock:
            pending = list(self._waiters.values())
            self._waiters.clear()
        for event, _ in pending:
            event.set()

    def ping(self, timeout: float = 10.0) -> Optional[List[int]]:
        """Failure detection: round-trip a heartbeat; returns the peer's
        registered table ids, or None if the peer is unresponsive. (The
        reference had no heartbeats — SURVEY.md §5 'Failure detection:
        minimal' — this closes that gap for the DCN service.)"""
        msg = Message(type=MsgType.Heartbeat,
                      msg_id=DistributedTableBase._next_msg_id())
        try:
            event, slot = self.request(msg)
        except OSError:
            return None
        if not event.wait(timeout) or not slot or not slot[0].data:
            return None
        return slot[0].data[0].tolist()

    def close(self) -> None:
        """Close the connection and wait (bounded) for the reader, which
        ``shutdown`` wakes from its blocked recv (see ``PSService.close``
        for why no daemon thread should outlive its owner)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if threading.current_thread() is not self._reader:
            self._reader.join(timeout=10.0)


class _PendingOp:
    """Future over a fan-out of wire requests: completes when every touched
    server replied (the reference's Waiter contract, ``src/table.cpp:41-82``
    — GetAsync/AddAsync return an id immediately; Wait(id) blocks).

    Parts carry ``(server, msg, (event, slot))`` so a lost connection can be
    retried through the membership directory: the retrier rediscovers the
    server's current address and re-sends the SAME message. At-least-once on
    retry (a server that applied an Add but died before replying applies it
    again) — the recovery trade the reference never reaches (its one-shot
    registration simply strands the rank, ``src/controller.cpp:38-72``)."""

    def __init__(self, parts: List[Tuple[int, Message,
                                         Tuple[threading.Event, List]]],
                 assemble: Optional[Callable[[List[Message]], object]] = None,
                 retrier: Optional[Callable[[int, Message],
                                            Tuple[threading.Event, List]]]
                 = None):
        self._parts = parts
        self._assemble = assemble
        self._retrier = retrier
        self._done = False
        self._result: object = None

    def wait(self, timeout: Optional[float] = 60.0):
        """``timeout=None`` waits indefinitely — BSP mode's contract (the
        reference Waiter blocks forever): a clock-gated op legitimately
        sits cached server-side until lagging workers catch up, and worker
        skew (first-call kernel builds, data stalls) must not become a
        FatalError.
        Liveness still holds: a lost connection wakes the waiter with an
        empty slot (PeerClient._read_loop) and retries through the
        directory."""
        if self._done:
            return self._result
        replies: List[Message] = []
        for server, msg, (event, slot) in self._parts:
            ok = event.wait(timeout)
            while ok and not slot:
                # Event set with an empty slot is the reader thread's
                # connection-lost release — the ONLY state that may retry
                # (resending is dedup-guarded server-side). A plain timeout
                # on a live connection still fails loudly: the request may
                # be queued server-side behind a slow dispatch.
                check(self._retrier is not None,
                      "peer connection lost during table op")
                event, slot = self._retrier(server, msg)
                ok = event.wait(timeout)
            check(ok, "remote table op timed out")
            check(slot, "peer connection lost during table op")
            check(slot[0].type != MsgType.Reply_Error,
                  f"server rejected table op on table {msg.table_id} "
                  "(unknown table — no registration within the server's "
                  "deadline — or the server's device failed)")
            replies.append(slot[0])
        self._result = (self._assemble(replies)
                        if self._assemble is not None else None)
        self._done = True
        self._parts = []    # release retained wire messages/payloads
        return self._result


def _shard_device(zoo):
    """The device a shard's store lives on: the Zoo's (the card unless
    ``-platform=cpu``)."""
    check(zoo.started and zoo.device is not None,
          "call mv.init() before creating a distributed table")
    return zoo.device


class DistributedTableBase:
    """Shared plumbing: shard ownership, local forward, remote fan-out,
    and the REAL async surface — ``get_async`` fires the wire requests and
    returns before the replies arrive; ``add_async`` stages deltas in the
    native DeltaBuffer (linear updaters) so N pushes merge into ONE wire
    message per server, or fires without waiting (stateful updaters), under
    a bounded in-flight window. Read-your-writes holds because each
    (client, server) pair is one FIFO TCP stream served in order: a Get
    issued after an Add on the same connection is dispatched after it."""

    # Starts at a random 48-bit value so a RESTARTED process (elastic
    # recovery) can never reuse a (src, msg_id) pair still sitting in a
    # server's exactly-once reply cache — a collision there would silently
    # swallow the new incarnation's Adds.
    _msg_counter = int.from_bytes(os.urandom(6), "little")
    _counter_lock = make_lock("ps.client.msgid")

    MAX_PENDING = 256        # tracked-but-unwaited op ids (oldest evicted)
    MAX_INFLIGHT_ADDS = 32   # unwaited fire-and-forget add batches

    RETRY_WINDOW = 15.0      # rediscovery window for a restarting peer

    def __init__(self, table_id: int, service: PSService,
                 peers: List[Tuple[str, int]], rank: int,
                 announce: bool = True):
        self.table_id = table_id
        self.rank = rank
        self.world = len(peers)
        self._service = service
        # BSP across processes (-sync=true, ref src/server.cpp:224-231):
        # every op — including this rank's own — serializes through the
        # clock-gated dispatch of the owning shard's service, so the
        # LocalForward shortcut is disabled and delta staging (which merges
        # N adds into one message, changing the clock count) is off.
        zoo = Zoo.get()
        self._bsp = bool(zoo.sync_mode) and self.world > 1
        # BSP ops wait without deadline (reference Waiter semantics): a
        # clock-gated op is HELD server-side until laggards catch up, and
        # straggler skew >60s is routine (kernel builds, data stalls).
        # Async-mode ops keep the fail-loud deadline.
        self._op_timeout: Optional[float] = None if self._bsp else 60.0
        self._n_local = max(1, zoo.num_local_workers)
        # Elastic slots: local worker index -> server-ALLOCATED global id
        # (``elastic_join``). Empty for the fixed roster a process was
        # launched with — _gid's arithmetic mapping stays authoritative.
        self._gid_override: Dict[int, int] = {}
        self._clients: Dict[int, PeerClient] = {}
        self._peers = peers
        # Join the REPLICATED membership directory (the Controller analog,
        # replicated on every service): a restarted rank re-registers its
        # new address with every live peer and traffic rediscovers it on
        # the next failed request — no manual reconnect(), any seat may
        # die, rank 0 included. ``announce=False`` defers the
        # registration: a RESTARTING seat must restore its shard
        # checkpoint FIRST and only then announce (call
        # ``service.enable_directory(rank, peers)``) — announcing early
        # lets a peer's retried add land on the fresh shard and be
        # OVERWRITTEN by the restore, silently losing an acked write.
        if announce:
            service.enable_directory(rank, peers)
        self._op_lock = make_rlock("ps.client.op")
        self._pending: "collections.OrderedDict[int, _PendingOp]" = \
            collections.OrderedDict()
        self._inflight_adds: "collections.deque[_PendingOp]" = \
            collections.deque()
        # msg ids handed out for staged (not yet sent) adds; resolved to the
        # flush batch's _PendingOp when the buffer drains.
        self._staged_ids: List[int] = []
        self._stage_buf: Optional[DeltaBuffer] = None
        self._stage_opt: Optional[AddOption] = None
        self._onebit_filters: Dict[int, OneBitsFilter] = {}
        # Telemetry: staged-delta depth (flush queue) + unwaited add
        # batches in flight — the DCN-path async engine gauges, qualified
        # per table so concurrent tables' streams don't conflate
        # (docs/OBSERVABILITY.md).
        self._g_stage_depth = gauge(
            f"async_engine.queue_depth.table_{table_id}")
        self._g_inflight_adds = gauge(
            f"async_engine.inflight_adds.table_{table_id}")

    def _gid(self, worker_id: int) -> int:
        """Global BSP worker id: contiguous per process (rank * local + k;
        accepts either a local index or this process's global id). A slot
        allocated at runtime by ``elastic_join`` overrides the arithmetic
        mapping for its local index."""
        if self._gid_override:
            g = self._gid_override.get(worker_id % self._n_local)
            if g is not None:
                return g
        return self.rank * self._n_local + (worker_id % self._n_local)

    def _sync_workers(self) -> int:
        """Gate size for register_shard: every (process, local worker)."""
        return self.world * self._n_local if self._bsp else 0

    def _init_staging(self, rows: int, cols: int, stageable: bool) -> None:
        if stageable and not self._bsp:
            self._stage_buf = DeltaBuffer(rows, cols)

    def _client(self, server: int) -> PeerClient:
        client = self._clients.get(server)
        if client is None:
            host, port = self._peers[server]
            client = self._clients[server] = PeerClient(host, port)
        return client

    # -- elastic rediscovery -----------------------------------------------
    def _lookup_peer(self, server: int,
                     avoid: Optional[Tuple[str, int]] = None
                     ) -> Optional[Tuple[str, int]]:
        """Current address of ``server``. The directory is REPLICATED:
        this process's own replica answers first (a restarting peer
        registers its new address with every live rank directly), then
        remote replicas are consulted in rank order — so rediscovery
        survives any seat going down, rank 0 included. ``avoid`` is the
        address the caller just failed against: a replica still holding
        it is stale, so the search continues past it (falling back to it
        only when no replica knows better — the retry loop re-polls)."""
        svc = self._service

        def candidates():
            local = svc.lookup(server)
            if local is not None:
                yield tuple(local)
            for r in range(self.world):
                if r in (self.rank, server):
                    continue
                try:
                    msg = Message(src=self.rank,
                                  type=MsgType.Control_Lookup,
                                  msg_id=self._next_msg_id(),
                                  data=[np.asarray([server],
                                                   dtype=np.int64)])
                    # Short timeout: this runs inside the 0.3s retry
                    # poll loop and a partitioned (SYN-dropping) replica
                    # must not eat the whole RETRY_WINDOW per sweep.
                    with socket.create_connection(tuple(self._peers[r]),
                                                  timeout=1.5) as s:
                        send_message(s, msg)
                        reply = recv_message(s)
                    if reply is None:
                        continue
                    port = int(reply.data[0][0])
                    if port < 0:
                        continue
                    yield (reply.data[1].tobytes().decode(), port)
                except OSError:
                    continue

        fallback = None
        for cand in candidates():   # lazy: a fresh local answer returns
            if avoid is None or cand != tuple(avoid):   # without any
                return cand                             # remote queries
            if fallback is None:
                fallback = cand
        return fallback

    def _retry_request(self, server: int, msg: Message
                       ) -> Tuple[threading.Event, List]:
        """Drop the dead connection, rediscover the peer's address, resend.
        Polls the directory for up to RETRY_WINDOW so a peer mid-restart is
        picked up as soon as it re-registers. The poll cadence is the
        standard JITTERED backoff schedule (was a fixed 0.3s): when a
        supervisor kills a shard, every client of it lands here in the
        same instant — identical sleeps would hammer the replacement in
        synchronized waves the moment it announces."""
        from multiverso_tpu_torch.serving.client import backoff_delays
        deadline = time.monotonic() + self.RETRY_WINDOW
        delays = iter(backoff_delays(64, base_delay_s=0.1, cap_s=0.5))
        while True:
            old = self._clients.pop(server, None)
            if old is not None:
                old.close()
            # ``avoid`` is the address that JUST failed — recomputed
            # every sweep, not pinned to the first failure. Pinning let
            # one replica's stale entry (a sibling's bring-up
            # placeholder) outrank everyone's correct answer on every
            # sweep: after a single transient send fault against a
            # HEALTHY peer, the loop parked on the stale (refused) port
            # for the whole window. Chaos drill's net_drop fault found
            # this; with the per-sweep avoid, the next sweep's lookup
            # returns the good address and the request goes through.
            dead_addr = tuple(self._peers[server])
            addr = self._lookup_peer(server, avoid=dead_addr)
            if addr is not None:
                self._peers[server] = addr
            try:
                return self._client(server).request(msg)
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(next(delays, 0.5))

    def _request_or_retry(self, server: int, msg: Message
                          ) -> Tuple[threading.Event, List]:
        try:
            return self._client(server).request(msg)
        except OSError:
            return self._retry_request(server, msg)

    # -- op tracking -------------------------------------------------------
    def _insert_pending(self, msg_id: int, op: _PendingOp) -> None:
        """All tracked-op inserts go through here so the MAX_PENDING
        eviction bound holds on every path (fire-and-forget callers never
        wait, so unevicted entries would pin their delta payloads forever)."""
        self._pending[msg_id] = op
        # Evicted adds still complete via _inflight_adds; eviction only
        # forgets the caller-visible id (same contract as WorkerTable).
        while len(self._pending) > self.MAX_PENDING:
            self._pending.popitem(last=False)

    def _track(self, op: _PendingOp) -> int:
        msg_id = self._next_msg_id()
        with self._op_lock:
            self._insert_pending(msg_id, op)
        return msg_id

    def _track_add(self, op: _PendingOp) -> None:
        """Bound the unwaited-add window: block on the oldest batch once
        MAX_INFLIGHT_ADDS are outstanding (the reference bounds this with
        its one-message-in-flight MPI send queue, ``mpi_net.h:195-216``)."""
        with self._op_lock:
            self._inflight_adds.append(op)
            overflow = (self._inflight_adds.popleft()
                        if len(self._inflight_adds) > self.MAX_INFLIGHT_ADDS
                        else None)
            self._g_inflight_adds.set(len(self._inflight_adds))
        if overflow is not None:
            overflow.wait(self._op_timeout)

    def wait(self, msg_id: int, timeout: Optional[float] = None):
        """Complete an async op. Staged adds flush first (their id resolves
        to the flush batch). ``timeout=None`` uses the table's mode default
        (indefinite in BSP, 60s fail-loud in async)."""
        with self._op_lock:
            if msg_id in self._staged_ids:
                self.flush()
            op = self._pending.pop(msg_id, None)
        check(op is not None, f"unknown or already-waited msg_id {msg_id}")
        return op.wait(self._op_timeout if timeout is None else timeout)

    def flush(self, wait: bool = False) -> None:
        """Drain the staging buffer onto the wire; optionally also wait out
        every in-flight add batch."""
        with self._op_lock:
            if self._stage_buf is not None and self._stage_buf.pending:
                # Distinct from the local engine's ASYNC_FLUSH: ~us device
                # dispatches and ~ms DCN round-trips must not share one
                # histogram (a wire regression would drown in the mix).
                with monitor("DCN_FLUSH"):     # drain + wire fire latency
                    op = self._flush_staged_locked()
                self._g_stage_depth.set(self._stage_buf.pending)
                for sid in self._staged_ids:
                    if sid in self._pending:    # not yet evicted
                        self._insert_pending(sid, op)
                self._staged_ids.clear()
                self._track_add(op)
            drain = list(self._inflight_adds) if wait else []
            if wait:
                self._inflight_adds.clear()
        for op in drain:
            op.wait(self._op_timeout)

    def _flush_staged_locked(self) -> _PendingOp:
        raise NotImplementedError

    @classmethod
    def _next_msg_id(cls) -> int:
        # Explicitly on the BASE class: `cls._msg_counter += 1` from a
        # subclass would shadow the counter per subclass, and two tables
        # of different types would then emit overlapping msg_id streams —
        # colliding in the server's (src, msg_id) exactly-once cache.
        base = DistributedTableBase
        with base._counter_lock:
            base._msg_counter += 1
            return base._msg_counter

    def _bsp_tick_parts(self, msg_type: int, routed,
                        option: Optional[AddOption] = None,
                        get_option: "Optional[GetOption]" = None,
                        key_dtype=np.int32) -> List:
        """BSP invariant: EVERY op ticks EVERY server's clock. Returns one
        tick part (empty Add / sentinel Get) per server absent from
        ``routed``; empty outside sync mode. ``option`` must already carry
        the GLOBAL worker id. Centralized so a routed-table override can't
        forget the fan-out and wedge the gates (ADVICE r3 medium #2)."""
        parts: List = []
        if not self._bsp:
            return parts
        for s in range(self.world):
            if s in routed:
                continue
            if msg_type == MsgType.Request_Add:
                data = [np.empty(0, key_dtype),
                        _opt_to_array(option or AddOption())]
            else:
                data = [np.asarray([TICK_GET_KEY], key_dtype),
                        *self._get_opt_blob(get_option)]
            msg = Message(src=self.rank, type=msg_type,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(), data=data)
            parts.append((s, msg, self._request_or_retry(s, msg)))
        return parts

    def _get_opt_blob(self, option: "Optional[GetOption]"
                      ) -> List[np.ndarray]:
        """BSP Gets carry the worker's clock identity as an extra blob (the
        reference's GetOption, ``sparse_matrix_table.cpp:36-43``); async
        mode sends the bare keys."""
        if not self._bsp:
            return []
        wid = option.worker_id if option is not None else 0
        return [np.asarray([self._gid(wid)], dtype=np.int32)]

    def finish_train(self, worker_id: Optional[int] = None) -> None:
        """Release this worker from every server's BSP clocks
        (``Zoo::FinishTrain`` -> ``Server_Finish_Train``, ref
        src/zoo.cpp:152-161, src/server.cpp:190-213). No-op in async
        mode. ``worker_id`` is a local index (or this process's global
        id); each local worker retires separately."""
        if not self._bsp:
            return
        gid = self._gid(worker_id if worker_id is not None else 0)
        parts = []
        for s in range(self.world):
            msg = Message(src=self.rank, type=MsgType.Server_Finish_Train,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[np.asarray([gid], dtype=np.int32)])
            try:
                parts.append((s, msg, self._request_or_retry(s, msg)))
            except OSError:
                continue    # dead server can't be holding anyone's gate
        _PendingOp(parts, retrier=self._retry_request).wait(
            self._op_timeout)

    # -- elastic membership ------------------------------------------------
    def elastic_join(self, worker_id: int = 0,
                     timeout: Optional[float] = None) -> int:
        """Announce a NEW sync worker to every server's clock group
        (MXNET-MPI elastic membership, PAPERS.md 1801.03855); returns the
        allocated global worker id and binds it to local index
        ``worker_id`` so this table's subsequent ops stamp it. Server 0 is
        the membership LEADER: it allocates the slot, the remaining
        servers adopt that id verbatim — two workers joining concurrently
        can therefore never be assigned the same slot. The join lands at
        the current epoch floor (no gate predicate regresses), and
        because announce + ops share one FIFO connection per server, no
        op stamped with the new slot can outrun the join that creates it.
        No-op (returns the arithmetic gid) in async mode."""
        if not self._bsp:
            return self._gid(worker_id)
        wid: Optional[int] = None
        for s in range(self.world):
            payload: Dict[str, object] = {"op": "join"}
            if wid is not None:
                payload["worker"] = wid
            out = self._elastic_rpc(s, payload, timeout)
            check("error" not in out, f"elastic join rejected by server "
                  f"{s}: {out}")
            wid = int(out["worker"])
        self._gid_override[worker_id % self._n_local] = wid
        return wid

    def elastic_leave(self, worker_id: int = 0,
                      timeout: Optional[float] = None) -> None:
        """Graceful leave: retire this worker from every server's clocks
        (peers' gates stop waiting on it immediately) and free its slot
        for a later :meth:`elastic_join` to reuse. Callers drain their own
        in-flight ops first (:meth:`flush`); anything still gated
        server-side is dropped with the slot. No-op in async mode."""
        if not self._bsp:
            return
        gid = self._gid(worker_id)
        for s in range(self.world):
            try:
                self._elastic_rpc(s, {"op": "leave", "worker": gid},
                                  timeout)
            except OSError:
                continue    # dead server can't be holding anyone's gate
        self._gid_override.pop(worker_id % self._n_local, None)

    def _elastic_rpc(self, server: int, payload: Dict[str, object],
                     timeout: Optional[float] = None) -> Dict[str, object]:
        from multiverso_tpu_torch.parallel.net import (pack_json_blob,
                                                       unpack_json_blob)
        msg = Message(src=self.rank, type=MsgType.Control_Elastic,
                      table_id=self.table_id, msg_id=self._next_msg_id(),
                      data=[pack_json_blob(payload)])
        op = _PendingOp(
            [(server, msg, self._request_or_retry(server, msg))],
            assemble=lambda replies: unpack_json_blob(replies[0].data[0]),
            retrier=self._retry_request)
        return op.wait(self._op_timeout if timeout is None else timeout)

    # -- checkpointing -----------------------------------------------------
    @property
    def checkpoint_suffix(self) -> str:
        """Each rank checkpoints only its own shard; ``save_all`` qualifies
        the filename with this so shards don't collide on a shared
        filesystem (ref ``table_interface.h:61-75``: Store/Load are
        per-server-table there too)."""
        return f"-shard{self.rank}of{self.world}"

    def _shard_offset(self) -> int:
        raise NotImplementedError

    def store_state(self) -> Dict[str, np.ndarray]:
        """Serialize this rank's shard (params + updater state) plus shard
        placement metadata, via the local ServerStore. With a WAL attached
        the snapshot is captured ON the dispatcher (atomic with applies)
        and tagged with the WAL lsn it corresponds to — recovery loads the
        checkpoint and replays only records past that lsn."""
        self.flush(wait=True)     # staged/in-flight adds land first
        if self._service.wal_active:
            payload, lsn = self._service.snapshot_table(self.table_id)
            payload = dict(payload)
            payload["wal_meta"] = np.asarray([lsn], dtype=np.int64)
        else:
            payload = self.local_store.store_state()
        payload["shard_meta"] = np.asarray(
            [self.table_id, self.rank, self.world, self._shard_offset()],
            dtype=np.int64)
        return payload

    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        payload = dict(payload)
        wal_meta = payload.pop("wal_meta", None)
        if wal_meta is not None:
            # Tell the service which deltas this restore already holds;
            # harmless when no WAL is attached on the restoring side.
            self._service.note_wal_restore(
                self.table_id, int(np.asarray(wal_meta)[0]))
        meta = payload.pop("shard_meta", None)
        if meta is not None:
            _, rank, world, offset = (int(x) for x in np.asarray(meta))
            check(world == self.world and offset == self._shard_offset(),
                  f"checkpoint shard (rank {rank}/{world}, offset {offset}) "
                  f"does not match table shard (rank {self.rank}/"
                  f"{self.world}, offset {self._shard_offset()}) — "
                  "restore requires the same world size")
        self.local_store.load_state(payload)

    def reconnect(self, server: int,
                  address: Optional[Tuple[str, int]] = None) -> None:
        """Elastic re-admission: point this table at a restarted peer
        (optionally at a new address) and drop the dead connection. The
        restarted rank re-registers its shard (restored from checkpoint)
        and traffic resumes — the recovery story the reference leaves to
        'checkpoint/resume' alone (SURVEY.md §5)."""
        if address is not None:
            self._peers[server] = address
        old = self._clients.pop(server, None)
        if old is not None:
            old.close()

    def close(self) -> None:
        try:
            self.flush(wait=True)
        except Exception:  # noqa: BLE001 - peers may already be gone
            pass
        for client in self._clients.values():
            client.close()


class DistributedArrayTable(DistributedTableBase):
    """1-D table contiguously sharded across PROCESSES (the reference's
    server set), each process's shard device-resident via ServerStore."""

    def __init__(self, table_id: int, size: int,
                 service: PSService, peers: List[Tuple[str, int]],
                 rank: int, dtype=np.float32, updater: str = "default",
                 announce: bool = True, use_pallas: bool = False):
        super().__init__(table_id, service, peers, rank, announce=announce)
        self.name = f"dist_array_{table_id}"
        self.size = size
        self.offsets = reference_server_offsets(size, self.world)
        zoo = Zoo.get()
        local_size = self.offsets[rank + 1] - self.offsets[rank]
        # Per-worker updater state (AdaGrad G^2, ref adagrad_updater.h:17-20)
        # must span the DCN worker universe — every (process, local worker)
        # — not zoo.num_workers(), which is local-only when the ranks run
        # separate runtimes (one process a rank).
        self.local_store = ServerStore(
            f"dist_array_{table_id}", (max(local_size, 1),), dtype,
            get_updater(dtype, updater), _shard_device(zoo),
            self.world * self._n_local, use_pallas_rows=use_pallas)
        service.register_shard(table_id, self.local_store,
                               sync_workers=self._sync_workers())
        from multiverso_tpu_torch.parallel.async_engine import _stageable
        self._init_staging(size, 1, _stageable(self.local_store.updater))

    # -- internals ---------------------------------------------------------
    def _send_add(self, delta: np.ndarray, option: AddOption) -> _PendingOp:
        """Partition + LocalForward + fire one wire message per remote
        server. Returns the reply future WITHOUT waiting."""
        # Globalize the worker id unconditionally: it indexes per-worker
        # updater state (AdaGrad) on the serving shard and, in sync mode,
        # the BSP clocks — a rank-local id would alias across ranks.
        option = dataclasses.replace(
            option, worker_id=self._gid(option.worker_id))
        mode = _wire_mode()
        parts = []
        for s in range(self.world):
            lo, hi = self.offsets[s], self.offsets[s + 1]
            if hi <= lo:
                continue
            piece = delta[lo:hi]
            if s == self.rank and not self._bsp:
                self.local_store.apply_dense(piece, option)  # LocalForward
                continue
            onebit = None
            if mode == "onebit":
                # Per-link error feedback state, sized to the peer's shard
                # (1-bit SGD semantics; stateful, so per (table, server)).
                onebit = self._onebit_filters.setdefault(
                    s, OneBitsFilter(hi - lo))
            msg = Message(src=self.rank, type=MsgType.Request_Add,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[np.empty(0, np.int32),
                                _opt_to_array(option),
                                *pack_payload(piece, mode, onebit)])
            parts.append((s, msg, self._request_or_retry(s, msg)))
        return _PendingOp(parts, retrier=self._retry_request)

    def _shard_offset(self) -> int:
        return int(self.offsets[self.rank])

    def _flush_staged_locked(self) -> _PendingOp:
        merged, n = self._stage_buf.drain_dense()
        opt, self._stage_opt = self._stage_opt or AddOption(), None
        return self._send_add(merged.reshape(self.size), opt)

    # -- ops ---------------------------------------------------------------
    def add(self, delta: np.ndarray,
            option: Optional[AddOption] = None) -> None:
        delta = _host_f32(delta)
        check(delta.shape == (self.size,), "bad delta shape")
        with self._op_lock:
            self.flush()
            op = self._send_add(delta, option or AddOption())
        op.wait(self._op_timeout)
        self.local_store.block()

    def add_async(self, delta, option: Optional[AddOption] = None) -> int:
        """Fire-and-forget under a bounded window. Linear updaters stage in
        the native DeltaBuffer — N calls become ONE wire message per server
        at the next flush/get (ref ``src/table.cpp:62-82`` returns an id
        immediately; the merge is the device-side improvement on it)."""
        delta = _host_f32(delta)
        check(delta.shape == (self.size,), "bad delta shape")
        option = option or AddOption()
        with self._op_lock:
            if self._stage_buf is not None:
                if self._stage_opt is not None and option != self._stage_opt:
                    self.flush()   # option change: can't merge across it
                self._stage_opt = option
                self._stage_buf.add_dense(delta)
                self._g_stage_depth.set(self._stage_buf.pending)
                msg_id = self._next_msg_id()
                self._staged_ids.append(msg_id)
                self._insert_pending(msg_id, _PendingOp([]))  # -> flush op
                return msg_id
            op = self._send_add(delta, option)
            self._track_add(op)
            msg_id = self._track(op)
        return msg_id

    def _get_op(self, option: "Optional[GetOption]" = None) -> _PendingOp:
        self.flush()   # staged adds precede the get on each FIFO stream
        out = np.zeros(self.size, dtype=np.float32)
        parts = []
        for s in range(self.world):
            lo, hi = self.offsets[s], self.offsets[s + 1]
            if hi <= lo:
                continue
            if s == self.rank and not self._bsp:
                out[lo:hi] = _host(self.local_store.read())[:hi - lo]
                continue
            msg = Message(src=self.rank, type=MsgType.Request_Get,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[np.empty(0, np.int32),
                                *self._get_opt_blob(option)])
            parts.append((s, msg, self._request_or_retry(s, msg)))
        servers = [s for s, _, _ in parts]

        def assemble(replies: List[Message]) -> np.ndarray:
            for s, reply in zip(servers, replies):
                lo, hi = self.offsets[s], self.offsets[s + 1]
                out[lo:hi] = unpack_payload(reply.data).ravel()[:hi - lo]
            return out

        return _PendingOp(parts, assemble, retrier=self._retry_request)

    def get(self, option: "Optional[GetOption]" = None) -> np.ndarray:
        with self._op_lock:
            op = self._get_op(option)
        return op.wait(self._op_timeout)

    def get_async(self, option: "Optional[GetOption]" = None) -> int:
        """Issues the wire requests and returns immediately; ``wait``
        assembles the replies (ref GetAsync, ``src/table.cpp:41-60``)."""
        with self._op_lock:
            return self._track(self._get_op(option))


class DistributedMatrixTable(DistributedTableBase):
    """2-D table row-sharded across processes; row-granular Get/Add."""

    def __init__(self, table_id: int, num_row: int, num_col: int,
                 service: PSService, peers: List[Tuple[str, int]],
                 rank: int, dtype=np.float32, updater: str = "default",
                 announce: bool = True, use_pallas: bool = False):
        super().__init__(table_id, service, peers, rank, announce=announce)
        self.name = f"dist_matrix_{table_id}"
        self.num_row = num_row
        self.num_col = num_col
        self.row_offsets = reference_server_offsets(num_row, self.world)
        zoo = Zoo.get()
        local_rows = self.row_offsets[rank + 1] - self.row_offsets[rank]
        self.local_store = ServerStore(
            f"dist_matrix_{table_id}", (max(local_rows, 1), num_col), dtype,
            get_updater(dtype, updater), _shard_device(zoo),
            self.world * self._n_local,   # DCN worker universe (see array)
            use_pallas_rows=use_pallas)
        # ONE registration carrying the sparse arming too (subclass hook):
        # register-then-overwrite would open a window where peers' STALE
        # gets find the table but not its bitmap and get dropped.
        service.register_shard(table_id, self.local_store,
                               row_offset=self.row_offsets[rank],
                               sync_workers=self._sync_workers(),
                               sparse_workers=self._sparse_slots(),
                               sparse_rows=local_rows)
        from multiverso_tpu_torch.parallel.async_engine import _stageable
        self._init_staging(num_row, num_col,
                           _stageable(self.local_store.updater))

    def _shard_offset(self) -> int:
        return int(self.row_offsets[self.rank])

    def _sparse_slots(self) -> int:
        """Per-worker staleness slots to arm on the serving shard; 0 =
        plain matrix table (DistributedSparseMatrixTable overrides)."""
        return 0

    def _route(self, rows: np.ndarray) -> Dict[int, np.ndarray]:
        """Row positions by owning server, servers in the order of their
        first row (the JAX module's per-row loop, vectorized)."""
        owner = np.minimum(np.searchsorted(self.row_offsets,
                                           np.asarray(rows), side="right")
                           - 1, self.world - 1)
        servers, first = np.unique(owner, return_index=True)
        return {int(s): np.flatnonzero(owner == s).astype(np.int64)
                for s in servers[np.argsort(first)]}

    # -- internals ---------------------------------------------------------
    def _send_add_rows(self, rows: np.ndarray, deltas: np.ndarray,
                       option: AddOption) -> _PendingOp:
        # Globalize the worker id (per-worker updater state + BSP clocks;
        # see _send_add).
        option = dataclasses.replace(
            option, worker_id=self._gid(option.worker_id))
        parts = []
        routed = self._route(rows)
        for s, ix in routed.items():
            keys, piece = rows[ix], deltas[ix]
            if s == self.rank and not self._bsp:
                self.local_store.apply_rows(
                    keys - self.row_offsets[s], piece, option)
                continue
            msg = Message(src=self.rank, type=MsgType.Request_Add,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[keys, _opt_to_array(option),
                                *pack_payload(piece, _wire_mode())])
            parts.append((s, msg, self._request_or_retry(s, msg)))
        parts.extend(self._bsp_tick_parts(MsgType.Request_Add, routed,
                                          option=option))
        return _PendingOp(parts, retrier=self._retry_request)

    # Sparse drain cap: bounds the per-flush scratch ([cap, num_col] f32,
    # e.g. 64K x 128 = 32MB) independent of table height; when more rows
    # than this are dirty the dense whole-table path below is cheaper
    # anyway (cf. AsyncTableEngine.sparse_drain_max).
    SPARSE_DRAIN_MAX = 65536

    def _flush_staged_locked(self) -> _PendingOp:
        opt, self._stage_opt = self._stage_opt or AddOption(), None
        sparse = self._stage_buf.drain_rows(
            min(self.num_row, self.SPARSE_DRAIN_MAX))
        if sparse is not None:
            ids, rows = sparse
            if len(ids) == 0:
                return _PendingOp([])
            return self._send_add_rows(np.asarray(ids, dtype=np.int32),
                                       rows, opt)
        merged, n = self._stage_buf.drain_dense()
        all_rows = np.arange(self.num_row, dtype=np.int32)
        return self._send_add_rows(all_rows,
                                   merged.reshape(self.num_row,
                                                  self.num_col), opt)

    # -- ops ---------------------------------------------------------------
    def add_rows(self, row_ids, deltas,
                 option: Optional[AddOption] = None) -> None:
        rows = np.asarray(row_ids, dtype=np.int32)
        deltas = _host_f32(deltas)
        with self._op_lock:
            self.flush()
            op = self._send_add_rows(rows, deltas, option or AddOption())
        op.wait(self._op_timeout)
        self.local_store.block()

    def add_rows_async(self, row_ids, deltas,
                       option: Optional[AddOption] = None) -> int:
        """Stage (linear updaters: merged by the native buffer, one wire
        message per server at flush) or fire without waiting (stateful)."""
        rows = np.asarray(row_ids, dtype=np.int32)
        deltas = _host_f32(deltas)
        option = option or AddOption()
        with self._op_lock:
            if self._stage_buf is not None:
                if self._stage_opt is not None and option != self._stage_opt:
                    self.flush()
                self._stage_opt = option
                self._stage_buf.add_rows(rows, deltas)
                self._g_stage_depth.set(self._stage_buf.pending)
                msg_id = self._next_msg_id()
                self._staged_ids.append(msg_id)
                self._insert_pending(msg_id, _PendingOp([]))  # -> flush op
                return msg_id
            op = self._send_add_rows(rows, deltas, option)
            self._track_add(op)
            msg_id = self._track(op)
        return msg_id

    def _get_rows_op(self, rows: np.ndarray,
                     option: "Optional[GetOption]" = None) -> _PendingOp:
        self.flush()
        out = np.zeros((len(rows), self.num_col), dtype=np.float32)
        parts = []
        indices = []
        routed = self._route(rows)
        for s, ix in routed.items():
            keys = rows[ix]
            if s == self.rank and not self._bsp:
                out[ix] = _host(self.local_store.read_rows(
                    keys - self.row_offsets[s]))
                continue
            msg = Message(src=self.rank, type=MsgType.Request_Get,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[keys, *self._get_opt_blob(option)])
            parts.append((s, msg, self._request_or_retry(s, msg)))
            indices.append(ix)
        # Tick parts go AFTER the data parts so assemble's zip skips them.
        parts.extend(self._bsp_tick_parts(MsgType.Request_Get, routed,
                                          get_option=option))

        def assemble(replies: List[Message]) -> np.ndarray:
            for ix, reply in zip(indices, replies):
                out[ix] = unpack_payload(reply.data)
            return out

        return _PendingOp(parts, assemble, retrier=self._retry_request)

    def get_rows(self, row_ids,
                 option: "Optional[GetOption]" = None) -> np.ndarray:
        rows = np.asarray(row_ids, dtype=np.int32)
        with self._op_lock:
            op = self._get_rows_op(rows, option)
        return op.wait(self._op_timeout)

    def get_rows_async(self, row_ids,
                       option: "Optional[GetOption]" = None) -> int:
        """Wire requests fired, id returned before replies arrive — the
        pipelined-pull primitive (ref ``ps_model.cpp:236-271``)."""
        rows = np.asarray(row_ids, dtype=np.int32)
        with self._op_lock:
            return self._track(self._get_rows_op(rows, option))


class KVServerStore:
    """Host-side hash-map shard store for :class:`DistributedKVTable`.

    The reference's KV server map does ``+=`` on Add and returns values on
    Get (``include/multiverso/table/kv_table.h:86-106``). Keys are
    non-negative int64 (negative keys are reserved wire sentinels) and
    values keep their declared dtype on the wire
    (``wire_raw``) — the word-count table needs exact integer accumulation
    (float32 drifts past 2^24 words). Accessed only from the service's
    single dispatcher thread plus checkpoint calls; the lock covers the
    latter."""

    wire_raw = True

    def __init__(self, name: str, dtype=np.int64):
        self.name = name
        self.dtype = np.dtype(dtype)
        self._map: Dict[int, float] = {}
        self._lock = make_lock("ps.sparse.shard")

    def apply_rows(self, keys: np.ndarray, values: np.ndarray,
                   opt: Optional[AddOption] = None) -> None:
        values = np.asarray(values).ravel()
        with self._lock:
            for k, v in zip(np.asarray(keys).ravel().tolist(),
                            values.tolist()):
                self._map[k] = self._map.get(k, 0) + v

    def read_rows(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            return np.asarray([self._map.get(k, 0)
                               for k in np.asarray(keys).ravel().tolist()],
                              dtype=self.dtype)

    def read(self) -> np.ndarray:
        """Whole-shard view — (keys, values) stacked; used by checkpoints
        and the sparse-shard row probe, never by the wire protocol."""
        with self._lock:
            ks = np.asarray(sorted(self._map), dtype=np.int64)
            return np.stack([ks.astype(self.dtype),
                             np.asarray([self._map[int(k)] for k in ks],
                                        dtype=self.dtype)]) \
                if ks.size else np.zeros((2, 0), dtype=self.dtype)

    def block(self) -> None:
        pass    # host map: adds are synchronous

    def store_state(self) -> Dict[str, np.ndarray]:
        with self._lock:
            keys = np.asarray(sorted(self._map), dtype=np.int64)
            vals = np.asarray([self._map[int(k)] for k in keys],
                              dtype=self.dtype)
        return {"kv_keys": keys, "kv_values": vals}

    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        with self._lock:
            self._map = dict(zip(payload["kv_keys"].tolist(),
                                 payload["kv_values"].tolist()))


class DistributedKVTable(DistributedTableBase):
    """Key->value table hash-partitioned across PS shards over DCN.

    The reference partitions by ``key % num_servers``
    (``kv_table.h:48-50``) and merges with ``+=`` server-side
    (``kv_table.h:86-93``); here each shard is a :class:`KVServerStore`
    behind this process's :class:`PSService`, so KV entries live where the
    hash says — across real processes, not a list of dicts in one (the
    round-3 gap). Checkpointing rides the standard per-rank shard path."""

    def __init__(self, table_id: int, service: PSService,
                 peers: List[Tuple[str, int]], rank: int, dtype=np.int64,
                 announce: bool = True):
        super().__init__(table_id, service, peers, rank, announce=announce)
        self.name = f"dist_kv_{table_id}"
        self.value_dtype = np.dtype(dtype)
        self.local_store = KVServerStore(self.name, dtype)
        service.register_shard(table_id, self.local_store,
                               sync_workers=self._sync_workers())

    def _shard_offset(self) -> int:
        return 0    # hash-partitioned: no contiguous offset

    def _route_keys(self, keys: np.ndarray) -> Dict[int, np.ndarray]:
        """``key % num_servers`` (ref kv_table.h:48-50), by index —
        vectorized: bulk KV ops must not pay a Python loop per key."""
        owners = keys % self.world
        return {int(s): np.flatnonzero(owners == s)
                for s in np.unique(owners)}

    def _send_add(self, keys: np.ndarray, values: np.ndarray,
                  option: AddOption) -> _PendingOp:
        option = dataclasses.replace(
            option, worker_id=self._gid(option.worker_id))
        parts = []
        routed = self._route_keys(keys)
        for s, ix in routed.items():
            if s == self.rank and not self._bsp:
                self.local_store.apply_rows(keys[ix], values[ix], option)
                continue
            msg = Message(src=self.rank, type=MsgType.Request_Add,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[keys[ix], _opt_to_array(option),
                                np.ascontiguousarray(values[ix])])
            parts.append((s, msg, self._request_or_retry(s, msg)))
        parts.extend(self._bsp_tick_parts(MsgType.Request_Add, routed,
                                          option=option,
                                          key_dtype=np.int64))
        return _PendingOp(parts, retrier=self._retry_request)

    @staticmethod
    def _check_keys(keys: np.ndarray) -> np.ndarray:
        """Keys must be non-negative int64: the wire reserves the negative
        key space for protocol sentinels (TICK_GET_KEY, STALE_GET_KEY)."""
        check(keys.size == 0 or int(keys.min()) >= 0,
              "KV keys must be non-negative (negative keys are reserved "
              "wire sentinels)")
        return keys

    def add(self, keys, values, option: Optional[AddOption] = None) -> None:
        keys = self._check_keys(np.asarray(keys, dtype=np.int64).ravel())
        values = np.asarray(values, dtype=self.value_dtype).ravel()
        check(len(keys) == len(values), "keys/values length mismatch")
        self._send_add(keys, values, option or AddOption()) \
            .wait(self._op_timeout)

    def add_async(self, keys, values,
                  option: Optional[AddOption] = None) -> int:
        keys = self._check_keys(np.asarray(keys, dtype=np.int64).ravel())
        values = np.asarray(values, dtype=self.value_dtype).ravel()
        check(len(keys) == len(values), "keys/values length mismatch")
        op = self._send_add(keys, values, option or AddOption())
        self._track_add(op)
        return self._track(op)

    def _get_op(self, keys: np.ndarray,
                option: "Optional[GetOption]" = None) -> _PendingOp:
        out = np.zeros(len(keys), dtype=self.value_dtype)
        parts, indices = [], []
        routed = self._route_keys(keys)
        for s, ix in routed.items():
            if s == self.rank and not self._bsp:
                out[ix] = _host(self.local_store.read_rows(keys[ix]))
                continue
            msg = Message(src=self.rank, type=MsgType.Request_Get,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[keys[ix], *self._get_opt_blob(option)])
            parts.append((s, msg, self._request_or_retry(s, msg)))
            indices.append(ix)
        parts.extend(self._bsp_tick_parts(MsgType.Request_Get, routed,
                                          get_option=option,
                                          key_dtype=np.int64))

        def assemble(replies: List[Message]) -> np.ndarray:
            for ix, reply in zip(indices, replies):
                out[ix] = reply.data[0].astype(self.value_dtype)
            return out

        return _PendingOp(parts, assemble, retrier=self._retry_request)

    def get(self, keys, option: "Optional[GetOption]" = None) -> np.ndarray:
        keys = self._check_keys(np.asarray(keys, dtype=np.int64).ravel())
        return self._get_op(keys, option).wait(self._op_timeout)

    def get_async(self, keys,
                  option: "Optional[GetOption]" = None) -> int:
        keys = self._check_keys(np.asarray(keys, dtype=np.int64).ravel())
        return self._track(self._get_op(keys, option))


class DistributedSparseMatrixTable(DistributedMatrixTable):
    """Row-sharded matrix with SERVER-SIDE per-worker staleness over DCN.

    The round-3 gap: the in-process SparseMatrixTable tracked staleness
    client-side only, so every DCN Get shipped every requested row. Here
    each PSService shard owns the reference's ``up_to_date_`` bitmap
    (sparse_matrix_table.cpp:184-258): Adds invalidate touched rows for
    other workers, and the incremental whole-table ``get`` pulls ONLY the
    rows stale for this worker from every shard — wire bytes scale with
    rows touched since the last pull, not with table size."""

    def __init__(self, table_id: int, num_row: int, num_col: int,
                 service: PSService, peers: List[Tuple[str, int]],
                 rank: int, dtype=np.float32, updater: str = "default",
                 announce: bool = True, use_pallas: bool = False):
        # Bitmap semantics are always the reference's loose UpdateAddState
        # (_SparseShardState docstring). Plain-add clients ADDITIONALLY
        # mirror their own delta into their cache so rows that were fresh
        # stay both fresh and correct; stateful updaters (sgd/ftrl — the
        # client cannot reproduce the server-side step) skip the mirror
        # and see own writes on the next pull of a stale row. Decided
        # from the RESOLVED updater instance after super().__init__ (a
        # typo'd name silently resolves to plain add in get_updater and
        # must still mirror). Placeholders set BEFORE super() because the
        # parent's register_shard path runs during it.
        self._mirror = False
        self._incr_cache: Dict[int, np.ndarray] = {}
        self.last_incremental_rows = 0   # observability (tests/monitor)
        super().__init__(table_id, num_row, num_col, service, peers, rank,
                         dtype=dtype, updater=updater, announce=announce,
                         use_pallas=use_pallas)
        self.name = f"dist_sparse_matrix_{table_id}"
        from multiverso_tpu_torch.core.updater import Updater
        self._mirror = type(self.local_store.updater) is Updater

    def _sparse_slots(self) -> int:
        """Arm the serving shard's staleness bitmap for the DCN worker
        universe (bitmap spans the REAL local rows — 0 on an empty
        shard)."""
        return self.world * self._n_local

    def _cache_for(self, wid: int) -> np.ndarray:
        cache = self._incr_cache.get(wid)
        if cache is None:
            cache = self._incr_cache[wid] = np.zeros(
                (self.num_row, self.num_col), dtype=np.float32)
        return cache

    def _send_add_rows(self, rows: np.ndarray, deltas: np.ndarray,
                       option: AddOption) -> _PendingOp:
        """Adds must reach the staleness bitmap even for this rank's own
        shard, so the LocalForward shortcut is disabled: route EVERYTHING
        through the service dispatch (still in-process for the local
        shard, one loopback hop). The server leaves the writer's own bits
        UNCHANGED (loose UpdateAddState, ref :199-223); plain-add clients
        mirror the delta into their cache here so rows that were fresh
        stay both fresh and correct."""
        option = dataclasses.replace(
            option, worker_id=self._gid(option.worker_id))
        if self._mirror:
            mirror_deltas = np.asarray(deltas, dtype=np.float32)
            if _wire_mode() == "bf16":
                # The freshness contract wants mirror == what the server
                # applied; in bf16 mode that is the ROUNDED delta. Adds
                # then contribute ZERO mirror/server drift — the only
                # residual is the one rounding of the priming pull (bf16
                # reply of a possibly-unrepresentable server value), so
                # total drift is bounded by one bf16 rounding of the
                # primed magnitude, never accumulating per add. That is
                # the precision the operator opted into with bf16 wire.
                from multiverso_tpu_torch.utils.quantization import (
                    bf16_bits_to_f32, f32_to_bf16_bits)
                mirror_deltas = bf16_bits_to_f32(
                    f32_to_bf16_bits(mirror_deltas)).reshape(
                        mirror_deltas.shape)
            np.add.at(self._cache_for(option.worker_id),
                      np.asarray(rows, dtype=np.int64), mirror_deltas)
        parts = []
        routed = self._route(rows)
        for s, ix in routed.items():
            # Mirror mode packs clip=0.0: the freshness contract requires
            # the server to apply EXACTLY the delta the client mirrored —
            # the lossy user clip threshold would diverge them silently.
            msg = Message(src=self.rank, type=MsgType.Request_Add,
                          table_id=self.table_id,
                          msg_id=self._next_msg_id(),
                          data=[rows[ix], _opt_to_array(option),
                                *pack_payload(
                                    deltas[ix], _wire_mode(),
                                    clip=0.0 if self._mirror else None)])
            parts.append((s, msg, self._request_or_retry(s, msg)))
        parts.extend(self._bsp_tick_parts(MsgType.Request_Add, routed,
                                          option=option))
        return _PendingOp(parts, retrier=self._retry_request)

    def _run_incremental(self, option: "Optional[GetOption]",
                         build_parts, result_fn) -> np.ndarray:
        """Shared scaffold for the two incremental-get entry points:
        flush, resolve the worker cache, fire ``build_parts(wid, cache)``
        (returning ``(parts, n_data)`` — data parts FIRST, BSP ticks
        after), scatter the served rows into the cache, and hand the
        cache to ``result_fn``.

        Async mode holds ``_op_lock`` through the wait: a concurrent
        ``add_rows`` mutates the same cache (the plain-add mirror), so a
        stale-get reply applied out of order with it could leave the
        cache holding pre-add values for a row whose fresh bit the mirror
        relies on. BSP waits outside the lock (the clock gates already
        enforce per-worker program order, and a gated wait under the lock
        could deadlock against another local worker's add on the same
        handle)."""
        with self._op_lock:
            self.flush()
            wid = self._gid(option.worker_id if option is not None else 0)
            cache = self._cache_for(wid)
            parts, n_data = build_parts(wid)

            def assemble(replies: List[Message]) -> np.ndarray:
                pulled = 0
                for reply in replies[:n_data]:
                    rows = reply.data[0]
                    if rows.size:
                        cache[rows] = unpack_payload(reply.data[1:])
                    pulled += int(rows.size)
                self.last_incremental_rows = pulled
                return result_fn(cache)

            op = _PendingOp(parts, assemble, retrier=self._retry_request)
            if not self._bsp:
                return op.wait(self._op_timeout)
        return op.wait(self._op_timeout)

    def get(self, option: "Optional[GetOption]" = None) -> np.ndarray:
        """Incremental whole-table get: each shard returns only the rows
        stale for this worker; the rest come from the local cache.

        View semantics per updater (see ``_SparseShardState``): plain-add
        tables mirror, so the view is fully current INCLUDING this
        worker's own writes; stateful updaters (sgd/ftrl) follow the
        reference's loose contract — the view is this worker's LAST PULL
        of each fresh row, and its own writes to fresh rows surface only
        once any worker re-stales them (the reference's exact
        UpdateAddState/UpdateGetState behavior)."""

        def build(wid):
            parts = []
            for s in range(self.world):
                msg = Message(src=self.rank, type=MsgType.Request_Get,
                              table_id=self.table_id,
                              msg_id=self._next_msg_id(),
                              data=[np.asarray([STALE_GET_KEY], np.int32),
                                    np.asarray([wid], np.int32)])
                parts.append((s, msg, self._request_or_retry(s, msg)))
            return parts, len(parts)

        return self._run_incremental(option, build,
                                     lambda cache: cache.copy())

    def get_rows(self, row_ids,
                 option: "Optional[GetOption]" = None) -> np.ndarray:
        """Keyed get. With a GetOption it is INCREMENTAL (the reference's
        keyed UpdateGetState, :244-253): only the stale subset of the
        requested rows crosses the wire; the rest come from this worker's
        cache — the pull shape of the distributed w2v cycle, where row
        sets overlap heavily across blocks. View semantics per updater
        are as :meth:`get` documents (stateful updaters: own writes to
        fresh rows surface on re-stale, the reference's loose contract).
        Without an option it is the plain non-incremental pull
        (staleness untouched, always server truth)."""
        if option is None:
            return super().get_rows(row_ids)
        req = np.asarray(row_ids, dtype=np.int32)
        uniq = np.unique(req)

        def build(wid):
            parts = []
            routed = self._route(uniq)
            for s, ix in routed.items():
                msg = Message(src=self.rank, type=MsgType.Request_Get,
                              table_id=self.table_id,
                              msg_id=self._next_msg_id(),
                              data=[np.asarray([STALE_ROWS_GET_KEY],
                                               np.int32),
                                    np.asarray([wid], np.int32),
                                    uniq[ix]])
                parts.append((s, msg, self._request_or_retry(s, msg)))
            n_data = len(parts)
            parts.extend(self._bsp_tick_parts(MsgType.Request_Get, routed,
                                              get_option=option))
            return parts, n_data

        return self._run_incremental(option, build,
                                     lambda cache: cache[req])

    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        """Restore this rank's SHARD and mark its whole bitmap stale (the
        reference initializes all-stale), so every worker re-pulls the
        restored rows. The worker-side incremental caches are KEPT: rows
        fresh on REMOTE shards were not restored and their cached values
        remain correct — clearing the cache while only the local bitmap
        resets would serve zeros for them. In a full-cluster restore
        every shard resets its own bitmap, so every row re-ships and
        stale cache contents are overwritten either way."""
        super().load_state(payload)
        st = self._service._sparse.get(self.table_id)
        if st is not None:
            st.stale[:] = True
