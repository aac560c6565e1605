"""Write-ahead delta log for PS shards: durability between checkpoints.

Port of ``multiverso_tpu/core/wal.py``, host only. The record format is
the JAX package's byte for byte, so a log written by either package
replays in the other.

The reference's recovery story is checkpoint-only (``ServerTable::Store/
Load``, ``table_interface.h:61-75``): a killed server loses every delta
since the last snapshot. This module closes that window the way the
TensorFlow paper frames fault tolerance (PAPERS.md 1605.08695 — periodic
checkpoints plus a recovery path that is a first-class system property):
every accepted ``Request_Add`` appends one CRC-framed record; recovery is
*load latest checkpoint, replay the log tail*.

Design points (docs/DURABILITY.md is the full spec):

* **Record framing** — ``[u32 magic][u32 len][u64 lsn][u32 crc][payload]``
  where ``crc`` covers the lsn and the payload. The payload is an opaque
  blob (the PS service logs its wire-codec ``pack_message`` bytes, so the
  replay path IS the dispatch path). A torn tail — a record cut mid-write
  by the crash, or bit-rotted — fails the frame check and is DROPPED at
  the last whole-record boundary; everything before it replays.
* **LSN** — every record carries a monotonically increasing sequence
  number. Checkpoints capture the LSN their snapshot corresponds to
  (atomically, on the apply thread), and recovery replays only records
  with a HIGHER lsn — so a checkpoint that raced the prune, a prune that
  never ran, or a replay invoked twice can never double-apply a delta.
* **Group commit** — ``append`` is one list-append under a lock (the hot
  path must not pay an fsync per add); a flusher daemon writes + fsyncs
  the batch every ``flush_interval_ms``. The trade is explicit: an
  UNSYNCED tail (at most one flush interval of acked adds) can be lost
  on a hard kill. ``sync=True`` appends fsync before returning — the
  no-acked-write-loss mode the recovery drill runs — at per-record
  fsync cost on the dispatch thread.
* **Segments** — ``wal_<seq>.log`` files; ``rotate()`` (called at each
  checkpoint) seals the current segment and starts the next, and
  ``prune(upto_lsn)`` deletes sealed segments whose every record the
  newest checkpoint already covers. Pruning is an optimization only:
  correctness lives in the LSN filter.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Tuple

from multiverso_tpu_torch.telemetry import counter, gauge
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import log

_MAGIC = 0x57414C31          # "WAL1"
_HEADER = struct.Struct("<IIQI")   # magic, payload len, lsn, crc32
_SEGMENT_RE = re.compile(r"wal_(\d{6})\.log")

#: Guard against a corrupt length field making the reader allocate
#: gigabytes: no legitimate PS add message approaches this.
MAX_RECORD_BYTES = 256 << 20

#: Chaos slow-disk fault (fleet/chaos.py): extra seconds slept inside
#: every group commit's fsync, process-wide. Models a disk whose write
#: latency degraded (firmware GC pause, contended volume) — the commit
#: still HAPPENS, just late, so ``-wal_sync_acks`` acks stretch and the
#: group-commit window widens exactly as on real slow media. 0 = off.
_fsync_delay_s = 0.0


def set_fsync_delay(delay_s: float) -> None:
    """Install (or with 0 clear) the injected per-commit fsync delay."""
    global _fsync_delay_s
    _fsync_delay_s = max(0.0, float(delay_s))


def _frame(lsn: int, payload: bytes) -> bytes:
    crc = zlib.crc32(payload, zlib.crc32(struct.pack("<Q", lsn)))
    return _HEADER.pack(_MAGIC, len(payload), lsn, crc) + payload


def segment_paths(directory: str) -> List[Tuple[int, str]]:
    """``(seq, path)`` of every WAL segment in ``directory``, seq-ordered."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _SEGMENT_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def read_records(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield ``(lsn, payload)`` for every WHOLE, CRC-clean record; stop at
    the first torn or corrupt frame (the crash boundary) and drop the
    rest. Raises nothing on a torn tail — that is the expected shape of a
    log whose writer was killed mid-``write``. STREAMING: memory is one
    record, never the segment (a long uncheckpointed run can grow a
    segment to GBs, and recovery must not have to hold it whole)."""
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return
    with f:
        size = os.fstat(f.fileno()).st_size
        off = 0
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                break                           # clean EOF / torn header
            magic, length, lsn, crc = _HEADER.unpack(header)
            if magic != _MAGIC or length > MAX_RECORD_BYTES:
                break                           # corrupt header: stop
            payload = f.read(length)
            if len(payload) < length:
                break                           # torn payload: stop
            if zlib.crc32(payload,
                          zlib.crc32(struct.pack("<Q", lsn))) != crc:
                break                           # bit rot / torn write
            off += _HEADER.size + length
            yield lsn, payload
        dropped = size - off
        if dropped:
            counter("ps.wal.torn_bytes_dropped").inc(dropped)
            log.warning("wal: dropped %d torn/corrupt tail bytes of %s",
                        dropped, path)


def last_lsn(path: str) -> int:
    """Highest clean lsn in one segment (0 for empty/absent)."""
    lsn = 0
    for lsn, _ in read_records(path):
        pass
    return lsn


class WriteAheadLog:
    """Appender half: group-committed CRC-framed records in rotating
    segments. Thread-safe; one flusher daemon per log."""

    def __init__(self, directory: str, flush_interval_ms: float = 5.0,
                 start_lsn: Optional[int] = None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        existing = segment_paths(directory)
        self._seq = (existing[-1][0] + 1) if existing else 0
        # Continue the lsn sequence past everything already on disk so a
        # restarted shard's fresh appends never collide with records a
        # concurrent replay is still reading.
        if start_lsn is None:
            start_lsn = max((last_lsn(p) for _, p in existing), default=0)
        self._lsn = int(start_lsn)
        # Two locks, deliberately: _lock guards the staging list (what
        # the hot-path append touches) and _io_lock serializes file
        # writes + fsync. flush() must NOT hold _lock across the fsync —
        # a 1-5ms fsync would block every concurrent append behind it,
        # turning group commit's whole point inside out (measured 26%
        # add-throughput loss before the split on the A/B leg).
        self._lock = make_lock("wal.staging")
        self._io_lock = make_lock("wal.io")
        self._pending: List[bytes] = []
        self._pending_bytes = 0
        self._file = open(self._segment_name(self._seq), "ab")
        self._c_appends = counter("ps.wal.appends")
        self._c_flushes = counter("ps.wal.flushes")
        self._c_bytes = counter("ps.wal.bytes")
        self._g_pending = gauge("ps.wal.pending")
        self._g_lsn = gauge("ps.wal.lsn")
        self._stop = threading.Event()
        self._interval_s = max(float(flush_interval_ms), 0.1) / 1e3
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="wal-flusher", daemon=True)
        self._flusher.start()

    def _segment_name(self, seq: int) -> str:
        return os.path.join(self.directory, f"wal_{seq:06d}.log")

    @property
    def lsn(self) -> int:
        """Last ASSIGNED lsn (appended, not necessarily fsynced)."""
        with self._lock:
            return self._lsn

    def ensure_lsn_at_least(self, lsn: int) -> None:
        """Advance the assignment counter past ``lsn``. Recovery calls
        this with every checkpoint's ``wal_meta``: a crash in the
        group-commit window can leave the ON-DISK max lsn BEHIND lsns a
        durable checkpoint already claims to cover (assigned, applied,
        snapshotted — but never fsynced). Resuming assignment from the
        disk max would re-issue those covered lsns to FRESH adds, which
        the next recovery's ``lsn <= restore`` filter would then
        silently skip — acked-write loss outside the documented flush
        window."""
        with self._lock:
            self._lsn = max(self._lsn, int(lsn))

    @property
    def path(self) -> str:
        return self._segment_name(self._seq)

    # -- hot path ------------------------------------------------------------
    def append(self, payload: bytes, sync: bool = False) -> int:
        """Frame + stage one record; returns its lsn. ``sync=True`` forces
        the group commit (write + fsync) before returning — the durable-ack
        mode; default is the bounded-interval flusher. Deliberately
        minimal: frame + list-append under the staging lock; all counter
        and gauge publication happens at flush time (this runs on the PS
        dispatch hot path, where every microsecond is add throughput)."""
        with self._lock:
            self._lsn += 1
            lsn = self._lsn
            rec = _frame(lsn, payload)
            self._pending.append(rec)
            self._pending_bytes += len(rec)
        if sync:
            self.flush()
        return lsn

    # -- group commit --------------------------------------------------------
    def flush(self) -> None:
        """Write + fsync everything staged. ``_io_lock`` (held for the
        whole drain) keeps record order == stage order across concurrent
        flush/rotate; ``_lock`` is held only for the list swap so
        appends never wait out an fsync."""
        with self._io_lock:
            with self._lock:
                batch, self._pending = self._pending, []
                nbytes, self._pending_bytes = self._pending_bytes, 0
                lsn = self._lsn
                f = self._file
            if batch and f.closed:
                return      # close() raced a straggling append: records
            if batch:       # past the seal are lost BY DESIGN (= crash)
                f.write(b"".join(batch))
                f.flush()
                if _fsync_delay_s:
                    import time as _time    # injected slow-disk fault
                    _time.sleep(_fsync_delay_s)
                # fdatasync, not fsync: a journal needs its DATA (and
                # the size growth that makes it readable) durable; the
                # mtime metadata fsync additionally journals costs
                # several times more for nothing recovery reads.
                # _io_lock held across the sync ON PURPOSE: it exists
                # to serialize write+fsync so
                # record order == stage order; appends only ever wait
                # on _lock, which was released above.
                # graftlint: disable=lock-held-across-blocking
                os.fdatasync(f.fileno())
        if batch:
            self._c_appends.inc(len(batch))
            self._c_flushes.inc()
            self._c_bytes.inc(nbytes)
            self._g_pending.set(0)
            self._g_lsn.set(lsn)

    def _flush_loop(self) -> None:
        from multiverso_tpu_torch.telemetry import watchdog_scope
        with watchdog_scope("wal-flusher", timeout_s=120.0) as wd:
            while not self._stop.wait(self._interval_s):
                wd.beat()
                try:
                    self.flush()
                except OSError as e:
                    counter("ps.wal.flush_errors").inc()
                    log.error("wal: group commit failed: %s", e)

    # -- checkpoint coordination ---------------------------------------------
    def rotate(self) -> str:
        """Seal the current segment (flush + fsync) and start the next;
        returns the sealed segment's path. Called at checkpoint time so
        ``prune`` has whole sealed segments to reason about."""
        self.flush()
        with self._io_lock, self._lock:
            sealed = self._segment_name(self._seq)
            self._file.close()
            self._seq += 1
            self._file = open(self._segment_name(self._seq), "ab")
        return sealed

    def prune(self, upto_lsn: int) -> List[str]:
        """Delete SEALED segments whose every record is covered by a
        durable checkpoint at ``upto_lsn``. The lsn filter in replay makes
        this purely space reclamation — a prune that never runs costs
        bytes, never correctness."""
        removed = []
        current = self.path
        for _, path in segment_paths(self.directory):
            if path == current:
                continue
            if last_lsn(path) <= upto_lsn:
                try:
                    os.unlink(path)
                    removed.append(path)
                except OSError:
                    pass    # a racing prune won; the filter still holds
        return removed

    def close(self) -> None:
        self._stop.set()
        self._flusher.join(timeout=5)
        try:
            self.flush()
        finally:
            with self._io_lock, self._lock:
                try:
                    self._file.close()
                except OSError:
                    pass


def replay(directory: str, since_lsn: int = 0
           ) -> Iterator[Tuple[int, bytes]]:
    """Every clean record with ``lsn > since_lsn`` across all segments,
    lsn-ordered (segments are seq-ordered and lsns ascend within and
    across them by construction)."""
    for _, path in segment_paths(directory):
        for lsn, payload in read_records(path):
            if lsn > since_lsn:
                yield lsn, payload
