"""Port mirror of ``tests/test_wal.py``: its cases that are not marked slow,
run against ``multiverso_tpu_torch`` with every shard on the CPU
(``-platform=cpu``), in one process over loopback TCP."""

import os
import threading
import time

import numpy as np
import pytest

import _torch_port

# Set by _load_port.
DistributedArrayTable = DistributedSparseMatrixTable = PSService = W = None
ckpt = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global DistributedArrayTable, DistributedSparseMatrixTable, PSService
    global W, ckpt
    _torch_port.load_torch()
    from multiverso_tpu_torch.core import checkpoint as ckpt
    from multiverso_tpu_torch.core import wal as W
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedArrayTable, DistributedSparseMatrixTable, PSService)


def _reset_port():
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()


@pytest.fixture(autouse=True)
def _port_state():
    yield
    _reset_port()


@pytest.fixture
def mv_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu"])
    yield mvt
    _reset_port()


@pytest.fixture
def sync_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu", "-sync=true"])
    yield mvt
    _reset_port()



# ---------------------------------------------------------------------------
# Frame / segment mechanics
# ---------------------------------------------------------------------------
def test_roundtrip_and_lsn_sequence(tmp_path):
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    lsns = [w.append(f"r{i}".encode()) for i in range(5)]
    assert lsns == [1, 2, 3, 4, 5]
    w.flush()
    got = list(W.replay(str(tmp_path)))
    assert [(lsn, p.decode()) for lsn, p in got] == \
        [(i + 1, f"r{i}") for i in range(5)]
    w.close()


def test_zero_length_log_recovers_to_nothing(tmp_path):
    # No segments at all, then an empty segment: both replay to [].
    assert list(W.replay(str(tmp_path))) == []
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    w.close()       # creates wal_000000.log with zero records
    assert os.path.exists(os.path.join(str(tmp_path), "wal_000000.log"))
    assert list(W.replay(str(tmp_path))) == []
    assert W.last_lsn(os.path.join(str(tmp_path), "wal_000000.log")) == 0


@pytest.mark.parametrize("cut", ["header", "payload", "crc"])
def test_torn_final_record_dropped_at_frame_boundary(tmp_path, cut):
    """A record cut mid-write (the crash shape) — partial header, partial
    payload, or a corrupted byte — is dropped; every record BEFORE the
    tear replays intact."""
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    w.append(b"good-one")
    w.append(b"good-two")
    w.flush()
    path = w.path
    w.close()
    whole = open(path, "rb").read()
    torn = W._frame(3, b"torn-record")
    if cut == "header":
        torn = torn[:W._HEADER.size - 2]
    elif cut == "payload":
        torn = torn[:-3]
    else:           # crc: flip a payload byte AFTER the crc was stamped
        torn = bytearray(torn)
        torn[-1] ^= 0xFF
        torn = bytes(torn)
    with open(path, "wb") as f:
        f.write(whole + torn)
    got = [p.decode() for _, p in W.replay(str(tmp_path))]
    assert got == ["good-one", "good-two"]


def test_torn_middle_stops_before_following_records(tmp_path):
    """Corruption is a crash boundary, not a skip: a record after a bad
    frame is UNTRUSTED (its framing was only ever validated relative to
    the torn one) and must not replay."""
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    w.append(b"keep")
    w.flush()
    path = w.path
    w.close()
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data)
        f.write(b"\x00" * 7)                       # garbage
        f.write(W._frame(99, b"after-garbage"))    # valid frame after it
    got = [p.decode() for _, p in W.replay(str(tmp_path))]
    assert got == ["keep"]


def test_corrupt_length_field_cannot_balloon_reader(tmp_path):
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    w.append(b"ok")
    w.flush()
    path = w.path
    w.close()
    with open(path, "ab") as f:
        f.write(W._HEADER.pack(W._MAGIC, (1 << 32) - 1, 2, 0))
    assert [p for _, p in W.replay(str(tmp_path))] == [b"ok"]


def test_rotate_prune_and_restart_continue_lsns(tmp_path):
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    for i in range(3):
        w.append(f"a{i}".encode())
    sealed = w.rotate()
    w.append(b"b0", sync=True)
    # Prune covering the sealed segment only.
    removed = w.prune(3)
    assert removed == [sealed]
    assert [p.decode() for _, p in W.replay(str(tmp_path))] == ["b0"]
    w.close()
    # Restart continues the sequence past everything on disk.
    w2 = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    assert w2.append(b"c0", sync=True) == 5
    w2.close()
    assert [lsn for lsn, _ in W.replay(str(tmp_path))] == [4, 5]


def test_prune_never_touches_segments_with_uncovered_records(tmp_path):
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=10_000)
    w.append(b"x1")
    w.rotate()
    w.append(b"x2", sync=True)
    w.rotate()
    # Checkpoint only covers lsn 1: segment holding lsn 2 must survive.
    w.prune(1)
    lsns = [lsn for lsn, _ in W.replay(str(tmp_path))]
    assert lsns == [2]
    w.close()


def test_abandoned_atomic_stream_never_publishes(tmp_path):
    """utils/stream: a with-less writer abandoned mid-write (exception
    unwound) must NOT publish its partial temp over the intact previous
    file when GC finalizes it (review finding — IOBase.__del__ calls
    close())."""
    import gc

    from multiverso_tpu_torch.utils.stream import open_stream

    path = str(tmp_path / "meta.json")
    with open_stream(path, "w") as s:
        s.write(b"GOOD")
    s2 = open_stream(path, "w")
    s2.write(b"PART")            # abandoned: no close, no with-exit
    del s2
    gc.collect()
    with open(path, "rb") as f:
        assert f.read() == b"GOOD", "GC published a partial write"
    # ...and the explicit-close path still publishes.
    with open_stream(path, "w") as s3:
        s3.write(b"NEXT")
    assert open(path, "rb").read() == b"NEXT"


def test_group_commit_flushes_on_interval(tmp_path):
    w = W.WriteAheadLog(str(tmp_path), flush_interval_ms=20)
    w.append(b"deferred")
    deadline = time.monotonic() + 5
    while not list(W.replay(str(tmp_path))):
        assert time.monotonic() < deadline, "flusher never committed"
        time.sleep(0.01)
    w.close()


# ---------------------------------------------------------------------------
# PS-shard crash recovery (the tier-1 bitwise-parity witness)
# ---------------------------------------------------------------------------
TABLE = 471
SIZE = 48


def _crash(svc: PSService) -> None:
    """Simulate an abrupt death: tear the sockets down WITHOUT flushing
    the WAL or checkpointing — whatever the group commit already fsynced
    is all recovery gets (sync_acks mode: everything acked)."""
    svc._running = False
    try:
        svc._listener.close()
    except OSError:
        pass
    for sock in list(svc._decoders):
        try:
            sock.close()
        except OSError:
            pass


def _recover_seat(rank, peers, wal_dir, restore_uri, tmp_path):
    """The documented recovery order: attach WAL -> restore checkpoint ->
    replay tail -> ONLY THEN announce (restore-before-announce is the
    acked-write-loss guard the elastic fuzz pinned)."""
    svc = PSService()
    svc.attach_wal(wal_dir, sync_acks=True)
    peers = list(peers)
    peers[rank] = svc.address
    table = DistributedArrayTable(TABLE, SIZE, svc, peers, rank=rank,
                                  announce=False)
    if restore_uri:
        ckpt.load_table(table, restore_uri)
    report = svc.replay_wal()
    svc.enable_directory(rank, peers)
    return svc, table, peers, report


def test_killed_shard_recovers_bitwise_equal_to_unkilled(mv_env, tmp_path):
    """THE parity witness: two worlds driven by the same deterministic
    add stream; one shard is crashed and recovered from checkpoint+WAL,
    the other never dies. Recovered table bytes (params AND updater
    state) must be bitwise identical."""
    wal_dir = str(tmp_path / "wal")

    def build_world(with_wal):
        s0, s1 = PSService(), PSService()
        if with_wal:
            s1.attach_wal(wal_dir, sync_acks=True)
        peers = [s0.address, s1.address]
        t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
        t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)
        return s0, s1, t0, t1, peers

    def stream(seed):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=SIZE).astype(np.float32)
                for _ in range(24)]

    deltas = stream(3)

    # Reference world: never killed.
    r0, r1, rt0, rt1, _ = build_world(False)
    for d in deltas:
        rt0.add(d)
    ref_state = rt1.store_state()

    # Durable world: checkpoint at 1/3, crash at 2/3, recover, finish.
    s0, s1, t0, t1, peers = build_world(True)
    for d in deltas[:8]:
        t0.add(d)
    uri = f"file://{tmp_path}/seat1.npz"
    ckpt.save_table(t1, uri)
    s1.wal_checkpoint()
    for d in deltas[8:16]:
        t0.add(d)
    _crash(s1)
    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, uri,
                                            tmp_path)
    assert report["applied"] == 8     # exactly the post-checkpoint tail
    for d in deltas[16:]:
        t0.add(d)

    got_state = t1b.store_state()
    for key in ("data", "shard_meta"):
        np.testing.assert_array_equal(
            got_state[key], ref_state[key],
            err_msg=f"recovered '{key}' differs from never-killed shard")
    got_state.pop("wal_meta", None)
    assert set(got_state) == set(ref_state)
    for key in ref_state:
        np.testing.assert_array_equal(got_state[key], ref_state[key])

    # The CLIENT's full-table view agrees too (both halves).
    np.testing.assert_array_equal(np.asarray(t0.get()),
                                  np.asarray(rt0.get()))
    for s in (r0, r1, s0, s1b):
        s.close()


def test_replay_is_idempotent_and_skips_checkpointed_records(mv_env,
                                                             tmp_path):
    """Replay twice == replay once, and a checkpoint that never got its
    prune (crash between save and truncation — the checkpoint-truncation
    race) still recovers exactly: the lsn filter skips everything the
    restore already holds even though the records are still on disk."""
    wal_dir = str(tmp_path / "wal")
    s0, s1 = PSService(), PSService()
    s1.attach_wal(wal_dir, sync_acks=True)
    peers = [s0.address, s1.address]
    t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
    t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)

    rng = np.random.default_rng(11)
    acked = np.zeros(SIZE, np.float32)
    for _ in range(6):
        d = rng.integers(1, 4, SIZE).astype(np.float32)
        t0.add(d)
        acked += d
    uri = f"file://{tmp_path}/seat1.npz"
    ckpt.save_table(t1, uri)
    # DELIBERATELY no wal_checkpoint(): the pre-checkpoint records stay
    # in the log, exactly as a crash-before-prune would leave them.
    for _ in range(6):
        d = rng.integers(1, 4, SIZE).astype(np.float32)
        t0.add(d)
        acked += d
    _crash(s1)

    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, uri,
                                            tmp_path)
    assert report["applied"] == 6 and report["skipped"] == 6
    second = s1b.replay_wal()
    assert second == {"applied": 0, "skipped": 0}
    np.testing.assert_array_equal(np.asarray(t0.get()), acked)
    for s in (s0, s1b):
        s.close()


def test_recovery_with_zero_length_log(mv_env, tmp_path):
    """A shard that checkpointed and then died before any further add
    (or whose log was fully pruned) recovers from the checkpoint alone —
    an empty/absent WAL tail is a no-op, not an error."""
    wal_dir = str(tmp_path / "wal")
    s0, s1 = PSService(), PSService()
    s1.attach_wal(wal_dir, sync_acks=True)
    peers = [s0.address, s1.address]
    t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
    t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)
    t0.add(np.full(SIZE, 2.0, np.float32))
    uri = f"file://{tmp_path}/seat1.npz"
    ckpt.save_table(t1, uri)
    s1.wal_checkpoint()
    _crash(s1)
    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, uri,
                                            tmp_path)
    assert report == {"applied": 0, "skipped": 0}
    np.testing.assert_array_equal(np.asarray(t0.get()),
                                  np.full(SIZE, 2.0, np.float32))
    for s in (s0, s1b):
        s.close()


def test_recovered_shard_dedups_retransmit_of_logged_add(mv_env, tmp_path):
    """A peer whose add was applied+logged but whose ACK died with the
    shard retransmits the SAME message after recovery; the replayed
    reply cache must answer it from dedup instead of double-applying."""
    from multiverso_tpu_torch.core.actor import Message, MsgType
    from multiverso_tpu_torch.parallel.ps_service import (_opt_to_array,
                                                    pack_payload)
    from multiverso_tpu_torch.core.options import AddOption

    wal_dir = str(tmp_path / "wal")
    s0, s1 = PSService(), PSService()
    s1.attach_wal(wal_dir, sync_acks=True)
    peers = [s0.address, s1.address]
    t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
    t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)
    delta = np.full(SIZE, 1.0, np.float32)
    t0.add(delta)
    _crash(s1)
    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, None,
                                            tmp_path)
    assert report["applied"] == 1
    # Hand-retransmit the exact message the WAL logged (src 0, the
    # logged msg_id) straight into the recovered seat.
    lsn, payload = next(W.replay(wal_dir))
    from multiverso_tpu_torch.parallel.net import parse_frame
    logged, _ = parse_frame(bytearray(payload))
    import socket as _socket
    from multiverso_tpu_torch.parallel.net import recv_message, send_message
    with _socket.create_connection(s1b.address, timeout=10) as sock:
        send_message(sock, logged)
        reply = recv_message(sock)
    assert reply is not None and reply.msg_id == logged.msg_id
    assert reply.type != MsgType.Reply_Error
    # Applied once, not twice: seat 1's half of the table reads 1.0.
    lo = t0.offsets[1]
    np.testing.assert_array_equal(np.asarray(t0.get())[lo:],
                                  delta[lo:])
    for s in (s0, s1b):
        s.close()


def test_restart_never_reissues_checkpoint_covered_lsns(mv_env, tmp_path):
    """Crash in the group-commit window: the checkpoint durably covers
    lsns whose RECORDS died unfsynced, so the on-disk max lsn is BEHIND
    the restore mark. The restarted appender must resume PAST the
    restore lsn — resuming from the disk max would re-issue covered
    numbers to fresh adds, and a second recovery's filter would then
    silently drop those acked durable writes (review finding)."""
    wal_dir = str(tmp_path / "wal")
    s0, s1 = PSService(), PSService()
    # Async group commit with a huge interval: appended records stay
    # UNFSYNCED — the crash window, made deterministic.
    s1.attach_wal(wal_dir, flush_interval_ms=10_000_000)
    peers = [s0.address, s1.address]
    t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
    t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)
    acked = np.zeros(SIZE, np.float32)
    for _ in range(5):
        d = np.full(SIZE, 2.0, np.float32)
        t0.add(d)
        acked += d
    uri = f"file://{tmp_path}/seat1.npz"
    ckpt.save_table(t1, uri)        # wal_meta = 5; records 1-5 UNFSYNCED
    _crash(s1)                      # ...and lost with the crash
    assert list(W.replay(wal_dir)) == []    # disk max lsn = 0

    # First recovery: checkpoint only. Fresh adds MUST be assigned lsns
    # past the restore mark, not 1..5 again.
    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, uri,
                                            tmp_path)
    assert report == {"applied": 0, "skipped": 0}
    for _ in range(5):
        d = np.full(SIZE, 3.0, np.float32)
        t0.add(d)
        acked += d
    lsns = [lsn for lsn, _ in W.replay(wal_dir)]
    assert lsns and min(lsns) > 5, \
        f"restarted appender re-issued checkpoint-covered lsns: {lsns}"

    # Second crash WITHOUT a new checkpoint: replay must apply the
    # post-restore adds on top of the old checkpoint — exactly.
    _crash(s1b)
    s1c, t1c, peers, report2 = _recover_seat(1, peers, wal_dir, uri,
                                             tmp_path)
    assert report2["applied"] == 5, report2
    np.testing.assert_array_equal(np.asarray(t0.get()), acked)
    for s in (s0, s1c):
        s.close()


def test_retransmit_of_checkpoint_covered_add_dedups(mv_env, tmp_path):
    """A peer whose add was applied AND snapshotted but whose ack died
    with the shard retransmits after recovery; the record is replay-
    SKIPPED (the checkpoint holds it) but must still land in the reply
    cache — a double-apply on top of the restored state is the exact
    corruption the WAL exists to prevent (review finding)."""
    from multiverso_tpu_torch.core.actor import MsgType
    from multiverso_tpu_torch.parallel.net import (parse_frame, recv_message,
                                             send_message)
    import socket as _socket

    wal_dir = str(tmp_path / "wal")
    s0, s1 = PSService(), PSService()
    s1.attach_wal(wal_dir, sync_acks=True)
    peers = [s0.address, s1.address]
    t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
    t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)
    t0.add(np.full(SIZE, 1.0, np.float32))
    uri = f"file://{tmp_path}/seat1.npz"
    ckpt.save_table(t1, uri)        # the add's lsn is COVERED
    _crash(s1)
    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, uri,
                                            tmp_path)
    assert report["skipped"] >= 1 and report["applied"] == 0, report
    # Retransmit the covered add verbatim into the recovered seat.
    lsn, payload = next(W.replay(wal_dir))
    logged, _ = parse_frame(bytearray(payload))
    with _socket.create_connection(s1b.address, timeout=10) as sock:
        send_message(sock, logged)
        reply = recv_message(sock)
    assert reply is not None and reply.type != MsgType.Reply_Error
    lo = t0.offsets[1]
    np.testing.assert_array_equal(
        np.asarray(t0.get())[lo:], np.full(SIZE, 1.0, np.float32)[lo:],
        err_msg="covered add was re-applied on retransmit")
    for s in (s0, s1b):
        s.close()


def test_wal_under_concurrent_writer_snapshot_race(mv_env, tmp_path):
    """Checkpoint-truncation race, live flavor: snapshots are taken WHILE
    a writer streams adds (no external lock). The dispatcher-atomic
    (payload, lsn) capture must place every add on exactly one side of
    the cut — recovery equals the acked stream exactly."""
    wal_dir = str(tmp_path / "wal")
    s0, s1 = PSService(), PSService()
    s1.attach_wal(wal_dir, sync_acks=True)
    peers = [s0.address, s1.address]
    t0 = DistributedArrayTable(TABLE, SIZE, s0, peers, rank=0)
    t1 = DistributedArrayTable(TABLE, SIZE, s1, peers, rank=1)

    acked = np.zeros(SIZE, np.float64)
    stop = threading.Event()
    errors = []

    def writer():
        rng = np.random.default_rng(5)
        while not stop.is_set():
            d = rng.integers(1, 5, SIZE).astype(np.float32)
            try:
                t0.add(d)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)
                return
            acked[:] += d

    th = threading.Thread(target=writer)
    th.start()
    uri = f"file://{tmp_path}/seat1.npz"
    try:
        for _ in range(3):
            time.sleep(0.05)
            ckpt.save_table(t1, uri)       # races the live add stream
            s1.wal_checkpoint()
    finally:
        stop.set()
        th.join(timeout=60)
    assert not errors, errors
    _crash(s1)
    s1b, t1b, peers, report = _recover_seat(1, peers, wal_dir, uri,
                                            tmp_path)
    np.testing.assert_allclose(np.asarray(t0.get(), dtype=np.float64),
                               acked, rtol=0, atol=0)
    for s in (s0, s1b):
        s.close()


# ---------------------------------------------------------------------------
# Sparse matrix shards: the same parity witness over row-granular adds.
# The WAL journals the raw Request_Add frame and replays it through the
# normal dispatch path, so it is table-kind agnostic by construction —
# this pins that a row-sharded SPARSE seat (server-side staleness bitmap,
# stamped add options) satisfies the identical contract: killed and
# recovered == never killed, bitwise, with the restore re-arming the
# staleness plane (all-stale) so incremental pulls re-ship restored rows
# instead of trusting a pre-crash cache.
# ---------------------------------------------------------------------------
MTABLE = 473
ROWS, COLS = 24, 6


def _recover_matrix_seat(rank, peers, wal_dir, restore_uri):
    svc = PSService()
    svc.attach_wal(wal_dir, sync_acks=True)
    peers = list(peers)
    peers[rank] = svc.address
    table = DistributedSparseMatrixTable(MTABLE, ROWS, COLS, svc, peers,
                                         rank=rank, announce=False)
    if restore_uri:
        ckpt.load_table(table, restore_uri)
    report = svc.replay_wal()
    svc.enable_directory(rank, peers)
    return svc, table, peers, report


def test_killed_sparse_matrix_shard_recovers_bitwise(mv_env, tmp_path):
    """Parity witness, sparse-matrix flavor: two worlds driven by the
    same deterministic row-granular add stream; one seat is crashed and
    recovered from checkpoint + WAL tail, the other never dies. The
    recovered shard's bytes (params AND updater state) must be bitwise
    identical, and the clients' row reads must agree."""
    wal_dir = str(tmp_path / "wal")

    def build_world(with_wal):
        s0, s1 = PSService(), PSService()
        if with_wal:
            s1.attach_wal(wal_dir, sync_acks=True)
        peers = [s0.address, s1.address]
        t0 = DistributedSparseMatrixTable(MTABLE, ROWS, COLS, s0, peers,
                                          rank=0)
        t1 = DistributedSparseMatrixTable(MTABLE, ROWS, COLS, s1, peers,
                                          rank=1)
        return s0, s1, t0, t1, peers

    def stream(seed):
        rng = np.random.default_rng(seed)
        ops = []
        for _ in range(18):
            ids = np.sort(rng.choice(ROWS, size=4,
                                     replace=False)).astype(np.int32)
            ops.append((ids, rng.normal(size=(4, COLS))
                        .astype(np.float32)))
        return ops

    ops = stream(7)

    # Reference world: never killed.
    r0, r1, rt0, rt1, _ = build_world(False)
    for ids, d in ops:
        rt0.add_rows(ids, d)
    ref_state = rt1.store_state()

    # Durable world: checkpoint at 1/3, crash at 2/3, recover, finish.
    s0, s1, t0, t1, peers = build_world(True)
    for ids, d in ops[:6]:
        t0.add_rows(ids, d)
    uri = f"file://{tmp_path}/mseat1.npz"
    ckpt.save_table(t1, uri)
    s1.wal_checkpoint()
    for ids, d in ops[6:12]:
        t0.add_rows(ids, d)
    _crash(s1)
    s1b, t1b, peers, report = _recover_matrix_seat(1, peers, wal_dir, uri)
    # Only the ops that routed any row to seat 1 wrote a record; the
    # rows are random, so derive the expectation instead of pinning it.
    split = int(t1b.row_offsets[1])
    expect = sum(1 for ids, _ in ops[6:12] if (ids >= split).any())
    assert report["applied"] == expect, report
    for ids, d in ops[12:]:
        t0.add_rows(ids, d)

    got_state = t1b.store_state()
    got_state.pop("wal_meta", None)
    assert set(got_state) == set(ref_state)
    for key in ref_state:
        np.testing.assert_array_equal(
            got_state[key], ref_state[key],
            err_msg=f"recovered sparse shard '{key}' differs from "
                    "never-killed shard")

    # Row-granular client reads agree too — including rows the restore
    # marked stale (the incremental plane re-pulls; a pre-crash cache
    # must never answer for a restored row).
    all_rows = np.arange(ROWS, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(t0.get_rows(all_rows)),
                                  np.asarray(rt0.get_rows(all_rows)))
    for s in (r0, r1, s0, s1b):
        s.close()
