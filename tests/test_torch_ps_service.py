"""Port mirror of ``tests/test_ps_service.py``: its cases that are not marked
slow, run against ``multiverso_tpu_torch`` with every shard on the CPU
(``-platform=cpu``), in one process over loopback TCP."""

import os
import socket
import time

import numpy as np
import pytest

import _torch_port

# Set by _load_port.
DistributedArrayTable = DistributedMatrixTable = Message = MsgType = None
PSService = mv = pack_message = recv_message = send_message = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global DistributedArrayTable, DistributedMatrixTable, Message, MsgType
    global PSService, mv, pack_message, recv_message, send_message
    _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.actor import Message, MsgType
    from multiverso_tpu_torch.parallel.net import (
        pack_message, recv_message, send_message)
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedArrayTable, DistributedMatrixTable, PSService)


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


def test_wire_roundtrip():
    """Framing parity: header + blobs survive a socket round trip."""
    a, b = socket.socketpair()
    msg = Message(src=3, type=MsgType.Request_Add, table_id=7, msg_id=42,
                  data=[np.arange(5, dtype=np.int32),
                        np.ones((2, 3), dtype=np.float32)])
    send_message(a, msg)
    got = recv_message(b)
    assert got.src == 3 and got.type == MsgType.Request_Add
    assert got.table_id == 7 and got.msg_id == 42
    np.testing.assert_array_equal(got.data[0], np.arange(5, dtype=np.int32))
    np.testing.assert_allclose(got.data[1], np.ones((2, 3)))
    a.close(); b.close()


@pytest.fixture
def two_rank_world(mv_env):
    """Two services in one process simulating ranks 0 and 1."""
    svc0 = PSService()
    svc1 = PSService()
    peers = [svc0.address, svc1.address]
    yield svc0, svc1, peers
    svc0.close()
    svc1.close()


def test_distributed_array_add_get(two_rank_world):
    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(1, 100, svc0, peers, rank=0)
    t1 = DistributedArrayTable(1, 100, svc1, peers, rank=1)
    delta = np.arange(100, dtype=np.float32)
    t0.add(delta)                      # local shard + remote to rank 1
    np.testing.assert_allclose(t0.get(), delta)
    np.testing.assert_allclose(t1.get(), delta)   # rank 1 sees it too
    t1.add(delta)
    np.testing.assert_allclose(t0.get(), 2 * delta)


def test_distributed_array_updater(two_rank_world):
    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(2, 10, svc0, peers, rank=0, updater="sgd")
    DistributedArrayTable(2, 10, svc1, peers, rank=1, updater="sgd")
    t0.add(np.ones(10, dtype=np.float32))
    np.testing.assert_allclose(t0.get(), -np.ones(10))  # sgd: data -= delta


def test_distributed_matrix_rows(two_rank_world):
    svc0, svc1, peers = two_rank_world
    m0 = DistributedMatrixTable(3, 20, 4, svc0, peers, rank=0)
    m1 = DistributedMatrixTable(3, 20, 4, svc1, peers, rank=1)
    # rows 0-9 live on rank 0, rows 10-19 on rank 1
    rows = [2, 15, 9, 10]
    deltas = np.stack([np.full(4, float(r)) for r in rows]).astype(np.float32)
    m0.add_rows(rows, deltas)
    got = m1.get_rows(rows)
    np.testing.assert_allclose(got, deltas)
    # duplicate adds accumulate across rank boundaries
    m1.add_rows(rows, deltas)
    np.testing.assert_allclose(m0.get_rows(rows), 2 * deltas)


def test_heartbeat_failure_detection(mv_env):
    from multiverso_tpu_torch.parallel.ps_service import PeerClient

    svc = PSService()
    t = DistributedArrayTable(9, 10, svc, [svc.address], rank=0)
    client = PeerClient(*svc.address)
    tables = client.ping(timeout=10)
    assert tables == [9]
    # dead peer: pings eventually come back None (the conn thread may serve
    # one last in-flight message before noticing shutdown)
    svc.close()
    for _ in range(10):
        if client.ping(timeout=1) is None:
            break
    else:
        pytest.fail("dead peer never detected")
    client.close()


def test_peer_death_fails_fast_not_hangs(mv_env):
    """Failure semantics: a worker whose peer dies mid-training gets a
    prompt FatalError (fail-fast waiter release), never a hang."""
    import time as _time
    from multiverso_tpu_torch.utils.log import FatalError

    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    t0 = DistributedArrayTable(4, 20, svc0, peers, rank=0)
    DistributedArrayTable(4, 20, svc1, peers, rank=1)
    t0.add(np.ones(20, dtype=np.float32))        # healthy round trip
    svc1.close()                                  # peer dies
    _time.sleep(0.2)
    start = _time.perf_counter()
    with pytest.raises((FatalError, OSError)):
        for _ in range(50):                       # conn may die lazily
            t0.add(np.ones(20, dtype=np.float32))
            _time.sleep(0.05)
    assert _time.perf_counter() - start < 30      # fail-fast, not timeout
    svc0.close()


def test_elastic_rank_restart_and_readmission(mv_env):
    """Kill rank 1, restart it from a checkpoint of its shard, reconnect —
    traffic resumes with no lost state."""
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    t0 = DistributedArrayTable(6, 40, svc0, peers, rank=0)
    t1 = DistributedArrayTable(6, 40, svc1, peers, rank=1)
    t0.add(np.arange(40, dtype=np.float32))
    np.testing.assert_allclose(t0.get(), np.arange(40))

    # rank 1 checkpoints its shard through the checkpoint layer (the
    # DistributedTableBase store_state/load_state surface), then dies
    import tempfile

    from multiverso_tpu_torch.core import checkpoint as ckpt
    uri = f"file://{os.path.join(tempfile.mkdtemp(), 'shard1.npz')}"
    ckpt.save_table(t1, uri)
    svc1.close()
    time.sleep(0.2)
    with pytest.raises(Exception):
        for _ in range(50):
            t0.add(np.ones(40, dtype=np.float32))
            time.sleep(0.05)

    # rank 1 restarts at a NEW address, restores its shard, re-registers
    svc1b = PSService()
    t1b = DistributedArrayTable(6, 40, svc1b,
                                [peers[0], svc1b.address], rank=1)
    ckpt.load_table(t1b, uri)
    t0.reconnect(1, svc1b.address)

    # traffic resumes; rank-1 shard content survived the restart
    full = t0.get()
    np.testing.assert_allclose(full[20:40], np.arange(20, 40))
    t0.add(np.ones(40, dtype=np.float32))
    assert t0.get()[39] == pytest.approx(40.0)
    svc0.close(); svc1b.close()


def test_net_bind_connect_api():
    """MV_NetBind/MV_NetConnect parity surface over the PS service."""
    import multiverso_tpu as mv2

    mv2.init([])
    try:
        addr = mv2.net_bind()
        assert addr[1] > 0
        mv2.net_connect([addr])
        t = mv2.create_distributed_array_table(77, 16, rank=0)
        t.add(np.ones(16, dtype=np.float32))
        np.testing.assert_allclose(t.get(), np.ones(16))
    finally:
        mv2.shutdown()


# -- real async surface -------------------------------
def test_add_async_staging_merges_wire_messages(two_rank_world, monkeypatch):
    """N staged add_async calls must become ONE Request_Add frame per remote
    server at flush, and the merged sum must land."""
    import multiverso_tpu_torch.parallel.ps_service as pss

    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(30, 64, svc0, peers, rank=0)
    DistributedArrayTable(30, 64, svc1, peers, rank=1)

    sent_adds = []
    orig = pss.send_message

    def counting(sock, msg):
        if msg.type == MsgType.Request_Add:
            sent_adds.append(msg)
        orig(sock, msg)

    monkeypatch.setattr(pss, "send_message", counting)
    ids = [t0.add_async(np.full(64, float(i + 1), dtype=np.float32))
           for i in range(8)]
    assert sent_adds == []            # all staged, nothing on the wire yet
    got = t0.get()                    # get flushes first (read-your-writes)
    assert len(sent_adds) == 1        # one merged frame to the one peer
    np.testing.assert_allclose(got, np.full(64, 36.0))
    for i in ids:                     # staged ids resolve to the flush batch
        t0.wait(i)


def test_get_async_returns_before_reply(two_rank_world):
    """get_async must issue the wire request and return immediately even
    when the serving peer is slow; wait() then assembles the reply."""
    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(31, 40, svc0, peers, rank=0)
    DistributedArrayTable(31, 40, svc1, peers, rank=1)
    t0.add(np.arange(40, dtype=np.float32))

    orig = svc1._dispatch_control

    def slow(msg):
        time.sleep(0.5)
        return orig(msg)

    svc1._dispatch_control = slow
    start = time.perf_counter()
    msg_id = t0.get_async()
    issue_time = time.perf_counter() - start
    result = t0.wait(msg_id)
    total_time = time.perf_counter() - start
    assert issue_time < 0.2, f"get_async blocked for {issue_time:.2f}s"
    assert total_time >= 0.5          # the reply really was slow
    np.testing.assert_allclose(result, np.arange(40))


def test_stateful_updater_fire_and_forget_matches_blocking(two_rank_world):
    """AdaGrad (non-stageable) adds fire without waiting but apply in FIFO
    order per connection — final state must equal the blocking sequence."""
    from multiverso_tpu_torch.core.options import AddOption

    svc0, svc1, peers = two_rank_world
    t_async = DistributedArrayTable(32, 20, svc0, peers, rank=0,
                                    updater="adagrad")
    DistributedArrayTable(32, 20, svc1, peers, rank=1, updater="adagrad")
    t_block = DistributedArrayTable(33, 20, svc0, peers, rank=0,
                                    updater="adagrad")
    DistributedArrayTable(33, 20, svc1, peers, rank=1, updater="adagrad")

    opt = AddOption(learning_rate=0.1, rho=0.9)
    for i in range(3):
        delta = np.full(20, float(i + 1), dtype=np.float32)
        t_async.add_async(delta, opt)
        t_block.add(delta, opt)
    t_async.flush(wait=True)
    t_async.local_store.block()
    np.testing.assert_allclose(t_async.get(), t_block.get(), rtol=1e-6)


def test_pipelined_pull_overlaps_compute(two_rank_world):
    """The double-buffer pattern (ref ps_model.cpp:236-271): with a slow
    server, issue-next-pull-then-compute must beat pull-then-compute."""
    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(34, 16, svc0, peers, rank=0)
    DistributedArrayTable(34, 16, svc1, peers, rank=1)
    t0.add(np.ones(16, dtype=np.float32))

    delay, compute, rounds = 0.15, 0.15, 4
    orig = svc1._dispatch_control

    def slow(msg):
        time.sleep(delay)
        return orig(msg)

    svc1._dispatch_control = slow

    start = time.perf_counter()
    for _ in range(rounds):
        t0.get()
        time.sleep(compute)           # un-overlapped: serial pull + compute
    serial = time.perf_counter() - start

    start = time.perf_counter()
    pending = t0.get_async()
    for _ in range(rounds):
        time.sleep(compute)           # compute overlaps the in-flight pull
        t0.wait(pending)
        pending = t0.get_async()
    t0.wait(pending)
    pipelined = time.perf_counter() - start
    assert pipelined < serial * 0.85, (
        f"no overlap: pipelined {pipelined:.2f}s vs serial {serial:.2f}s")


def test_matrix_add_rows_async_staging(two_rank_world, monkeypatch):
    """Row adds stage in the native buffer: duplicates merge, one wire frame
    per touched server at flush."""
    import multiverso_tpu_torch.parallel.ps_service as pss

    svc0, svc1, peers = two_rank_world
    m0 = DistributedMatrixTable(35, 20, 4, svc0, peers, rank=0)
    DistributedMatrixTable(35, 20, 4, svc1, peers, rank=1)

    sent_adds = []
    orig = pss.send_message

    def counting(sock, msg):
        if msg.type == MsgType.Request_Add:
            sent_adds.append(msg)
        orig(sock, msg)

    monkeypatch.setattr(pss, "send_message", counting)
    # rows 5 (local shard) and 15 (remote shard), added twice each
    for _ in range(2):
        m0.add_rows_async([5, 15], np.ones((2, 4), dtype=np.float32))
    assert sent_adds == []
    got = m0.get_rows([5, 15])
    assert len(sent_adds) == 1
    np.testing.assert_allclose(got, np.full((2, 4), 2.0))


def test_world16_stress_bounded_threads(mv_env):
    """Hardening: 16 ranks, all-to-all traffic — each
    service must hold its fixed 2-thread budget (selector IO + dispatcher),
    and every rank must observe the full accumulated state."""
    import threading as _threading

    world = 16
    services = [PSService() for _ in range(world)]
    peers = [s.address for s in services]
    tables = [DistributedArrayTable(40, 160, services[r], peers, rank=r)
              for r in range(world)]
    for svc in services:
        assert svc.num_service_threads == 2

    before = _threading.active_count()
    errors = []

    def worker(r):
        try:
            for i in range(5):
                tables[r].add_async(np.full(160, 1.0, dtype=np.float32))
            tables[r].flush(wait=True)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [_threading.Thread(target=worker, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors[0]
    # each service still exactly 2 threads despite 15 inbound connections
    for svc in services:
        assert svc.num_service_threads == 2
    expected = np.full(160, float(world * 5), dtype=np.float32)
    for r in (0, 7, 15):
        np.testing.assert_allclose(tables[r].get(), expected)
    for t_ in tables:
        t_.close()
    for s in services:
        s.close()


# -- wire compression ---------------------------------
def _count_wire_bytes(monkeypatch, kinds):
    """Patch net.pack_message to tally packed bytes by msg type — the one
    choke point BOTH legs go through (requests via send_message, replies
    via the IO thread's function-local pack_message import)."""
    import multiverso_tpu_torch.parallel.net as net

    counts = {k: 0 for k in kinds}
    orig = net.pack_message

    def counting(msg):
        data = orig(msg)
        if msg.type in counts:
            counts[msg.type] += len(data)
        return data

    monkeypatch.setattr(net, "pack_message", counting)
    return counts


def test_wire_sparse_filter_reduces_bytes(two_rank_world, monkeypatch):
    """A 95%-zero delta must cross the wire sparse (FilterIn analog) and
    reconstruct exactly (FilterOut); bytes on the wire must shrink."""
    from multiverso_tpu_torch.utils.configure import set_flag

    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(50, 4000, svc0, peers, rank=0)
    DistributedArrayTable(50, 4000, svc1, peers, rank=1)

    rng = np.random.default_rng(0)
    delta = np.zeros(4000, dtype=np.float32)
    hot = rng.choice(4000, size=200, replace=False)
    delta[hot] = rng.normal(size=200).astype(np.float32)

    counts = _count_wire_bytes(monkeypatch,
                               (MsgType.Request_Add, MsgType.Reply_Get))
    set_flag("wire_compression", "none")
    t0.add(delta)
    raw_add = counts[MsgType.Request_Add]

    set_flag("wire_compression", "sparse")
    t0.add(delta)
    sparse_add = counts[MsgType.Request_Add] - raw_add
    assert sparse_add < raw_add * 0.35, (raw_add, sparse_add)

    got = t0.get()                  # reply leg also filtered (mostly zeros)
    np.testing.assert_allclose(got, 2 * delta)
    assert counts[MsgType.Reply_Get] < raw_add * 0.5


def test_wire_bf16_halves_bytes_both_legs(two_rank_world, monkeypatch):
    """bf16 wire mode: dense deltas AND get replies cross the wire as
    uint16 bf16 halves (~50% of raw bytes), with values within bf16
    rounding of the f32 path."""
    from multiverso_tpu_torch.utils.configure import set_flag

    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(52, 4096, svc0, peers, rank=0)
    DistributedArrayTable(52, 4096, svc1, peers, rank=1)

    rng = np.random.default_rng(2)
    delta = rng.normal(size=4096).astype(np.float32)   # dense: no sparsify

    counts = _count_wire_bytes(monkeypatch,
                               (MsgType.Request_Add, MsgType.Reply_Get))
    try:
        set_flag("wire_compression", "none")
        t0.add(delta)
        raw_add = counts[MsgType.Request_Add]
        _ = t0.get()
        raw_reply = counts[MsgType.Reply_Get]

        set_flag("wire_compression", "bf16")
        t0.add(delta)
        bf16_add = counts[MsgType.Request_Add] - raw_add
        got = t0.get()
        bf16_reply = counts[MsgType.Reply_Get] - raw_reply
    finally:
        set_flag("wire_compression", "sparse")

    # headers/keys are small next to a 16KB payload: expect ~0.5x
    assert bf16_add < raw_add * 0.62, (raw_add, bf16_add)
    assert bf16_reply < raw_reply * 0.62, (raw_reply, bf16_reply)
    # local shard exact-f32 add + bf16 read; remote shard bf16 add too.
    # bf16 has 8 mantissa bits -> relative error ~2^-8 per rounding, a few
    # roundings deep here.
    np.testing.assert_allclose(got, 2 * delta, rtol=0.03, atol=0.02)


def test_wire_bf16_bits_roundtrip():
    """RNE truncation: bf16-representable values round-trip exactly;
    arbitrary values within 2^-8 relative."""
    from multiverso_tpu_torch.utils.quantization import (bf16_bits_to_f32,
                                                   f32_to_bf16_bits)

    exact = np.array([0.0, 1.0, -2.5, 0.15625, 2.0 ** 100, -2.0 ** -100],
                     dtype=np.float32)
    np.testing.assert_array_equal(
        bf16_bits_to_f32(f32_to_bf16_bits(exact)), exact)
    rng = np.random.default_rng(3)
    x = rng.normal(size=10_000).astype(np.float32)
    y = bf16_bits_to_f32(f32_to_bf16_bits(x))
    rel = np.abs(y - x) / np.maximum(np.abs(x), 1e-30)
    assert rel.max() <= 2.0 ** -8, rel.max()


def test_wire_onebit_error_feedback_converges(two_rank_world):
    """OneBit mode quantizes add payloads to sign bits + scales with
    sender-held error feedback: K pushes of the same delta must accumulate
    to ~K*delta (residual stays bounded), and the flag must not corrupt
    get replies (absolute values never quantized)."""
    from multiverso_tpu_torch.utils.configure import set_flag

    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(51, 64, svc0, peers, rank=0)
    DistributedArrayTable(51, 64, svc1, peers, rank=1)

    rng = np.random.default_rng(1)
    delta = rng.normal(size=64).astype(np.float32)
    set_flag("wire_compression", "onebit")
    try:
        K = 50
        for _ in range(K):
            t0.add(delta)
        got = t0.get()
    finally:
        set_flag("wire_compression", "sparse")
    # local shard (rank 0's half) is exact; remote half is 1-bit quantized
    # with error feedback: accumulated error == the sender-held residual,
    # which stays BOUNDED independent of K (measured ~14 for this seed at
    # K=50..5000), so the relative error vanishes as 1/K.
    np.testing.assert_allclose(got[:32], K * delta[:32], rtol=1e-5)
    err = np.abs(got[32:] - K * delta[32:])
    assert err.max() < 20.0, err.max()
    assert err.max() / K < np.abs(delta[32:]).mean()


def test_elastic_auto_readmission_no_manual_reconnect(mv_env):
    """elastic membership: rank 1 dies and restarts at
    a NEW address. Its table construction re-registers with the rank-0
    directory; rank 0's next failed request rediscovers the address through
    the directory and traffic resumes — NO reconnect() call anywhere."""
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    t0 = DistributedArrayTable(60, 40, svc0, peers, rank=0)
    t1 = DistributedArrayTable(60, 40, svc1, peers, rank=1)
    t0.add(np.arange(40, dtype=np.float32))
    np.testing.assert_allclose(t0.get(), np.arange(40))

    import tempfile

    from multiverso_tpu_torch.core import checkpoint as ckpt
    uri = f"file://{os.path.join(tempfile.mkdtemp(), 'shard1.npz')}"
    ckpt.save_table(t1, uri)
    svc1.close()                 # rank 1 dies
    time.sleep(0.3)

    # rank 1 restarts at a new port; enable_directory re-registers it
    svc1b = PSService()
    t1b = DistributedArrayTable(60, 40, svc1b,
                                [peers[0], svc1b.address], rank=1)
    ckpt.load_table(t1b, uri)

    # rank 0 still points at the DEAD address; the failed request must
    # rediscover the new one through the directory automatically
    got = t0.get()
    np.testing.assert_allclose(got, np.arange(40))
    t0.add(np.ones(40, dtype=np.float32))
    assert t0.get()[39] == pytest.approx(40.0)
    svc0.close(); svc1b.close()


def test_reply_leg_never_clips_parameter_values(two_rank_world):
    """A user clip threshold sparsifies add DELTAS; Get replies carry
    absolute parameters and must come back exact even when most weights are
    inside the clip band (regression: review r2 finding)."""
    from multiverso_tpu_torch.utils.configure import set_flag

    svc0, svc1, peers = two_rank_world
    t0 = DistributedArrayTable(70, 40, svc0, peers, rank=0)
    DistributedArrayTable(70, 40, svc1, peers, rank=1)
    small = np.full(40, 0.01, dtype=np.float32)   # all inside the clip band
    set_flag("wire_compression_clip", 0.5)
    try:
        t0.add(np.ones(40, dtype=np.float32))     # deltas above clip: exact
        got = t0.get()
    finally:
        set_flag("wire_compression_clip", 0.0)
    np.testing.assert_allclose(got, np.ones(40))
    # now push values INTO the band and confirm the pull stays exact
    set_flag("wire_compression_clip", 0.0)
    t0.add(small - 1.0)
    np.testing.assert_allclose(t0.get(), small, rtol=1e-6)


# -- the port's own cases ------------------------------------------------------
def test_device_error_fails_the_request_and_the_service(two_rank_world,
                                                        monkeypatch):
    """An error of the card raised on the dispatcher (a CUDA error from a
    store call) is never swallowed: the request gets ``Reply_Error``, the
    service keeps the error in ``fatal`` and refuses later table ops, and
    ``check_fatal`` raises it; a malformed request still only drops its
    connection (test_malformed_wire_traffic_does_not_kill_the_service)."""
    from multiverso_tpu_torch.utils.log import FatalError
    svc0, svc1, peers = two_rank_world
    m0 = DistributedMatrixTable(9, 20, 4, svc0, peers, rank=0)
    m1 = DistributedMatrixTable(9, 20, 4, svc1, peers, rank=1)
    m0.add_rows([15], np.ones((1, 4), np.float32))

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(m1.local_store, "apply_rows", broken)
    with pytest.raises(FatalError, match="device failed"):
        m0.add_rows([15], np.ones((1, 4), np.float32))
    assert svc1.fatal is not None and svc0.fatal is None
    with pytest.raises(FatalError):
        m0.get_rows([15])              # refused, not served stale
    with pytest.raises(RuntimeError, match="device error"):
        svc1.check_fatal()
    svc0.check_fatal()


def test_ps_shard_main_seats_recover_bitwise_on_the_cpu():
    """``chip_smoke.py`` phase 10's row plane at a small size on the CPU:
    two ``ps_shard_main`` seats (``-serve_device=cpu``), the C client
    pushing row Adds with duplicates into a ``use_pallas`` sgd table and a
    default one, every shard bitwise the CPU replay, then seat 1 killed
    with SIGKILL, rerun, its WAL replayed and its shards bitwise the bytes
    before the kill."""
    import chip_smoke
    out = chip_smoke.ps_row_plane(0, rows=20_000, cols=8, n_ids=3_000,
                                  n_adds=4, seat_args=["-serve_device=cpu"])
    assert out["bitwise"] and out["recovery"]["applied"] == 8
    assert set(out["seat_launches"]) == {"seat 0 run 0", "seat 1 run 1"}
