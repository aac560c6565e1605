"""Port parity: the native host runtime (``multiverso_tpu_torch/runtime``),
its build, and the C client of the PS wire.

Mirrors the native cases of ``tests/test_async_engine.py`` and
``tests/test_c_api_ffi.py``: the MPMC queue and the waiter, the
striped-lock ``DeltaBuffer`` (its merges single-threaded bitwise the JAX
package's library on the same inputs; the threaded sum exact on
integers), the library built from the port's own sources into
``build/multiverso_tpu_torch/``, and the C client (``mv_client.cpp``)
against the port's ``PSService`` shards on the CPU: the reference's C demo
program, and the ctypes wrapper bitwise the Python client. Also the
machine file's rank rule (``utils/net_util.py``) against the JAX module,
and the Zoo lifecycle cases of ``tests/test_runtime.py``.
"""

import os
import subprocess
import threading

import numpy as np
import pytest

import _torch_port
from multiverso_tpu.runtime import ffi as jffi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_SRC = os.path.join(REPO, "examples", "c_table_demo.c")

mvt = ffi = tps = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, ffi, tps
    _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.parallel import ps_service as tps
    from multiverso_tpu_torch.runtime import ffi


@pytest.fixture
def port_env():
    mvt.init(["-platform=cpu"])
    yield mvt
    mvt.shutdown()
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    Zoo._reset_for_tests()
    reset_flags()


def test_library_builds_into_the_port_build_dir():
    path = ffi.library_path()
    ffi.load()
    assert path.exists()
    assert path.parent == (
        ffi.BUILD_DIR) and str(path.parent).endswith(
            os.path.join("build", "multiverso_tpu_torch"))
    # Built from the port's own sources, never beside the JAX package's.
    srcs = [str(s) for s in ffi.SOURCES]
    assert all(os.path.join("multiverso_tpu_torch", "runtime", "src") in s
               for s in srcs), srcs
    assert not str(path).startswith(os.path.join(REPO, "multiverso_tpu",
                                                 "runtime"))
    assert "-ffast-math" not in ffi.CXX_FLAGS
    with open(ffi.SOURCES[0], "rb") as f:
        assert b"mvbuf_create" in f.read()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name (never a stale load)."""
    before = ffi.library_path()
    edited = tmp_path / "mv_runtime.cpp"
    edited.write_bytes(ffi.SOURCES[0].read_bytes() + b"\n// edit\n")
    monkeypatch.setattr(ffi, "SOURCES", (edited, ffi.SOURCES[1]))
    assert ffi.library_path() != before
    assert ffi.library_path().parent == before.parent


def test_native_queue_and_waiter():
    q = ffi.MtQueue()
    q.push(7)
    q.push(8)
    assert len(q) == 2
    assert q.pop(100) == 7
    assert q.pop(100) == 8
    assert q.pop(10) is None
    q.exit()
    assert q.pop(-1) is None

    w = ffi.Waiter(3)
    assert not w.wait(10)
    for _ in range(3):
        w.notify()
    assert w.wait(100)
    w.reset(1)
    assert not w.wait(10)


@pytest.mark.parametrize("cols", [1, 4, 50])
def test_delta_buffer_merges_bitwise_the_jax_library(cols):
    """Single-threaded, the same staged adds (dense and by rows, with
    duplicates and scales) drain to the same bytes from both libraries."""
    rng = np.random.default_rng(cols)
    rows = 300
    bufs = [jffi.DeltaBuffer(rows, cols), ffi.DeltaBuffer(rows, cols)]
    for step in range(12):
        alpha = float(rng.choice([1.0, 0.5, -0.25]))
        if step % 3 == 0:
            d = rng.normal(size=(rows, cols)).astype(np.float32)
            for b in bufs:
                b.add_dense(d.reshape(-1), alpha)
        else:
            ids = rng.integers(0, rows, size=40).astype(np.int32)
            d = rng.normal(size=(40, cols)).astype(np.float32)
            for b in bufs:
                b.add_rows(ids, d, alpha)
        if step == 5:
            for a, b in zip(bufs[0].drain_dense(), bufs[1].drain_dense()):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert bufs[0].pending == bufs[1].pending > 0
    dj, dt = bufs[0].drain_dense(), bufs[1].drain_dense()
    assert dj[1] == dt[1]
    assert dj[0].tobytes() == dt[0].tobytes()


def test_delta_buffer_sparse_drain_bitwise_the_jax_library():
    rng = np.random.default_rng(3)
    bufs = [jffi.DeltaBuffer(1000, 8), ffi.DeltaBuffer(1000, 8)]
    for _ in range(5):
        ids = rng.integers(0, 1000, size=30).astype(np.int32)
        d = rng.normal(size=(30, 8)).astype(np.float32)
        for b in bufs:
            b.add_rows(ids, d)
    (ij, rj), (it, rt) = bufs[0].drain_rows(4096), bufs[1].drain_rows(4096)
    assert ij.tobytes() == it.tobytes() and rj.tobytes() == rt.tobytes()
    # More dirty rows than max_rows: both fall back to a dense drain.
    for b in bufs:
        b.add_rows(np.arange(50, dtype=np.int32),
                   np.ones((50, 8), np.float32))
    assert bufs[0].drain_rows(10) is None and bufs[1].drain_rows(10) is None


def test_delta_buffer_threaded_accumulation():
    buf = ffi.DeltaBuffer(64, 4)
    n_threads, n_adds = 8, 100

    def hammer():
        d = np.ones((64, 4), dtype=np.float32)
        for _ in range(n_adds):
            buf.add_dense(d)

    ts = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    merged, count = buf.drain_dense()
    assert count == n_threads * n_adds
    np.testing.assert_array_equal(merged, np.full((64, 4),
                                                  float(n_threads * n_adds)))


def test_c_client_symbols_exported():
    import ctypes
    lib = ctypes.CDLL(str(ffi.library_path()))
    for sym in ("MV_ConnectClient", "MV_CloseClient", "MV_NumServers",
                "MV_NewArrayTable", "MV_GetArrayTable", "MV_AddArrayTable",
                "MV_NewMatrixTable", "MV_AddMatrixTableByRows",
                "MV_GetMatrixTableByRows", "MV_NewKVTable", "MV_AddKVTable",
                "MV_GetKVTable", "MV_FreeTable"):
        assert hasattr(lib, sym), f"missing symbol {sym}"


@pytest.fixture(scope="module")
def demo_binary(tmp_path_factory):
    ffi.load()
    out = tmp_path_factory.mktemp("cdemo") / "c_table_demo"
    cc = os.environ.get("CC", "gcc")
    subprocess.run([cc, "-O2", "-Wall", "-o", str(out), DEMO_SRC, "-ldl"],
                   check=True, capture_output=True, text=True)
    return str(out)


def test_c_demo_against_port_shards(demo_binary, port_env):
    """The reference-style C program against two port shards: C reads
    what Python wrote and Python reads what C wrote."""
    svc0, svc1 = tps.PSService(), tps.PSService()
    peers = [svc0.address, svc1.address]
    AID, MID, KID = 201, 202, 203
    try:
        a0 = tps.DistributedArrayTable(AID, 10, svc0, peers, rank=0)
        a1 = tps.DistributedArrayTable(AID, 10, svc1, peers, rank=1)
        m0 = tps.DistributedMatrixTable(MID, 8, 3, svc0, peers, rank=0)
        tps.DistributedMatrixTable(MID, 8, 3, svc1, peers, rank=1)
        k0 = tps.DistributedKVTable(KID, svc0, peers, rank=0)
        tps.DistributedKVTable(KID, svc1, peers, rank=1)
        a0.add(np.arange(100, 110, dtype=np.float32))
        m0.add_rows([1, 3, 6], np.full((3, 3), 10.0, dtype=np.float32))
        k0.add([4, 7, 1000000007], [1000, 1000, 1000])
        peer_str = ";".join(f"{h}:{p}" for h, p in peers)
        proc = subprocess.run(
            [demo_binary, str(ffi.library_path()), peer_str, str(AID),
             str(MID), str(KID)], capture_output=True, text=True,
            timeout=60)
        assert proc.returncode == 0, \
            f"C demo failed:\n{proc.stdout}\n{proc.stderr}"
        assert "C_DEMO_OK" in proc.stdout
        np.testing.assert_array_equal(
            a1.get(), np.arange(100, 110, dtype=np.float32)
            + np.arange(10, dtype=np.float32))
        np.testing.assert_array_equal(
            m0.get_rows([1, 3, 6]),
            np.arange(1, 10, dtype=np.float32).reshape(3, 3) + 10.0)
        np.testing.assert_array_equal(k0.get([4, 7, 1000000007]),
                                      [1040, 1070, 1007])
    finally:
        svc0.close()
        svc1.close()


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_ctypes_client_bitwise_the_python_client(port_env, updater):
    """The same row Adds (duplicates included) through the C client into
    one pair of shards and through the Python client into another read
    back the same bytes, as do whole-array and KV round trips."""
    rng = np.random.default_rng(5)
    svcs = [tps.PSService() for _ in range(4)]
    a_peers = [s.address for s in svcs[:2]]
    b_peers = [s.address for s in svcs[2:]]
    try:
        py = [tps.DistributedMatrixTable(11, 64, 5, svcs[r], a_peers, r,
                                         updater=updater) for r in range(2)]
        for r in range(2):
            tps.DistributedMatrixTable(11, 64, 5, svcs[2 + r], b_peers, r,
                                       updater=updater)
            tps.DistributedArrayTable(12, 9, svcs[2 + r], b_peers, r)
            tps.DistributedKVTable(13, svcs[2 + r], b_peers, r)
        cli = ffi.CClient(b_peers)
        assert cli.num_servers == 2
        cm = cli.matrix_table(11, 64, 5)
        for _ in range(4):
            ids = rng.integers(0, 64, size=40).astype(np.int32)
            d = rng.normal(size=(40, 5)).astype(np.float32)
            py[1].add_rows(ids, d)
            cm.add_rows(ids, d)
        every = np.arange(64, dtype=np.int32)
        assert cm.get_rows(every).tobytes() == \
            py[0].get_rows(every).tobytes()
        ca = cli.array_table(12, 9)
        ca.add(np.arange(9, dtype=np.float32))
        np.testing.assert_array_equal(ca.get(),
                                      np.arange(9, dtype=np.float32))
        ck = cli.kv_table(13)
        ck.add([2, 5, 2], [10, 20, 30])
        np.testing.assert_array_equal(ck.get([2, 5, 9]), [40, 20, 0])
        cli.close()
    finally:
        for s in svcs:
            s.close()


def test_machine_file_rank_bitwise_jax(tmp_path, port_env):
    """``utils/net_util.py``: the machine file's peers and this host's rank
    as the JAX module gives them (local addresses handed in)."""
    from multiverso_tpu.utils import net_util as jnu
    from multiverso_tpu_torch.utils import net_util as tnu
    path = tmp_path / "machines"
    path.write_text("# cluster\n10.0.0.1:7000\n\n10.0.0.2\n  10.0.0.3:7002 \n")
    import multiverso_tpu as mvj
    mvj.init([])
    try:
        want = jnu.parse_machine_file(str(path))
        assert tnu.parse_machine_file(str(path)) == want
        for ips in (["10.0.0.2"], ["127.0.0.1", "10.0.0.3"]):
            assert tnu.rank_from_machine_file(str(path), ips) == \
                jnu.rank_from_machine_file(str(path), ips)
        with pytest.raises(LookupError):
            tnu.rank_from_machine_file(str(path), ["192.168.1.1"])
    finally:
        mvj.shutdown()


# -- the Zoo's lifecycle (mirrors of tests/test_runtime.py; the collective
# cases are tests/test_torch_collectives.py) --------------------------------
def _zoo_down():
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    if Zoo._instance is not None and Zoo._instance.started:
        Zoo._instance.stop()
    Zoo._reset_for_tests()
    reset_flags()


def test_init_shutdown_cycle_and_flags():
    try:
        assert mvt.init(["prog", "-platform=cpu", "-sync=true",
                         "user_arg"]) == ["prog", "user_arg"]
        from multiverso_tpu_torch.core.zoo import Zoo
        assert Zoo.get().sync_mode
        assert (mvt.rank(), mvt.size(), mvt.num_workers()) == (0, 1, 1)
        assert mvt.num_servers() >= 1 and mvt.is_master_worker()
        assert (mvt.worker_id(), mvt.server_id()) == (0, 0)
        mvt.barrier()
        mvt.shutdown()
        mvt.init(["-platform=cpu"])        # restartable
    finally:
        _zoo_down()


def test_roles_ma_mode_and_aggregate():
    from multiverso_tpu_torch.utils.log import FatalError
    try:
        with pytest.raises(FatalError):
            mvt.create_table(mvt.ArrayTableOption(size=10))   # before init
        mvt.init(["-platform=cpu", "-ps_role=none"])
        assert (mvt.worker_id(), mvt.server_id()) == (-1, -1)
        mvt.shutdown()
        mvt.init(["-platform=cpu", "-ps_role=default", "-ma=true"])
        with pytest.raises(FatalError):
            mvt.create_table(mvt.ArrayTableOption(size=10))
        np.testing.assert_array_equal(
            mvt.aggregate(np.ones(16, np.float32)), np.ones(16) * mvt.size())
    finally:
        _zoo_down()


def test_finish_train_api():
    """``mv.finish_train`` releases the calling worker from every BSP
    table, so a worker with more rounds finishes; a process without a
    worker releases nothing."""
    try:
        mvt.init(["-platform=cpu", "-sync=true"], num_local_workers=2)
        t = mvt.create_table(mvt.ArrayTableOption(size=4))
        d = np.ones(4, dtype=np.float32)

        def short():
            t.add(d, mvt.AddOption(worker_id=0))
            t.get(mvt.GetOption(worker_id=0))
            mvt.finish_train(0)

        def long():
            for _ in range(3):
                t.add(d, mvt.AddOption(worker_id=1))
                t.get(mvt.GetOption(worker_id=1))

        th = [threading.Thread(target=short), threading.Thread(target=long)]
        for x in th:
            x.start()
        for x in th:
            x.join(timeout=30)
            assert not x.is_alive()
        mvt.shutdown()
        mvt.init(["-platform=cpu", "-ps_role=server", "-sync=true"],
                 num_local_workers=2)
        t = mvt.create_table(mvt.ArrayTableOption(size=4))
        mvt.finish_train()             # no local worker: a no-op
        assert t._sync._adds.value(0) != float("inf")
    finally:
        _zoo_down()
