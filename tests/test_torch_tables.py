"""Port parity: the PS table plane (Array/Matrix/KV tables over
``ServerStore``) on the CPU against the JAX package on one CPU device.

The same seeds and operations go to both. Tolerances: BITWISE for
random init, gets and the stateless row Adds (the JAX XLA scatter and the
Pallas interpret kernel both add duplicates in sorted/lane order, as the
port's plain versions do) and for carried-over payloads; rtol 2e-6 for the
stateful dense Adds, which the JAX store runs under ``jax.jit`` (see
``tests/test_torch_updaters.py`` for the measured difference).
"""

import numpy as np
import pytest

import jax

import _torch_port
import multiverso_tpu as mvj

mvt = interop = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, interop
    _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch import interop


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import reset_flags
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    Dashboard.reset()
    reset_telemetry()


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield mvj, mvt
    mvt.shutdown()
    mvj.shutdown()


def _row_ops(rng, rows, cols, n_ops=3, n=20):
    ops = []
    for _ in range(n_ops):
        ids = rng.integers(0, rows, size=n).astype(np.int32)
        ids[:4] = ids[4]                  # a duplicate run in every op
        ops.append((ids, rng.normal(size=(n, cols)).astype(np.float32)))
    return ops


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_matrix_rows_bitwise(both, updater, use_pallas):
    mvj, mvt = both
    opt = dict(random_init=True, seed=7, updater=updater,
               use_pallas=use_pallas)
    tj = mvj.create_table(mvj.MatrixTableOption(48, 16, **opt))
    tt = mvt.create_table(mvt.MatrixTableOption(48, 16, **opt))
    assert tt.store._pallas_rows == tj.store._pallas_rows == use_pallas
    assert np.array_equal(tj.get(), tt.get())          # same random init
    for ids, deltas in _row_ops(np.random.default_rng(1), 48, 16):
        tj.add_rows(ids, deltas)
        tt.add_rows(ids, deltas)
    probe = [0, 5, 47, 5, 12]
    assert np.array_equal(tj.get_rows(probe), tt.get_rows(probe))
    assert np.array_equal(tj.get(), tt.get())
    assert np.array_equal(tj.get_row(47), tt.get_row(47))


@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd",
                                     "adagrad", "ftrl"])
def test_array_dense_adds(both, updater):
    mvj, mvt = both
    tj = mvj.create_table(mvj.ArrayTableOption(size=10, updater=updater))
    tt = mvt.create_table(mvt.ArrayTableOption(size=10, updater=updater))
    rng = np.random.default_rng(2)
    for _ in range(3):
        d = rng.normal(size=10).astype(np.float32)
        kw = dict(momentum=0.5, learning_rate=0.1, rho=0.2, lambda_=0.01)
        tj.add(d, mvj.AddOption(**kw))
        tt.add(d, mvt.AddOption(**kw))
    np.testing.assert_allclose(tt.get(), tj.get(), rtol=2e-6, atol=1e-7)
    assert tt.partition(tt.get()).keys() == tj.partition(tj.get()).keys()


def test_matrix_dense_add_and_kv(both):
    mvj, mvt = both
    tj = mvj.create_table(mvj.MatrixTableOption(6, 3))
    tt = mvt.create_table(mvt.MatrixTableOption(6, 3))
    d = np.arange(18, dtype=np.float32).reshape(6, 3)
    tj.add(d)
    tt.add(d)
    assert np.array_equal(tj.get(), tt.get())
    kj = mvj.create_table(mvj.KVTableOption(value_dtype=np.int64))
    kt = mvt.create_table(mvt.KVTableOption(value_dtype=np.int64))
    for k, v in (([0, 5], [3, 4]), ([5, 9], [1, 1])):
        kj.add(k, v)
        kt.add(k, v)
    assert np.array_equal(kj.get([0, 5, 9, 2]), kt.get([0, 5, 9, 2]))
    assert kt.raw() == kj.raw()


def test_store_payload_carries_over(both):
    """A JAX store_state() payload loads into the port's store (interop)
    and the port writes the same payload format back."""
    mvj, mvt = both
    tj = mvj.create_table(mvj.ArrayTableOption(size=8, updater="adagrad"))
    tj.add(np.linspace(-1, 1, 8).astype(np.float32),
           mvj.AddOption(learning_rate=0.1, rho=0.2))
    payload = tj.store.store_state()
    tt = mvt.create_table(mvt.ArrayTableOption(size=8, updater="adagrad"))
    interop.load_store_payload(tt.store, payload)
    back = tt.store.store_state()
    assert sorted(back) == sorted(payload) == ["data", "state/g2"]
    for k in payload:
        assert np.array_equal(back[k], np.asarray(payload[k]))
    d = np.full(8, 0.05, np.float32)
    tj.add(d, mvj.AddOption(learning_rate=0.1, rho=0.2))
    tt.add(d, mvt.AddOption(learning_rate=0.1, rho=0.2))
    np.testing.assert_allclose(tt.get(), tj.get(), rtol=2e-6, atol=1e-7)
    with pytest.raises(Exception):
        interop.load_store_payload(tt.store, {"data": np.zeros(3)})


def test_port_table_surface_and_waits():
    mvt.init(["-platform=cpu"], num_local_workers=2, sync=True)
    assert (mvt.rank(), mvt.size(), mvt.num_workers(), mvt.num_servers(),
            mvt.worker_id(), mvt.is_master_worker()) == (0, 1, 2, 1, 0, True)
    t = mvt.create_table(mvt.MatrixTableOption(8, 4, updater="adagrad",
                                               use_pallas=True))
    assert t._sync is not None                    # BSP clocks for 2 workers
    mvt.finish_train(1)                           # retire the idle worker
    assert t.store._pallas_cap == "fused_stateful"   # CPU: plain row math
    t.add_rows([1, 1], np.ones((2, 4), np.float32),
               mvt.AddOption(learning_rate=0.1, rho=0.1))
    assert t.get()[1, 0] < 0
    part = t.partition([0, 7])
    assert list(part) == [0] and part[0].tolist() == [0, 7]
    ints = mvt.create_table(mvt.MatrixTableOption(4, 4, dtype=np.int32,
                                                  use_pallas=True))
    assert not ints.store._pallas_rows            # f32 tables only
    assert np.array_equal(mvt.aggregate([1, 2]), [1, 2])
    # The sparse matrix and device KV tables are ported (A4).
    from multiverso_tpu_torch.tables.device_kv_table import DeviceKVTable
    from multiverso_tpu_torch.tables.sparse_matrix_table import \
        SparseMatrixTable
    assert isinstance(mvt.create_table(
        mvt.MatrixTableOption(4, 4, is_sparse=True)), SparseMatrixTable)
    assert isinstance(mvt.create_table(mvt.KVTableOption(device=True)),
                      DeviceKVTable)
    # A concrete comm policy is taken as resolved; "auto" runs the
    # measured probe: a small dense table takes the plane it measured
    # faster, a sparse-shaped one stays on ps unprobed.
    from multiverso_tpu_torch.parallel import comm_policy as cp
    assert mvt.create_table(mvt.MatrixTableOption(
        4, 4, comm_policy="allreduce")).comm_policy == "allreduce"
    small = mvt.create_table(mvt.MatrixTableOption(4, 4, comm_policy="auto"))
    from multiverso_tpu_torch.core.zoo import Zoo
    lat = cp.measured_policy_latency_ms(64, Zoo.get().mesh, world=1)
    assert small.comm_policy == (cp.PS if lat[cp.PS] < lat[cp.ALLREDUCE]
                                 else cp.ALLREDUCE)
    assert mvt.create_table(mvt.MatrixTableOption(
        cp.SPARSE_ROWS_MIN, 2, comm_policy="auto")).comm_policy == cp.PS
    # The PS service is ported: a one-rank world over it.
    host, port = mvt.net_bind()
    mvt.net_connect([(host, port)])
    dist = mvt.create_distributed_matrix_table(0, 4, 4, 0)
    dist.add_rows([1, 1], np.ones((2, 4), np.float32))
    assert dist.get_rows([1]).tolist() == [[2.0] * 4]
    mvt.set_flag("state_sharding", "on")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        mvt.create_table(mvt.MatrixTableOption(4, 4, updater="adagrad"))
    mvt.shutdown()
    # -coordinator starts a process group: here a world of one rank.
    from multiverso_tpu_torch.utils.configure import reset_flags
    reset_flags()
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mvt.init(["-platform=cpu", f"-coordinator=127.0.0.1:{port}"])
    import torch.distributed as dist
    assert dist.is_initialized() and (mvt.rank(), mvt.size()) == (0, 1)
    mvt.barrier()
    assert np.array_equal(mvt.aggregate(np.arange(3.0)), np.arange(3.0))
    mvt.shutdown()
    assert not dist.is_initialized()


STATEFUL = ["momentum_sgd", "adagrad", "ftrl"]


@pytest.mark.parametrize("updater", STATEFUL)
def test_stateful_pallas_table_random_ops_bitwise(updater):
    """A ``use_pallas`` stateful table (combine, then the fused row
    kernel's plain version) against a table of the same updater without
    it, over a random sequence of row Adds (with duplicates), dense Adds
    and Gets: data and every state leaf bitwise (mirrors
    ``tests/test_fuzz_semantics.py``'s random op sequences)."""
    mvt.init(["-platform=cpu"], num_local_workers=2)
    rng = np.random.default_rng(0)
    R, C = 37, 5
    t_pal = mvt.create_table(mvt.MatrixTableOption(R, C, updater=updater,
                                                   use_pallas=True))
    t_ref = mvt.create_table(mvt.MatrixTableOption(R, C, updater=updater))
    assert t_pal.store._pallas_cap == "fused_stateful"
    assert not t_ref.store._pallas_rows
    for _ in range(40):
        op = rng.integers(0, 4)
        opt = mvt.AddOption(worker_id=int(rng.integers(0, 2)),
                            momentum=0.7, learning_rate=0.05, rho=0.1,
                            lambda_=0.01)
        if op == 0:
            delta = rng.normal(size=(R, C)).astype(np.float32)
            t_pal.add(delta, opt)
            t_ref.add(delta, opt)
        elif op == 1:
            n = int(rng.integers(0, 12))
            ids = rng.integers(0, R, size=n)
            deltas = rng.normal(size=(n, C)).astype(np.float32)
            t_pal.add_rows(ids, deltas, opt)
            t_ref.add_rows(ids, deltas, opt)
        elif op == 2:
            ids = rng.integers(0, R, size=6)
            assert np.array_equal(t_pal.get_rows(ids), t_ref.get_rows(ids))
        else:
            assert np.array_equal(t_pal.get(), t_ref.get())
    got, want = t_pal.store.store_state(), t_ref.store.store_state()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), (updater, k)
    mvt.shutdown()


@pytest.mark.parametrize("updater", STATEFUL)
def test_stateful_payload_into_pallas_table(both, updater):
    """A JAX store payload of a stateful updater (data + ``state/<leaf>``)
    loads into a ``use_pallas`` port table through ``interop``; one further
    row Add matches the JAX package's pieces (combine, ``rows_math``) run
    eagerly on the same payload, bitwise, data and every leaf."""
    from multiverso_tpu.core import updater as jupd
    import jax.numpy as jnp
    mvj, mvt = both
    R, C = 24, 6
    tj = mvj.create_table(mvj.MatrixTableOption(R, C, updater=updater))
    rng = np.random.default_rng(4)
    kw = dict(momentum=0.6, learning_rate=0.05, rho=0.2, lambda_=0.01)
    for _ in range(2):     # the JAX store's dense Add (its row Add: C1)
        tj.add(rng.normal(size=(R, C)).astype(np.float32),
               mvj.AddOption(**kw))
    payload = {k: np.asarray(v) for k, v in tj.store.store_state().items()}
    tt = mvt.create_table(mvt.MatrixTableOption(R, C, updater=updater,
                                                use_pallas=True))
    assert tt.store._pallas_cap == "fused_stateful"
    interop.load_store_payload(tt.store, payload)
    ids = np.array([3, 9, 3, 23, 0, 9, 3], np.int32)
    deltas = rng.normal(size=(len(ids), C)).astype(np.float32)
    opt = mvt.AddOption(**kw)
    tt.add_rows(ids, deltas, opt)
    # The JAX pieces on the payload.
    up = jupd._REGISTRY[updater]()
    r_eff, d_c = jupd.combine_duplicate_rows(jnp.asarray(ids),
                                             jnp.asarray(deltas), R)
    r_eff = np.asarray(r_eff)
    keep = r_eff < R
    clip = np.minimum(r_eff, R - 1)
    wid = opt.worker_id
    want = {k: v.copy() for k, v in payload.items()}
    planes = {k[len("state/"):]: (v[wid] if k[len("state/"):] in
                                  up.per_worker_state else v)
              for k, v in want.items() if k != "data"}
    nd, ns = up.rows_math(jnp.asarray(want["data"][clip]),
                          {k: jnp.asarray(p[clip]) for k, p in planes.items()},
                          d_c, opt.scalars())
    want["data"][r_eff[keep]] = np.asarray(nd)[keep]
    for k, p in planes.items():
        p[r_eff[keep]] = np.asarray(ns[k])[keep]
    got = tt.store.store_state()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), (updater, k)


def test_distributed_tables_match_model():
    """Mirror of ``tests/test_fuzz_semantics.py::
    test_distributed_tables_match_model``: random routed row traffic from
    both ranks of the port's PS service equals a numpy model (the JAX
    test's tolerance, rtol 1e-4 / atol 1e-5)."""
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedMatrixTable, PSService)
    mvt.init(["-platform=cpu"])
    svc0, svc1 = PSService(), PSService()
    try:
        rng = np.random.default_rng(2)
        R, C = 31, 4
        peers = [svc0.address, svc1.address]
        t0 = DistributedMatrixTable(11, R, C, svc0, peers, rank=0)
        t1 = DistributedMatrixTable(11, R, C, svc1, peers, rank=1)
        model = np.zeros((R, C), dtype=np.float32)
        tables = [t0, t1]
        for _ in range(40):
            t = tables[int(rng.integers(0, 2))]
            n = int(rng.integers(1, 6))
            rows = rng.integers(0, R, size=n)
            deltas = rng.normal(size=(n, C)).astype(np.float32)
            t.add_rows(rows, deltas)
            np.add.at(model, rows, deltas)
        all_rows = np.arange(R, dtype=np.int32)
        np.testing.assert_allclose(t0.get_rows(all_rows), model,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t1.get_rows(all_rows), model,
                                   rtol=1e-4, atol=1e-5)
    finally:
        svc0.close()
        svc1.close()
        mvt.shutdown()


def test_distributed_kv_and_sparse_fuzz_match_model():
    """Mirror of ``tests/test_fuzz_semantics.py::
    test_distributed_kv_and_sparse_fuzz_match_model``: hash-routed KV
    adds equal a dict model exactly (int64); sparse incremental gets
    converge to the dense numpy model after every pull, with the rows
    shipped bounded by the rows touched since that worker's last pull."""
    from multiverso_tpu_torch.core.options import AddOption, GetOption
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedKVTable, DistributedSparseMatrixTable, PSService)
    mvt.init(["-platform=cpu"])
    svc0, svc1 = PSService(), PSService()
    try:
        rng = np.random.default_rng(7)
        peers = [svc0.address, svc1.address]
        kv0 = DistributedKVTable(21, svc0, peers, rank=0)
        kv1 = DistributedKVTable(21, svc1, peers, rank=1)
        R, C = 23, 3
        sp0 = DistributedSparseMatrixTable(22, R, C, svc0, peers, rank=0)
        sp1 = DistributedSparseMatrixTable(22, R, C, svc1, peers, rank=1)
        kv_model: dict = {}
        sp_model = np.zeros((R, C), dtype=np.float32)
        kvs, sps = [kv0, kv1], [sp0, sp1]
        touched_since = [0, 0]
        pulled_once = [False, False]
        for step in range(60):
            r = int(rng.integers(0, 2))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                n = int(rng.integers(1, 5))
                keys = rng.integers(0, 50, size=n).astype(np.int64)
                vals = rng.integers(-100, 100, size=n).astype(np.int64)
                kvs[r].add(keys, vals)
                for k, v in zip(keys.tolist(), vals.tolist()):
                    kv_model[k] = kv_model.get(k, 0) + v
            elif kind == 1:
                n = int(rng.integers(1, 4))
                rows = np.unique(rng.integers(0, R, size=n))
                deltas = rng.normal(size=(len(rows), C)).astype(np.float32)
                sps[r].add_rows(rows, deltas, AddOption(worker_id=0))
                np.add.at(sp_model, rows, deltas)
                touched_since = [t + len(rows) for t in touched_since]
            else:
                got = sps[r].get(GetOption(worker_id=0))
                np.testing.assert_allclose(got, sp_model, rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"step {step} rank {r}")
                bound = R if not pulled_once[r] \
                    else min(touched_since[r], R)
                assert sps[r].last_incremental_rows <= bound
                pulled_once[r] = True
                touched_since[r] = 0
        keys = np.asarray(sorted(kv_model), dtype=np.int64)
        want = np.asarray([kv_model[int(k)] for k in keys])
        np.testing.assert_array_equal(kv0.get(keys), want)
        np.testing.assert_array_equal(kv1.get(keys), want)
    finally:
        svc0.close()
        svc1.close()
        mvt.shutdown()
