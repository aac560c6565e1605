"""Port parity: ``parallel/async_engine.py`` (``AsyncTableEngine``,
``WorkerPool``) on the CPU.

Mirrors ``tests/test_async_engine.py`` (its engine cases; the native
queue, waiter and buffer cases are in ``test_torch_runtime.py``) and holds
the engine against the JAX package's: the same staged Adds, drained
single-threaded, leave bitwise the same table, for a default table and a
``use_pallas`` sgd one (B2's plain version), by rows and dense; the
stateful bypass applies each Add as it comes, bitwise the table's own
Adds.
"""

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj
from multiverso_tpu.parallel.async_engine import \
    AsyncTableEngine as JAsyncTableEngine

mv = AsyncTableEngine = WorkerPool = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mv, AsyncTableEngine, WorkerPool
    _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel.async_engine import (
        AsyncTableEngine, WorkerPool)


@pytest.fixture
def mv_env():
    mv.init(["-platform=cpu"])
    yield mv
    mv.shutdown()
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    Zoo._reset_for_tests()
    reset_flags()


@pytest.fixture
def both(mv_env):
    mvj.init([], devices=jax.devices()[:1])
    yield
    mvj.shutdown()


@pytest.mark.parametrize("updater,use_pallas", [("default", False),
                                                ("sgd", False),
                                                ("sgd", True),
                                                ("default", True)])
def test_staged_matrix_bitwise_jax(both, updater, use_pallas):
    rng = np.random.default_rng(7)
    tables = [pkg.create_table(pkg.MatrixTableOption(
        num_row=500, num_col=6, updater=updater, use_pallas=use_pallas))
        for pkg in (mvj, mv)]
    engines = [JAsyncTableEngine(tables[0], flush_pending=7),
               AsyncTableEngine(tables[1], flush_pending=7)]
    for _ in range(20):
        ids = rng.integers(0, 500, size=64).astype(np.int32)
        d = rng.normal(size=(64, 6)).astype(np.float32)
        for e in engines:
            e.add_rows_async(ids, d)
    every = np.arange(500)
    got = [np.asarray(e.get_rows(every)) for e in engines]
    assert got[0].tobytes() == got[1].tobytes()
    assert engines[1].pending == 0


def test_staged_array_bitwise_jax(both):
    rng = np.random.default_rng(8)
    tables = [pkg.create_table(pkg.ArrayTableOption(size=333, updater="sgd"))
              for pkg in (mvj, mv)]
    engines = [JAsyncTableEngine(tables[0], flush_pending=5),
               AsyncTableEngine(tables[1], flush_pending=5)]
    for _ in range(12):
        d = rng.normal(size=333).astype(np.float32)
        for e in engines:
            e.add_async(d)
    got = [np.asarray(e.get()) for e in engines]
    assert got[0].tobytes() == got[1].tobytes()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_stateful_bypass_bitwise_direct_adds(mv_env, use_pallas):
    """AdaGrad bypasses staging: the engine's Adds are the table's own."""
    rng = np.random.default_rng(9)
    opt = mv.AddOption(learning_rate=0.1, rho=0.1)
    via, direct = (mv.create_table(mv.MatrixTableOption(
        num_row=200, num_col=4, updater="adagrad", use_pallas=use_pallas))
        for _ in range(2))
    eng = AsyncTableEngine(via)
    for _ in range(6):
        ids = rng.integers(0, 200, size=50).astype(np.int32)
        d = rng.normal(size=(50, 4)).astype(np.float32)
        eng.add_rows_async(ids, d, opt)
        assert eng.pending == 0
        direct.add_rows(ids, d, opt)
    every = np.arange(200)
    assert eng.get_rows(every).tobytes() == direct.get_rows(every).tobytes()


def test_async_staged_array(mv_env):
    table = mv.create_table(mv.ArrayTableOption(size=32))
    eng = AsyncTableEngine(table, flush_pending=1000)
    d = np.ones(32, dtype=np.float32)
    for _ in range(10):
        eng.add_async(d)
    assert eng.pending == 10
    out = eng.get()
    np.testing.assert_array_equal(out, d * 10)
    assert eng.pending == 0


def test_async_staged_matrix_sparse_drain(mv_env):
    table = mv.create_table(mv.MatrixTableOption(num_row=1000, num_col=8))
    eng = AsyncTableEngine(table, flush_pending=1000)
    rows = np.array([3, 500, 999], dtype=np.int32)
    d = np.ones((3, 8), dtype=np.float32)
    for _ in range(5):
        eng.add_rows_async(rows, d)
    np.testing.assert_array_equal(eng.get_rows(rows), d * 5)
    assert np.all(eng.get_rows([0, 1, 2]) == 0)


def test_async_auto_flush_threshold(mv_env):
    table = mv.create_table(mv.ArrayTableOption(size=8))
    eng = AsyncTableEngine(table, flush_pending=4)
    d = np.ones(8, dtype=np.float32)
    for _ in range(4):
        eng.add_async(d)
    assert eng.pending == 0
    np.testing.assert_array_equal(table.get(), d * 4)


def test_async_stateful_updater_bypasses_staging(mv_env):
    table = mv.create_table(mv.ArrayTableOption(size=4, updater="adagrad"))
    eng = AsyncTableEngine(table)
    eng.add_async(np.ones(4, dtype=np.float32),
                  mv.AddOption(rho=0.1, learning_rate=0.1))
    assert eng.pending == 0
    assert np.all(eng.get() < 0)


def test_worker_pool_asgd_convergence(mv_env):
    table = mv.create_table(mv.ArrayTableOption(size=16))
    eng = AsyncTableEngine(table, flush_pending=32)
    pool = WorkerPool(8)

    def work(wid):
        d = np.full(16, float(wid + 1), dtype=np.float32)
        for _ in range(50):
            eng.add_async(d)

    pool.run(work)
    expected = sum(w + 1 for w in range(8)) * 50
    np.testing.assert_array_equal(eng.get(), np.full(16, float(expected)))


def test_worker_pool_propagates_errors(mv_env):
    with pytest.raises(ValueError):
        WorkerPool(2).run(
            lambda wid: (_ for _ in ()).throw(ValueError("boom")))


def test_background_flusher(mv_env):
    import time
    table = mv.create_table(mv.ArrayTableOption(size=8))
    eng = AsyncTableEngine(table, flush_pending=10_000, flush_interval=0.05)
    eng.add_async(np.ones(8, dtype=np.float32))
    for _ in range(100):
        if eng.pending == 0:
            break
        time.sleep(0.02)
    assert eng.pending == 0
    np.testing.assert_array_equal(table.get(), np.ones(8, np.float32))
    eng.close()


def test_async_engine_rejects_sparse_and_bf16_tables(mv_env):
    from multiverso_tpu_torch.utils.log import FatalError
    t = mv.create_table(mv.MatrixTableOption(num_row=4, num_col=2,
                                             is_sparse=True))
    with pytest.raises(FatalError):
        AsyncTableEngine(t)
    b = mv.create_table(mv.MatrixTableOption(num_row=4, num_col=2,
                                             dtype="bfloat16"))
    with pytest.raises(FatalError):
        AsyncTableEngine(b)
