"""Port parity: ``SparseMatrixTable`` (per-worker staleness bitmap,
incremental Gets, the writer's cache mirror) on the CPU against the JAX
package.

Mirrors ``tests/test_sparse_matrix_table.py`` case by case: each case
makes the same sequence of Adds and Gets on a JAX table and a port table
and holds the port BITWISE to JAX — stale row sets, values returned,
per-worker caches and bitmaps. The JAX cases run with one local worker
(worker 1 is then an unknown writer, which stales the rows it touches
for everyone); the sequences at the end run two local workers, with and
without the row kernels' plain versions (``use_pallas``).
"""

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj

mvt = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()


def _start(workers):
    mvj.init([], devices=jax.devices()[:1], num_local_workers=workers)
    mvt.init(["-platform=cpu"], num_local_workers=workers)


@pytest.fixture
def both():
    _start(1)
    yield
    mvt.shutdown()
    mvj.shutdown()


@pytest.fixture
def two_workers():
    _start(2)
    yield
    mvt.shutdown()
    mvj.shutdown()


class _Pair:
    def __init__(self, *args, **kw):
        self.j = mvj.create_table(mvj.MatrixTableOption(*args, **kw))
        self.t = mvt.create_table(mvt.MatrixTableOption(*args, **kw))
        assert self.t._mirror == self.j._mirror
        self.same()

    def same(self):
        assert np.array_equal(self.j._stale, self.t._stale)
        assert sorted(self.j._caches) == sorted(self.t._caches)
        for w in self.j._caches:
            assert np.array_equal(self.j._caches[w], self.t._caches[w])

    def add_rows(self, rows, deltas, wid):
        self.j.add_rows(rows, deltas, mvj.AddOption(worker_id=wid))
        self.t.add_rows(rows, deltas, mvt.AddOption(worker_id=wid))
        self.same()

    def add(self, delta, wid):
        self.j.add(delta, mvj.AddOption(worker_id=wid))
        self.t.add(delta, mvt.AddOption(worker_id=wid))
        self.same()

    def get_stale(self, wid):
        jr, jv = self.j.get_stale(mvj.GetOption(worker_id=wid))
        tr, tv = self.t.get_stale(mvt.GetOption(worker_id=wid))
        assert np.array_equal(jr, tr) and np.array_equal(np.asarray(jv), tv)
        self.same()
        return tr, tv

    def get(self, wid):
        want = self.j.get(mvj.GetOption(worker_id=wid))
        got = self.t.get(mvt.GetOption(worker_id=wid))
        assert np.array_equal(want, got)
        self.same()
        return got

    def stale_rows(self, wid):
        want, got = self.j.stale_rows(wid), self.t.stale_rows(wid)
        assert np.array_equal(want, got)
        return got


def _ones(n, c, v=1.0):
    return np.full((n, c), v, dtype=np.float32)


def test_initially_all_rows_stale(both):
    p = _Pair(10, 4, is_sparse=True)
    rows, values = p.get_stale(0)
    assert len(rows) == 10 and np.all(values == 0)
    assert len(p.get_stale(0)[0]) == 0


def test_add_invalidates_other_workers_only(both):
    p = _Pair(10, 4, is_sparse=True)
    p.get_stale(0)
    p.add_rows([2, 3], _ones(2, 4), 0)
    assert len(p.get_stale(0)[0]) == 0


def test_incremental_whole_get_with_cache(both):
    p = _Pair(10, 4, is_sparse=True)
    assert np.all(p.get(0) == 0)
    p.add_rows([5], _ones(1, 4, 7.0), 1)
    expected = np.zeros((10, 4), dtype=np.float32)
    expected[5] = 7.0
    assert np.array_equal(p.get(0), expected)
    p.add_rows([1], _ones(1, 4), 1)
    np.testing.assert_array_equal(p.stale_rows(0), [1])


def test_dense_add_invalidates_everything(both):
    p = _Pair(10, 4, is_sparse=True)
    p.get_stale(0)
    p.add(_ones(10, 4), 1)
    assert len(p.stale_rows(0)) == 10


def test_pipeline_doubles_slots(two_workers):
    p = _Pair(10, 4, is_sparse=True, is_pipeline=True)
    assert p.t._stale.shape[0] == 2 * mvt.num_workers() == 4


def test_restore_marks_all_stale(both, tmp_path):
    from multiverso_tpu.core import checkpoint as jck
    from multiverso_tpu_torch.core import checkpoint as tck
    p = _Pair(10, 4, is_sparse=True, name="sparse")
    p.add_rows([2], _ones(1, 4, 5.0), 1)
    before = p.get(0)
    tck.save_table(p.t, f"file://{tmp_path}/t.npz")
    jck.save_table(p.j, f"file://{tmp_path}/j.npz")
    tck.load_table(p.t, f"file://{tmp_path}/j.npz")
    jck.load_table(p.j, f"file://{tmp_path}/t.npz")
    p.same()
    assert len(p.stale_rows(0)) == 10
    assert np.array_equal(p.get(0), before)


def test_writer_sees_own_unpulled_write_plain_add(both):
    p = _Pair(8, 2, is_sparse=True, name="own_write")
    p.add_rows([3], _ones(1, 2), 0)
    got = p.get(0)
    assert np.all(got[3] == 1.0) and np.all(got[0] == 0.0)


def test_stateful_updater_uses_reference_loose_freshness(both):
    p = _Pair(8, 2, is_sparse=True, updater="sgd", name="sgd_loose")
    assert not p.t._mirror
    p.add_rows([2], _ones(1, 2), 0)
    assert np.all(p.get(0)[2] == -1.0)
    p.add_rows([2], _ones(1, 2), 0)
    assert np.all(p.get(0)[2] == -1.0)          # last-pull view
    p.add_rows([2], _ones(1, 2), 1)
    assert np.all(p.get(0)[2] == -3.0)


def test_random_init_unpulled_write_ships_truth(both):
    p = _Pair(6, 2, is_sparse=True, random_init=True, seed=5,
              name="rand_sparse")
    p.add_rows([3], _ones(1, 2), 0)
    got = p.get(0)
    assert np.array_equal(got[3], p.t.get_rows([3])[0])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("updater", ["default", "sgd"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_two_worker_sequences_bitwise(two_workers, updater, use_pallas,
                                      pipeline):
    """Random row Adds (duplicates, both writers, a dense Add) between
    incremental Gets of both workers: every stale set, value and cache
    is JAX's."""
    rng = np.random.default_rng(9)
    p = _Pair(40, 6, is_sparse=True, updater=updater, use_pallas=use_pallas,
              is_pipeline=pipeline, random_init=True, seed=3)
    for step in range(8):
        ids = rng.integers(0, 40, size=12).astype(np.int32)
        ids[:3] = ids[3]
        p.add_rows(ids, rng.normal(size=(12, 6)).astype(np.float32),
                   step % 2)
        if step == 4:
            p.add(rng.normal(size=(40, 6)).astype(np.float32), 1)
        p.get(step % 3 % 2)
        p.get_stale(1)
    p.get(0)
    p.get(1)
