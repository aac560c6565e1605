"""Port parity: the reference perf harness's Get/Add/Get coverage sweep
(``Test/test_matrix_perf.cpp:32-80``), mirroring
``tests/test_matrix_perf_port.py``.

Get-all, then a row Add at 10%, 50% and 100% row coverage, then Gets of
the touched rows and of the whole table, on a 10,000 x 50 table. Each
read is held BITWISE against the JAX package's table on the CPU fed the
same numpy inputs, and against the numpy model. The port's table runs
with and without the row kernels (``use_pallas``: B1 and B2's plain
versions here); the ids of one Add are unique, so B2's group folds add
one delta to each row, as XLA's scatter does.
"""

import numpy as np
import pytest

import jax

import _torch_port
import multiverso_tpu as mvj

torch = mvt = None   # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, mvt
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt


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
    yield
    mvt.shutdown()
    mvj.shutdown()


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "use_pallas"])
@pytest.mark.parametrize("coverage", [0.1, 0.5, 1.0])
def test_get_add_get_sweep_bitwise(both, coverage, use_pallas):
    from multiverso_tpu_torch.utils.timer import Timer
    num_row, num_col = 10_000, 50
    tj = mvj.create_table(mvj.MatrixTableOption(num_row, num_col))
    tt = mvt.create_table(mvt.MatrixTableOption(num_row, num_col,
                                                use_pallas=use_pallas))
    assert tt.store._pallas_rows == use_pallas
    model = np.zeros((num_row, num_col), dtype=np.float32)
    rng = np.random.default_rng(int(coverage * 10))
    timer = Timer()
    assert np.array_equal(_u32(tt.get()), _u32(tj.get()))       # cold
    n_rows = int(num_row * coverage)
    rows = rng.choice(num_row, size=n_rows, replace=False)
    deltas = rng.normal(size=(n_rows, num_col)).astype(np.float32)
    tj.add_rows(rows, deltas)
    tt.add_rows(rows, deltas)
    model[rows] += deltas
    probe = rows[:100]
    got = tt.get_rows(probe)
    assert np.array_equal(_u32(got), _u32(tj.get_rows(probe)))
    assert np.array_equal(_u32(got), _u32(model[probe]))
    whole = tt.get()
    assert np.array_equal(_u32(whole), _u32(tj.get()))
    assert np.array_equal(_u32(whole), _u32(model))
    # A second Add over the same rows: row + delta twice.
    tj.add_rows(rows, deltas)
    tt.add_rows(rows, deltas)
    assert np.array_equal(_u32(tt.get()), _u32(tj.get()))
    assert timer.elapse() > 0
