"""Port parity: bfloat16 tables on the CPU against the JAX package.

The JAX package stores a bfloat16 table as ``jnp.bfloat16`` and returns
``ml_dtypes.bfloat16`` arrays; the port stores ``torch.bfloat16`` and
returns float32, an exact widening. So every comparison here is BITWISE
on the uint16 patterns (the port's float32 read rounded back to bfloat16
is exact). Covered: the numpy-seeded random init, dense Adds, and row
Adds with duplicate rows (XLA folds each row's duplicates in lane order
with a rounding after every add; ``index_add_`` does not), for the
default and sgd updaters; the store payload; and the stateful updaters'
tables (ROADMAP A13; their parity is ``test_torch_bf16_updaters.py``).
"""

import numpy as np
import pytest

import jax

import _torch_port
import multiverso_tpu as mvj

torch = mvt = None  # set by _load_port


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
    yield mvj, mvt
    mvt.shutdown()
    mvj.shutdown()


def bits(a) -> np.ndarray:
    """uint16 patterns of a bfloat16 array, or of float32 values that are
    exactly bfloat16 (the port's reads)."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        t = torch.as_tensor(a)
        assert torch.equal(t.bfloat16().float(), t), "not bfloat16 values"
        return t.bfloat16().view(torch.int16).numpy().view(np.uint16)
    return a.view(np.uint16)


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_matrix_table_bitwise(both, updater):
    mvj, mvt = both
    rows, cols = 40, 12
    opt = dict(random_init=True, seed=3, updater=updater,
               init_low=-0.5, init_high=0.5)
    tj = mvj.create_table(mvj.MatrixTableOption(
        rows, cols, dtype=jax.numpy.bfloat16, **opt))
    tt = mvt.create_table(mvt.MatrixTableOption(rows, cols, dtype="bfloat16",
                                                **opt))
    assert tt.store.data.dtype == torch.bfloat16
    assert tt.get().dtype == np.float32
    assert np.array_equal(bits(tj.get()), bits(tt.get()))     # init
    rng = np.random.default_rng(5)
    for step in range(4):
        # Row Adds with long duplicate runs: small deltas onto one row
        # round differently in every order.
        ids = rng.integers(0, rows, size=300).astype(np.int32)
        ids[:60] = 7
        deltas = (rng.normal(size=(300, cols)) * 10.0 ** -step) \
            .astype(np.float32)
        tj.add_rows(ids, deltas)
        tt.add_rows(ids, deltas)
        dense = (rng.normal(size=(rows, cols)) * 1e-2).astype(np.float32)
        tj.add(dense)
        tt.add(dense)
        assert np.array_equal(bits(tj.get()), bits(tt.get())), step
    probe = [0, 7, 39, 7, 3]
    assert np.array_equal(bits(tj.get_rows(probe)), bits(tt.get_rows(probe)))
    # The payload widens exactly and loads back bit for bit.
    payload = tt.store.store_state()
    assert payload["data"].dtype == np.float32
    fresh = mvt.create_table(mvt.MatrixTableOption(rows, cols,
                                                   dtype="bfloat16",
                                                   updater=updater))
    fresh.store.load_state(payload)
    assert torch.equal(fresh.store.data.view(torch.int16),
                       tt.store.data.view(torch.int16))


def test_index_add_is_not_the_jax_fold(both):
    """The premise of the lane-order fold: ``index_add_`` on a bfloat16
    table differs from XLA's scatter on these inputs, and
    ``add_rows_lane_order`` equals it bitwise."""
    from multiverso_tpu_torch.ops.rows import add_rows_lane_order
    jnp = jax.numpy
    rng = np.random.default_rng(0)
    w = rng.normal(size=(20, 8)).astype(np.float32)
    ids = rng.integers(0, 22, 4000)                  # 20, 21 are dropped
    step = (rng.normal(size=(4000, 8)) * 0.05).astype(np.float32)
    want = np.asarray(jnp.asarray(w, jnp.bfloat16).at[ids].add(
        jnp.asarray(step).astype(jnp.bfloat16), mode="drop"))
    got = add_rows_lane_order(torch.as_tensor(w).bfloat16(),
                              torch.as_tensor(ids), torch.as_tensor(step))
    assert np.array_equal(bits(want), bits(got.float().numpy()))
    keep = ids < 20
    naive = torch.as_tensor(w).bfloat16().index_add_(
        0, torch.as_tensor(ids[keep]), torch.as_tensor(step[keep]).bfloat16())
    assert not np.array_equal(bits(want), bits(naive.float().numpy()))


def test_dtype_is_read_by_name(both):
    """A numpy dtype named bfloat16 (the JAX package's) and the string
    give the same table; every stateful updater runs on it (ROADMAP A13),
    with the state leaves in the JAX ``init_state`` dtypes, and a
    ``use_pallas`` one takes the plain route."""
    _, mvt = both
    a = mvt.create_table(mvt.MatrixTableOption(4, 3, dtype="bfloat16"))
    b = mvt.create_table(mvt.MatrixTableOption(
        4, 3, dtype=np.dtype(jax.numpy.bfloat16)))
    assert a.store.torch_dtype == b.store.torch_dtype == torch.bfloat16
    assert not a.store._pallas_rows
    c = mvt.create_table(mvt.MatrixTableOption(4, 3, dtype="bfloat16",
                                               use_pallas=True))
    assert not c.store._pallas_rows       # the row kernels take float32
    leaf_dtypes = {"momentum_sgd": {"smooth": torch.bfloat16},
                   "adagrad": {"g2": torch.float32},
                   "ftrl": {"z": torch.float32, "n": torch.float32},
                   "dcasgd": {"backup": torch.float32},
                   "dcasgda": {"backup": torch.float32, "m": torch.float32}}
    for updater, leaves in leaf_dtypes.items():
        for use_pallas in (False, True):
            t = mvt.create_table(mvt.MatrixTableOption(
                4, 3, dtype="bfloat16", updater=updater,
                use_pallas=use_pallas))
            assert t.store.torch_dtype == torch.bfloat16
            assert not t.store._pallas_rows, updater
            assert {k: v.dtype for k, v in t.store.state.items()} == leaves
            t.add_rows([1, 1, 3], np.ones((3, 3), np.float32),
                       mvt.AddOption(learning_rate=0.1, rho=0.1))
            assert np.isfinite(t.get()).all() and (t.get()[[0, 2]] == 0).all()
