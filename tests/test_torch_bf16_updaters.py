"""Port parity: the stateful updaters on bfloat16 tables (ROADMAP A13).

The JAX package runs momentum_sgd, adagrad, ftrl, dcasgd and dcasgda on a
bfloat16 table: momentum keeps ``smooth`` in bfloat16, the others keep
float32 state leaves and round their float32 step or result to bfloat16.
A row Add first combines duplicate ids: XLA's bfloat16 ``segment_sum``
folds each run in lane order with a rounding after every add.

Everything here is BITWISE, on uint16 patterns for bfloat16 and uint32
for float32, against the JAX functions run eagerly: ``update_dense``,
``rows_math`` and ``combine_duplicate_rows`` (the JAX store's own row Add
raises on this tree's jax, ROADMAP C1, so its pieces are the oracle). The
sizes are realistic enough (hundreds of rows) that a one-ulp slip in a
square root or a rounding shows.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import _torch_port
from multiverso_tpu.core import updater as jupd

torch = tupd = mvt = None   # set by _load_port

STATEFUL = ["momentum_sgd", "adagrad", "ftrl", "dcasgd", "dcasgda"]
ROWS, COLS, WORKERS = 300, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, tupd, mvt
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.core import updater as tupd
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


def _bits(x) -> np.ndarray:
    """Bit patterns of a JAX array, a numpy array or a torch tensor:
    uint16 for bfloat16, uint32 for float32."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _opts():
    from multiverso_tpu_torch.core.options import AddOption
    return [AddOption(worker_id=w, momentum=0.6, learning_rate=0.2, rho=0.3,
                      lambda_=0.05, staleness=s).scalars()
            for w, s in ((0, -1.0), (1, 2.0), (0, 0.0), (1, -1.0))]


def _jopt(opt):
    """``AddOption.scalars()`` as the JAX store's jitted update sees them:
    0-d JAX arrays. Eager JAX would take a numpy float32 scalar as a
    strongly typed float32 and lift momentum's ``(1 - m) * delta`` on a
    bfloat16 table to float32, which the store's jit never does."""
    return tuple(jnp.asarray(x) for x in opt)


def _leaf(rng, shape, dtype):
    """A random state leaf (non-negative: accumulators) as a JAX array."""
    v = np.abs(rng.normal(size=shape)).astype(np.float32)
    return jnp.asarray(v).astype(dtype)


def _state(name, rng):
    """The JAX ``init_state`` leaves (their dtypes) filled at random, and
    their port twins (copies)."""
    up = jupd._REGISTRY[name]()
    st = {k: _leaf(rng, v.shape, v.dtype) for k, v in
          up.init_state((ROWS, COLS), jnp.bfloat16, WORKERS).items()}
    return st, {k: _torch(v) for k, v in st.items()}


def _torch(a) -> "torch.Tensor":
    """A JAX array as a torch tensor of the same dtype, by its bits."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray((rng.normal(size=shape) * scale).astype(np.float32)) \
        .astype(jnp.bfloat16)


def test_port_state_leaves_take_the_jax_dtypes():
    for name in STATEFUL:
        want = jupd._REGISTRY[name]().init_state((4, 3), jnp.bfloat16, 2)
        got = tupd._REGISTRY[name]().init_state((4, 3), torch.bfloat16, 2,
                                               torch.device("cpu"))
        assert sorted(want) == sorted(got)
        for k in want:
            assert tuple(want[k].shape) == tuple(got[k].shape)
            assert (got[k].dtype == torch.bfloat16) == \
                (want[k].dtype == jnp.bfloat16), (name, k)


@pytest.mark.parametrize("name", STATEFUL)
def test_bf16_update_dense_bitwise(name):
    rng = np.random.default_rng(21)
    j_up, t_up = jupd._REGISTRY[name](), tupd._REGISTRY[name]()
    jd = _bf16(rng, (ROWS, COLS))
    js, ts = _state(name, rng)
    td = _torch(jd)
    for opt in _opts():
        delta = _bf16(rng, (ROWS, COLS), 0.1)
        jd, js = j_up.update_dense(jd, js, delta, _jopt(opt))
        td, ts = t_up.update_dense(td, ts, _torch(delta), opt)
        assert td.dtype == torch.bfloat16
        assert np.array_equal(_bits(jd), _bits(td)), name
        for k in js:
            assert np.array_equal(_bits(js[k]), _bits(ts[k])), (name, k)


@pytest.mark.parametrize("name", STATEFUL)
def test_bf16_rows_math_bitwise(name):
    rng = np.random.default_rng(22)
    j_up, t_up = jupd._REGISTRY[name](), tupd._REGISTRY[name]()
    n = 200
    d_rows, delta = _bf16(rng, (n, COLS)), _bf16(rng, (n, COLS), 0.1)
    st = {k: _leaf(rng, (n, COLS), v.dtype) for k, v in jupd._REGISTRY[
        name]().init_state((n, COLS), jnp.bfloat16, 1).items()}
    for opt in _opts():
        jd, js = j_up.rows_math(d_rows, st, delta, _jopt(opt))
        td, ts = t_up.rows_math(_torch(d_rows),
                                {k: _torch(v) for k, v in st.items()},
                                _torch(delta), opt)
        assert np.array_equal(_bits(jd), _bits(td)), name
        for k in js:
            assert np.array_equal(_bits(js[k]), _bits(ts[k])), (name, k)


def test_bf16_combine_rounds_after_every_add():
    """XLA's bfloat16 ``segment_sum`` rounds after every add, in lane
    order: rows [3, 3, 3, 1, 3] with deltas [1, 2^-8, 2^-8, 1, 2^-8] give
    row 3 a total of exactly 1.0 (each 2^-8 is half an ulp of 1, a tie
    that rounds to even), where one rounding of the float32 sum gives
    1.015625."""
    rows = np.array([3, 3, 3, 1, 3], np.int32)
    delta = np.array([1, 2 ** -8, 2 ** -8, 1, 2 ** -8], np.float32)[:, None]
    jr, jd = jupd.combine_duplicate_rows(
        jnp.asarray(rows), jnp.asarray(delta).astype(jnp.bfloat16), 5)
    tr, td = tupd.combine_duplicate_rows(
        torch.as_tensor(rows).long(), torch.as_tensor(delta).bfloat16(), 5)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(_bits(jd), _bits(td))
    assert td[tr == 3].float().tolist() == [[1.0]]
    assert float(torch.as_tensor(delta[[0, 1, 2, 4]]).sum()
                 .bfloat16()) == 1.015625


def test_bf16_combine_bitwise_long_runs():
    rng = np.random.default_rng(23)
    rows = rng.integers(0, 40, 3000).astype(np.int32)
    rows[:700] = 7                                      # one long run
    delta = _bf16(rng, (len(rows), COLS), 0.05)
    jr, jd = jupd.combine_duplicate_rows(jnp.asarray(rows), delta, 40)
    tr, td = tupd.combine_duplicate_rows(torch.as_tensor(rows).long(),
                                         _torch(delta), 40)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(_bits(jd), _bits(td))


def _jax_rows(name, data, state, ids, delta, opt):
    """The JAX XLA row route from its pieces (combine, ``take`` with
    ``mode="clip"``, ``rows_math``, ``.at[].set`` with ``mode="drop"``),
    without ``exact_elementwise`` (C1). Ids here are never negative
    (ROADMAP C7)."""
    up = jupd._REGISTRY[name]()
    wid = int(opt[0])
    if ids.shape[0] == 0:
        return data, state
    r, d = jupd.combine_duplicate_rows(jnp.asarray(ids), delta,
                                       data.shape[0])
    d_rows = jnp.take(data, r, axis=0, mode="clip")
    st_rows = {k: jnp.take(v[wid] if k in up.per_worker_state else v, r,
                           axis=0, mode="clip") for k, v in state.items()}
    new_d, new_st = up.rows_math(d_rows, st_rows, d, _jopt(opt))
    out = {}
    for k, v in state.items():
        if k in up.per_worker_state:
            out[k] = v.at[wid, r].set(new_st[k], mode="drop")
        else:
            out[k] = v.at[r].set(new_st[k], mode="drop")
    return data.at[r].set(new_d, mode="drop"), out


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "use_pallas"])
@pytest.mark.parametrize("name", STATEFUL)
def test_bf16_table_row_and_dense_adds_bitwise(name, use_pallas):
    """Through the port's table surface: 3 row Adds with duplicates (one
    long run, ids past the end), an empty Add and a dense Add, against
    the JAX pieces on the same bfloat16 values. A ``use_pallas``
    bfloat16 table takes the plain route, as in the JAX package."""
    mvt.init(["-platform=cpu"])
    try:
        rng = np.random.default_rng(24)
        table = mvt.create_table(mvt.MatrixTableOption(
            ROWS, COLS, dtype="bfloat16", updater=name,
            use_pallas=use_pallas))
        store = table.store
        assert store._pallas_cap is None
        jd = jnp.zeros((ROWS, COLS), jnp.bfloat16)
        js = jupd._REGISTRY[name]().init_state((ROWS, COLS), jnp.bfloat16,
                                               store.num_workers)
        kw = dict(momentum=0.6, learning_rate=0.2, rho=0.3, lambda_=0.05)
        j_up = jupd._REGISTRY[name]()
        for step in range(3):
            ids = rng.integers(0, ROWS + 3, 500).astype(np.int32)
            ids[:90] = 17
            delta = _bf16(rng, (500, COLS), 0.3)
            opt = mvt.AddOption(**kw)
            jd, js = _jax_rows(name, jd, js, ids, delta, opt.scalars())
            table.add_rows(ids, np.array(delta.astype(jnp.float32)), opt)
            table.add_rows(np.zeros(0, np.int32),
                           np.zeros((0, COLS), np.float32), opt)
            assert np.array_equal(_bits(jd), _bits(store.data)), (name,
                                                                  step)
            for k in js:
                assert np.array_equal(_bits(js[k]), _bits(store.state[k])), \
                    (name, step, k)
        dense = _bf16(rng, (ROWS, COLS), 0.1)
        opt = mvt.AddOption(**kw)
        jd, js = j_up.update_dense(jd, js, dense, _jopt(opt.scalars()))
        table.add(np.array(dense.astype(jnp.float32)), opt)
        assert np.array_equal(_bits(jd), _bits(store.data)), name
        for k in js:
            assert np.array_equal(_bits(js[k]), _bits(store.state[k])), \
                (name, k)
        probe = [0, 17, ROWS - 1, 17]
        assert np.array_equal(
            table.get_rows(probe),
            np.asarray(jnp.take(jd, jnp.asarray(probe), axis=0)
                       .astype(jnp.float32)))
    finally:
        mvt.shutdown()


@pytest.mark.parametrize("name", ["momentum_sgd", "adagrad"])
def test_bf16_store_payload_crosses_in_its_dtypes(name):
    """A JAX bfloat16 table's ``store_state()`` payload (bfloat16 data,
    bfloat16 or float32 leaves) loads into the port's store bit for bit,
    each leaf in its own dtype, and the port's payload widens exactly."""
    import multiverso_tpu as mvj
    import jax
    from multiverso_tpu_torch import interop
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    try:
        rng = np.random.default_rng(25)
        tj = mvj.create_table(mvj.MatrixTableOption(
            12, 5, dtype=jnp.bfloat16, updater=name))
        for _ in range(2):
            tj.add(rng.normal(size=(12, 5)).astype(np.float32),
                   mvj.AddOption(momentum=0.5, learning_rate=0.1, rho=0.2))
        payload = {k: np.asarray(v)
                   for k, v in tj.store.store_state().items()}
        tt = mvt.create_table(mvt.MatrixTableOption(
            12, 5, dtype="bfloat16", updater=name))
        interop.load_store_payload(tt.store, payload)
        for key, want in payload.items():
            live = tt.store.data if key == "data" else \
                tt.store.state[key[len("state/"):]]
            assert (live.dtype == torch.bfloat16) == \
                (want.dtype.itemsize == 2), key
            assert np.array_equal(_bits(want), _bits(live)), key
        back = tt.store.store_state()
        assert back["data"].dtype == np.float32
        assert np.array_equal(
            back["data"], payload["data"].astype(np.float32))
    finally:
        mvt.shutdown()
        mvj.shutdown()
