"""Port parity: the seven server-side updaters against the JAX package.

Inputs come from numpy seeds and go to both packages. Tolerances:

* BITWISE against the JAX functions run eagerly (one XLA primitive at a
  time: ``update_dense``, ``rows_math``, ``combine_duplicate_rows``,
  stateless ``update_rows``) — both sides round every elementwise op once;
* rtol 2e-6 per step against the same functions under ``jax.jit`` (each
  step starts both sides from the same values): XLA:CPU contracts
  multiply-adds into fma and rewrites divisions by square roots, which
  measured up to 13 ulp (dcasgda; adagrad 12, ftrl 5, dcasgd 4, momentum
  3, default and sgd 0);
* the closed forms of ``tests/test_updaters.py`` through the port's
  tables, at the tolerance that file uses.

The JAX store's stateful row path raises on this tree's jax (ROADMAP C1),
so the port's stateful ``update_rows`` is held against a reference built
from the JAX package's pure pieces instead.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
from multiverso_tpu.core import updater as jupd
from multiverso_tpu.core.options import AddOption as JaxAddOption

torch = tupd = AddOption = None   # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, tupd, AddOption
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.core import updater as tupd
    from multiverso_tpu_torch.core.options import AddOption

UPDATERS = ["default", "sgd", "momentum_sgd", "adagrad", "ftrl", "dcasgd",
            "dcasgda"]
STATEFUL = ["momentum_sgd", "adagrad", "ftrl", "dcasgd", "dcasgda"]
SHAPE = (6, 5)
WORKERS = 2


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


def _opts():
    return [AddOption(worker_id=w, momentum=0.6, learning_rate=0.2, rho=0.3,
                      lambda_=0.05, staleness=s)
            for w, s in ((0, -1.0), (1, 2.0), (0, 0.0), (1, -1.0))]


def _jax_state(name):
    st = jupd._REGISTRY[name]().init_state(SHAPE, jnp.float32, WORKERS)
    return {k: jnp.asarray(v) for k, v in st.items()}


def _torch_state(name):
    return tupd._REGISTRY[name]().init_state(SHAPE, torch.float32, WORKERS,
                                             torch.device("cpu"))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _run_dense(name, jitted):
    rng = np.random.default_rng(3)
    j_up, t_up = jupd._REGISTRY[name](), tupd._REGISTRY[name]()
    jd = jnp.asarray(rng.normal(size=SHAPE).astype(np.float32))
    td = torch.as_tensor(np.asarray(jd).copy())
    js, ts = _jax_state(name), _torch_state(name)
    fn = jax.jit(j_up.update_dense) if jitted else j_up.update_dense
    pairs = []
    for opt in _opts():
        delta = rng.normal(size=SHAPE).astype(np.float32)
        if jitted:   # one step from the same inputs: no carried drift
            td = torch.as_tensor(np.asarray(jd).copy())
            ts = {k: torch.as_tensor(np.asarray(v).copy())
                  for k, v in js.items()}
        jd, js = fn(jd, js, jnp.asarray(delta), opt.scalars())
        td, ts = t_up.update_dense(td, ts, torch.as_tensor(delta),
                                   opt.scalars())
        pairs.append((np.asarray(jd), td.numpy()))
        pairs += [(np.asarray(js[k]), ts[k].numpy()) for k in js]
    return pairs


@pytest.mark.parametrize("name", UPDATERS)
def test_update_dense_bitwise_eager(name):
    for want, got in _run_dense(name, jitted=False):
        assert np.array_equal(want, got), (name, _ulps(want, got))


@pytest.mark.parametrize("name", UPDATERS)
def test_update_dense_close_to_jitted(name):
    for want, got in _run_dense(name, jitted=True):
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("name", STATEFUL)
def test_rows_math_bitwise(name):
    rng = np.random.default_rng(5)
    j_up, t_up = jupd._REGISTRY[name](), tupd._REGISTRY[name]()
    d_rows = rng.normal(size=(4, 5)).astype(np.float32)
    delta = rng.normal(size=(4, 5)).astype(np.float32)
    st = {k: np.abs(rng.normal(size=(4, 5))).astype(np.float32)
          for k in _torch_state(name)}
    for opt in _opts():
        jd, js = j_up.rows_math(jnp.asarray(d_rows),
                                {k: jnp.asarray(v) for k, v in st.items()},
                                jnp.asarray(delta), opt.scalars())
        td, ts = t_up.rows_math(torch.as_tensor(d_rows),
                                {k: torch.as_tensor(v) for k, v in st.items()},
                                torch.as_tensor(delta), opt.scalars())
        assert np.array_equal(np.asarray(jd), td.numpy()), name
        for k in js:
            assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (name, k)


def test_combine_duplicate_rows_bitwise():
    rng = np.random.default_rng(7)
    rows = np.array([5, 2, 5, 0, 2, 5, 9, 0], np.int32)
    delta = rng.normal(size=(len(rows), 3)).astype(np.float32)
    jr, jd = jupd.combine_duplicate_rows(jnp.asarray(rows),
                                         jnp.asarray(delta), 10)
    tr, td = tupd.combine_duplicate_rows(torch.as_tensor(rows),
                                         torch.as_tensor(delta), 10)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("name", ["default", "sgd"])
def test_stateless_update_rows_bitwise(name):
    rng = np.random.default_rng(11)
    data = rng.normal(size=SHAPE).astype(np.float32)
    rows = np.array([1, 4, 1, 1, 5, 0], np.int32)
    delta = rng.normal(size=(len(rows), SHAPE[1])).astype(np.float32)
    opt = JaxAddOption().scalars()
    jd, _ = jupd._REGISTRY[name]().update_rows(
        jnp.asarray(data), {}, jnp.asarray(rows), jnp.asarray(delta), opt)
    td, _ = tupd._REGISTRY[name]().update_rows(
        torch.as_tensor(data.copy()), {}, torch.as_tensor(rows),
        torch.as_tensor(delta), opt)
    assert np.array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("name", STATEFUL)
def test_stateful_update_rows_matches_jax_pieces(name):
    """combine (JAX) -> gather -> rows_math (JAX) -> set, vs the port."""
    rng = np.random.default_rng(13)
    j_up, t_up = jupd._REGISTRY[name](), tupd._REGISTRY[name]()
    data = rng.normal(size=SHAPE).astype(np.float32)
    st = {k: np.abs(rng.normal(size=v.shape)).astype(np.float32)
          for k, v in _torch_state(name).items()}
    rows = np.array([3, 1, 3, 3, 5], np.int32)
    delta = rng.normal(size=(len(rows), SHAPE[1])).astype(np.float32)
    opt = _opts()[1].scalars()
    wid = int(opt[0])
    r_eff, d_c = jupd.combine_duplicate_rows(jnp.asarray(rows),
                                             jnp.asarray(delta), SHAPE[0])
    r_eff, d_c = np.asarray(r_eff), np.asarray(d_c)
    keep = r_eff < SHAPE[0]
    clip = np.minimum(r_eff, SHAPE[0] - 1)
    st_rows = {k: jnp.asarray((v[wid] if k in j_up.per_worker_state
                               else v)[clip]) for k, v in st.items()}
    nd, ns = j_up.rows_math(jnp.asarray(data[clip]), st_rows,
                            jnp.asarray(d_c), opt)
    want_d = data.copy()
    want_d[r_eff[keep]] = np.asarray(nd)[keep]
    want_s = {k: v.copy() for k, v in st.items()}
    for k in st:
        tgt = want_s[k][wid] if k in j_up.per_worker_state else want_s[k]
        tgt[r_eff[keep]] = np.asarray(ns[k])[keep]
    td, ts = t_up.update_rows(torch.as_tensor(data),
                              {k: torch.as_tensor(v) for k, v in st.items()},
                              torch.as_tensor(rows), torch.as_tensor(delta),
                              opt)
    assert np.array_equal(td.numpy(), want_d), name
    for k in st:
        assert np.array_equal(ts[k].numpy(), want_s[k]), (name, k)


def test_factory_and_capability_registry_match_jax():
    for name in UPDATERS:
        assert tupd.get_updater(np.float32, name).name == \
            jupd.get_updater(np.float32, name).name
        assert tupd.pallas_row_capability(tupd._REGISTRY[name]()) == \
            jupd.pallas_row_capability(jupd._REGISTRY[name]())
    assert type(tupd.get_updater(np.int32, "adagrad")) is tupd.Updater
    assert type(tupd.get_updater(np.float32, "bogus")) is tupd.Updater


# -- closed forms (tests/test_updaters.py) through the port's tables -------
@pytest.fixture
def port_mv():
    import multiverso_tpu_torch as mv
    mv.init(["-platform=cpu"])
    yield mv
    mv.shutdown()


def test_closed_form_sgd_and_momentum(port_mv):
    mv = port_mv
    t = mv.create_table(mv.ArrayTableOption(size=4, updater="sgd"))
    t.add(np.array([1, 2, 3, 4], dtype=np.float32))
    np.testing.assert_allclose(t.get(), [-1, -2, -3, -4])
    m = 0.5
    t = mv.create_table(mv.ArrayTableOption(size=3, updater="momentum_sgd"))
    delta = np.array([2.0, 4.0, 8.0], dtype=np.float32)
    data, smooth = np.zeros(3), np.zeros(3)
    for _ in range(3):
        t.add(delta, mv.AddOption(momentum=m))
        smooth = m * smooth + (1 - m) * delta
        data = data - smooth
        np.testing.assert_allclose(t.get(), data, rtol=1e-6)


def test_closed_form_adagrad_rows_and_duplicates(port_mv):
    mv = port_mv
    rho, lr = 0.1, 0.1
    t = mv.create_table(
        mv.MatrixTableOption(num_row=6, num_col=2, updater="adagrad"))
    t.add_rows([1, 4], np.ones((2, 2), dtype=np.float32),
               mv.AddOption(rho=rho, learning_rate=lr))
    grad = 1.0 / lr
    expected = -rho / np.sqrt(grad * grad + tupd.AdaGradUpdater.eps) * grad
    got = t.get()
    np.testing.assert_allclose(got[[1, 4]], np.full((2, 2), expected),
                               rtol=1e-5)
    assert np.all(got[[0, 2, 3, 5]] == 0)
    for name in STATEFUL:
        t_dup = mv.create_table(
            mv.MatrixTableOption(num_row=8, num_col=4, updater=name))
        t_one = mv.create_table(
            mv.MatrixTableOption(num_row=8, num_col=4, updater=name))
        opt = mv.AddOption(worker_id=0, momentum=0.5, learning_rate=0.1,
                           rho=0.1, lambda_=0.01)
        d = np.ones((5, 4), dtype=np.float32)
        t_dup.add_rows([2, 2, 2, 6, 6], d, opt)
        t_one.add_rows([2, 6], np.stack([3 * d[0], 2 * d[0]]), opt)
        np.testing.assert_allclose(t_dup.get(), t_one.get(), rtol=1e-5,
                                   err_msg=name)
        t_dup.add_rows([], np.zeros((0, 4), np.float32), opt)   # no-op
        np.testing.assert_allclose(t_dup.get(), t_one.get(), rtol=1e-5)
