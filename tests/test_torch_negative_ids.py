"""Negative row ids (ROADMAP C5, and the reference's fault C7).

The JAX package does three things with a negative row id:

* its stateless XLA row Adds (``.at[ids].add(mode="drop")``: the default
  and sgd updaters, word2vec's ``_apply_update``) wrap an id in
  ``[-rows, 0)`` to ``id + rows`` and drop what is still out of range;
* its tiled Pallas kernel (B4) drops every negative id; its B2 and fused
  B3 kernels check no bound below 0 (an out-of-bounds DMA on a TPU);
* its stateful XLA route gathers row 0 (``take(mode="clip")``) and writes
  the update into row ``rows - 1`` (``.at[].set(mode="drop")`` wraps):
  a fault of the reference (C7), which the port does not copy.

The port normalises once at the entry of each route: the stateless Adds
of tables without the row kernels and word2vec's plain steps wrap, as
JAX does; ``use_pallas`` tables and every stateful route drop negative
lanes. Gets clamp, -1 to row 0, in both packages. Every comparison is
bitwise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
import multiverso_tpu as mvj
from multiverso_tpu.core import updater as jupd

torch = mvt = None   # set by _load_port

ROWS, COLS = 40, 6
IDS = np.array([3, -1, 7, -40, 3, -41, 39, 40, -1, 12, -7, 3], np.int32)
STATEFUL = ["momentum_sgd", "adagrad", "ftrl", "dcasgd", "dcasgda"]


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


@pytest.fixture
def port():
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _deltas(n=len(IDS), seed=0):
    return np.random.default_rng(seed).normal(size=(n, COLS)) \
        .astype(np.float32)


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_stateless_table_adds_wrap_as_jax(both, updater):
    """A table without the row kernels: the JAX store's own row Add and
    the port's, bitwise, negative ids included."""
    init = np.random.default_rng(1).normal(size=(ROWS, COLS)) \
        .astype(np.float32)
    tj = mvj.create_table(mvj.MatrixTableOption(ROWS, COLS,
                                                updater=updater))
    tt = mvt.create_table(mvt.MatrixTableOption(ROWS, COLS,
                                                updater=updater))
    tj.add(init)
    tt.add(init)
    base = tt.get()
    d = _deltas()
    tj.add_rows(IDS, d)
    tt.add_rows(IDS, d)
    assert np.array_equal(_u32(tj.get()), _u32(tt.get()))
    # -1 wrapped to the last row, -41 and 40 dropped.
    sign = -1.0 if updater == "sgd" else 1.0
    want = base.copy()
    for i, r in enumerate(IDS):
        if -ROWS <= r < ROWS:
            want[r % ROWS] += sign * d[i]
    np.testing.assert_allclose(tt.get(), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rows_sorted_wraps_as_jax_at_add(dtype):
    """The route's entry, ``ops/rows.add_rows_sorted``, on a float32 and a
    bfloat16 table, against ``.at[].add(mode="drop")``."""
    from multiverso_tpu_torch.ops import rows
    rng = np.random.default_rng(2)
    table = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    ids = rng.integers(-ROWS - 5, ROWS + 5, 600).astype(np.int32)
    ids[:100] = -1                                        # a long run
    d = (rng.normal(size=(600, COLS)) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jnp.asarray(table).astype(jdt).at[ids].add(
        jnp.asarray(d).astype(jdt), mode="drop").astype(jnp.float32)
    got = rows.add_rows_sorted(torch.tensor(table).to(getattr(torch, dtype)),
                               torch.as_tensor(ids), torch.as_tensor(d)
                               .to(getattr(torch, dtype)))
    assert np.array_equal(_u32(want), _u32(got.float().numpy()))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adagrad", [True, False], ids=["adagrad", "sgd"])
def test_word2vec_apply_update_wraps_as_jax(adagrad, param_dtype):
    """word2vec's plain step update with negative rows: the adds wrap and
    the AdaGrad sums are read clamped, as the JAX step does."""
    from multiverso_tpu.models.word2vec import model as jmodel
    from multiverso_tpu_torch.models.word2vec import model as tmodel
    rng = np.random.default_rng(3)
    w = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    g2 = rng.random((ROWS, COLS)).astype(np.float32)
    ids = rng.integers(-ROWS - 3, ROWS + 3, 400).astype(np.int32)
    ids[:50] = -2
    grad = (rng.normal(size=(400, COLS)) * 0.3).astype(np.float32)
    lr = np.float32(0.025)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    jw, jg = jmodel._apply_update(jnp.asarray(w).astype(jdt),
                                  jnp.asarray(g2), jnp.asarray(ids),
                                  jnp.asarray(grad), lr, adagrad)
    tw = torch.tensor(w).to(getattr(torch, param_dtype))
    tg = torch.tensor(g2)
    tmodel._apply_update(tw, tg, torch.as_tensor(ids), torch.as_tensor(grad),
                         torch.tensor(lr), adagrad)
    assert np.array_equal(_u32(np.asarray(jw.astype(jnp.float32))),
                          _u32(tw.float().numpy()))
    assert np.array_equal(_u32(jg), _u32(tg.numpy()))


def test_pallas_routes_drop_negative_ids_as_jax_tiled_kernel():
    """B2's and B4's routes (``use_pallas`` default and sgd tables, the
    tiled Add) drop every negative id, as the JAX tiled kernel (B4) does:
    its tiles take ids by ``searchsorted`` over ``[0, rows)``. (The JAX
    B2 and fused B3 kernels check no bound below 0: a negative id is an
    out-of-bounds DMA on a TPU, and interpret mode on the CPU wraps it,
    so they give no answer to hold against.)"""
    from multiverso_tpu.ops.pallas_rows import \
        tiled_scatter_add_rows as jtiled
    from multiverso_tpu_torch.ops import rows
    table = np.random.default_rng(4).normal(size=(ROWS, 128)) \
        .astype(np.float32)
    d = np.random.default_rng(5).normal(size=(len(IDS), 128)) \
        .astype(np.float32)
    keep = (IDS >= 0) & (IDS < ROWS)
    for sign in (1.0, -1.0):
        want = jtiled(jnp.asarray(table), jnp.asarray(IDS), jnp.asarray(d),
                      interpret=True, sign=sign)
        kept = jtiled(jnp.asarray(table), jnp.asarray(IDS[keep]),
                      jnp.asarray(d[keep]), interpret=True, sign=sign)
        assert np.array_equal(_u32(want), _u32(kept))
        got = rows.tiled_scatter_add_rows(torch.tensor(table),
                                          torch.as_tensor(IDS),
                                          torch.as_tensor(d), sign=sign)
        assert np.array_equal(_u32(want), _u32(got.numpy()))
        # B2 sums each group of 8 lanes first: the same rows, other
        # roundings where a row repeats.
        got = rows.scatter_add_rows(torch.tensor(table),
                                    torch.as_tensor(IDS),
                                    torch.as_tensor(d), sign=sign).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        untouched = np.setdiff1d(np.arange(ROWS), IDS[keep])
        assert np.array_equal(_u32(got[untouched]),
                              _u32(table[untouched]))


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_use_pallas_tables_drop_negative_ids(port, updater):
    """A ``use_pallas`` default or sgd table (B2's route): an Add with
    negative lanes is the same Add without them."""
    d = _deltas(seed=11)
    (a, _), (b, _) = _same_add_without_negatives(updater, True, IDS, d)
    assert np.array_equal(_u32(a), _u32(b))


def _same_add_without_negatives(name, use_pallas, ids, d, dtype="float32"):
    """(table with ``ids`` added, table with only the non-negative lanes
    added), both the port's, from the same random start."""
    out = []
    for lanes in (slice(None), ids >= 0):
        t = mvt.create_table(mvt.MatrixTableOption(
            ROWS, COLS, updater=name, use_pallas=use_pallas, dtype=dtype))
        t.add(np.random.default_rng(6).normal(size=(ROWS, COLS))
              .astype(np.float32), mvt.AddOption(momentum=0.0))
        opt = mvt.AddOption(momentum=0.6, learning_rate=0.2, rho=0.3,
                            lambda_=0.05)
        t.add_rows(ids[lanes], d[lanes], opt)
        out.append((t.get(), {k: v.float().numpy() for k, v in
                              t.store.state.items()}))
    return out


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "use_pallas"])
@pytest.mark.parametrize("name", STATEFUL)
def test_stateful_routes_drop_negative_ids(port, name, use_pallas):
    """Every stateful route, the fused one (``use_pallas`` momentum_sgd,
    adagrad, ftrl) and the plain one, float32 and bfloat16: an Add with
    negative lanes is the same Add without them, bit for bit."""
    d = _deltas(seed=7)
    for dtype in ("float32", "bfloat16"):
        (a, sa), (b, sb) = _same_add_without_negatives(name, use_pallas, IDS,
                                                       d, dtype)
        assert np.array_equal(_u32(a), _u32(b)), (name, dtype)
        for k in sa:
            assert np.array_equal(_u32(sa[k]), _u32(sb[k])), (name, k)
    if use_pallas and name in ("momentum_sgd", "adagrad", "ftrl"):
        t = mvt.create_table(mvt.MatrixTableOption(
            ROWS, COLS, updater=name, use_pallas=True))
        assert t.store._pallas_cap == "fused_stateful"


@pytest.mark.parametrize("name", ["momentum_sgd", "adagrad", "dcasgd"])
def test_reference_stateful_route_reads_row_0_writes_last_row(name):
    """C7, the reference's fault, from its own pieces: a row Add at id -1
    combines (the run keeps -1), gathers row 0 (``take(mode="clip")``),
    applies ``rows_math`` and writes the result into the LAST row
    (``.at[-1].set(mode="drop")`` wraps), leaving row 0 as it was. The
    port's stateful routes drop the lane instead
    (``test_stateful_routes_drop_negative_ids``)."""
    rng = np.random.default_rng(8)
    up = jupd._REGISTRY[name]()
    data = jnp.asarray(rng.normal(size=(ROWS, COLS)).astype(np.float32))
    state = {k: jnp.asarray(np.abs(rng.normal(size=v.shape))
                            .astype(np.float32))
             for k, v in up.init_state((ROWS, COLS), jnp.float32, 1).items()}
    opt = tuple(jnp.asarray(x) for x in mvj.AddOption(
        momentum=0.6, learning_rate=0.2, rho=0.3, lambda_=0.05).scalars())
    delta = jnp.asarray(_deltas(1, seed=9))
    r, dc = jupd.combine_duplicate_rows(jnp.asarray([-1], jnp.int32), delta,
                                        ROWS)
    assert np.asarray(r).tolist() == [-1]
    d_rows = jnp.take(data, r, axis=0, mode="clip")
    st_rows = {k: jnp.take(v[0] if k in up.per_worker_state else v, r,
                           axis=0, mode="clip") for k, v in state.items()}
    assert np.array_equal(np.asarray(d_rows), np.asarray(data[:1]))
    new_d, _ = up.rows_math(d_rows, st_rows, dc, opt)
    out = np.asarray(data.at[r].set(new_d, mode="drop"))
    assert np.array_equal(out[-1], np.asarray(new_d[0]))       # written
    assert np.array_equal(out[0], np.asarray(data[0]))         # read
    assert np.array_equal(out[1:-1], np.asarray(data[1:-1]))
    assert not np.array_equal(out[-1], np.asarray(data[-1]))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "use_pallas"])
def test_gets_clamp_negative_ids_as_jax(both, use_pallas):
    """Gets keep ``mode="clip"``: -1 and -6 read row 0, 40 the last row,
    in both packages."""
    init = np.random.default_rng(10).normal(size=(ROWS, COLS)) \
        .astype(np.float32)
    tj = mvj.create_table(mvj.MatrixTableOption(ROWS, COLS))
    tt = mvt.create_table(mvt.MatrixTableOption(ROWS, COLS,
                                                use_pallas=use_pallas))
    tj.add(init)
    tt.add(init)
    probe = [-1, -6, 7, 40, -41]
    got = tt.get_rows(probe)
    assert np.array_equal(_u32(got), _u32(tj.get_rows(probe)))
    assert np.array_equal(got, init[[0, 0, 7, ROWS - 1, 0]])
