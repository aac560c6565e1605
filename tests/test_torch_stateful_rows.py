"""Port parity: the plain versions of the fused stateful row kernel (B3),
the fused route (the combine and B3 in one pass over sorted runs), the
tiled scatter-add (B4), the lane-order row Add built on it and the
duplicate combine's fold, against the JAX package on the CPU.

Both sides get the same numpy inputs. Tolerance: BITWISE throughout.

* B3: the JAX package's own ``fused_stateful_rows`` and its stateful
  ``apply_rows`` raise on this tree's jax (ROADMAP C1), so the reference is
  built from its pure pieces run eagerly: ``combine_duplicate_rows``, a
  clamped gather, ``Updater.rows_math`` and a write-back of the in-range
  lanes. Each op rounds once on both sides.
* B4: the JAX kernel in interpret mode. Both fold a row's deltas into it
  one at a time in sorted order.
* The fold: a run's deltas summed in lane order, ``0 + d0 + d1 + ...``.
* The fused route (``fused_stateful_sorted_rows``): on every
  ``chip_smoke.stateful_layouts`` layout, the JAX package's
  ``combine_duplicate_rows`` and ``rows_math`` on the raw ids. The JAX
  side takes int32 ids (no x64), so ids past the int32 range reach it
  clipped to that range: still out of range on the same side, and
  dropped alike. Bitwise by the bits (uint32 views), so -0.0 shows.
* The sort before the kernels (``sort_rows``): int32 keys give the int64
  sort's permutation on the in-range lanes.
* ``add_rows_sorted``, the row Add of the plain updaters and of the
  word2vec step: its card route (a stable sort, then B4) through B4's
  plain version, its CPU route (``index_add_``) and JAX's
  ``.at[].add(mode="drop")``, bitwise. JAX's ``.at[]`` wraps ids in
  ``[-rows, 0)`` to the end of the table (NumPy indexing), and so does
  ``add_rows_sorted`` (ROADMAP C5).

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

import _torch_port
import chip_smoke
from multiverso_tpu.core import updater as jupd
from multiverso_tpu.ops.pallas_rows import (
    tiled_scatter_add_rows as jax_tiled,
    tiled_scatter_add_sorted_rows as jax_tiled_sorted,
    tiled_scatter_eligible as jax_tiled_eligible)

torch = rows = tupd = AddOption = None   # set by _load_port

STATEFUL = ["momentum_sgd", "adagrad", "ftrl"]
LAYOUTS = chip_smoke.stateful_layouts()
LAYOUT_ROWS = 2_000     # stateful_layouts' default table


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, rows, tupd, AddOption
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.core import updater as tupd
    from multiverso_tpu_torch.core.options import AddOption
    from multiverso_tpu_torch.ops import rows


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


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _opt(wid):
    return AddOption(worker_id=wid, momentum=0.9, learning_rate=0.05,
                     rho=0.1, lambda_=0.01).scalars()


def _init_state(name, rng, shape, workers):
    """Random state leaves of the updater: accumulators non-negative (they
    are sums of squares), the others of both signs."""
    st = tupd._REGISTRY[name]().init_state(shape, torch.float32, workers,
                                           torch.device("cpu"))
    out = {}
    for key, leaf in st.items():
        v = rng.normal(size=tuple(leaf.shape)).astype(np.float32)
        out[key] = np.abs(v) if key in ("g2", "n") else v
    return out


def _jax_fused_reference(name, data, state, r_eff, d_c, opt):
    """Gather (clamped), JAX ``rows_math`` eagerly, write back in range."""
    j_up = jupd._REGISTRY[name]()
    data, state = data.copy(), {k: v.copy() for k, v in state.items()}
    if len(r_eff) == 0:
        return data, state
    wid = int(opt[0])
    num_rows = data.shape[0]
    keep = (r_eff >= 0) & (r_eff < num_rows)
    clip = np.clip(r_eff, 0, num_rows - 1)
    planes = {k: v[wid] if k in j_up.per_worker_state else v
              for k, v in state.items()}
    nd, ns = j_up.rows_math(jnp.asarray(data[clip]),
                            {k: jnp.asarray(p[clip])
                             for k, p in planes.items()},
                            jnp.asarray(d_c), opt)
    data[r_eff[keep]] = np.asarray(nd)[keep]
    for k, p in planes.items():
        p[r_eff[keep]] = np.asarray(ns[k])[keep]
    return data, state


def _fused_case(case):
    """(num_rows, cols, workers, wid, list of (ids, deltas) batches)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    num_rows, cols, workers, wid = 33, 16, 1, 0
    if case == "duplicates":
        batches = []
        for _ in range(3):
            n = int(rng.integers(1, 24))
            batches.append(rng.integers(0, num_rows, size=n))
    elif case == "cross_group":   # duplicates straddle an 8-lane group
        batches = [np.array([2, 2, 2, 6, 6, 1, 1, 1, 1, 2, 6])]
    elif case == "long_run":
        batches = [np.concatenate([np.full(300, 7), rng.integers(0, 33, 40)])]
    elif case == "per_worker":
        workers, wid = 2, 1
        batches = [rng.integers(0, num_rows, size=12) for _ in range(2)]
    else:   # empty
        batches = [np.zeros(0, np.int64)]
    batches = [(ids.astype(np.int32),
                rng.normal(size=(len(ids), cols)).astype(np.float32))
               for ids in batches]
    return rng, num_rows, cols, workers, wid, batches


@pytest.mark.parametrize("case", ["duplicates", "cross_group", "long_run",
                                  "per_worker", "empty"])
@pytest.mark.parametrize("name", STATEFUL)
def test_fused_stateful_plain_bitwise_vs_jax_pieces(name, case):
    rng, num_rows, cols, workers, wid, batches = _fused_case(case)
    data = rng.normal(size=(num_rows, cols)).astype(np.float32)
    state = _init_state(name, rng, (num_rows, cols), workers)
    want_d, want_s = data, state
    got_d = _t(data)
    got_s = {k: _t(v) for k, v in state.items()}
    opt = _opt(wid)
    up = tupd._REGISTRY[name]()
    for ids, deltas in batches:
        r_eff, d_c = jupd.combine_duplicate_rows(jnp.asarray(ids),
                                                 jnp.asarray(deltas),
                                                 num_rows)
        r_eff, d_c = np.asarray(r_eff), np.asarray(d_c)
        want_d, want_s = _jax_fused_reference(name, want_d, want_s, r_eff,
                                              d_c, opt)
        # Both packages see the same combined input.
        out_d, out_s = rows.fused_stateful_rows(got_d, got_s, _t(r_eff),
                                                _t(d_c), opt, up)
        assert out_d is got_d and out_s is got_s            # in place
    assert np.array_equal(got_d.numpy(), want_d), (name, case)
    for k in want_s:
        assert np.array_equal(got_s[k].numpy(), want_s[k]), (name, case, k)
    if case == "per_worker" and name == "adagrad":
        # Only worker 1's accumulator plane moved.
        assert np.array_equal(got_s["g2"][0].numpy(), state["g2"][0])
        assert not np.array_equal(got_s["g2"][1].numpy(), state["g2"][1])
    if case == "empty":
        assert np.array_equal(got_d.numpy(), data)
    assert rows.LAUNCHES["fused_stateful_rows"] == 0      # CPU: plain


@pytest.mark.parametrize("name", STATEFUL)
def test_fused_stateful_sentinel_lanes_write_nothing(name):
    """Lanes holding the sentinel (``num_rows``) or a negative id are
    dropped; an all-sentinel batch leaves table and state unchanged."""
    rng = np.random.default_rng(3)
    num_rows, cols = 9, 8
    data = rng.normal(size=(num_rows, cols)).astype(np.float32)
    state = _init_state(name, rng, (num_rows, cols), 1)
    up = tupd._REGISTRY[name]()
    opt = _opt(0)
    d = rng.normal(size=(4, cols)).astype(np.float32)
    got_d, got_s = _t(data), {k: _t(v) for k, v in state.items()}
    rows.fused_stateful_rows(got_d, got_s, _t(np.full(4, num_rows)), _t(d),
                             opt, up)
    assert np.array_equal(got_d.numpy(), data)
    for k in state:
        assert np.array_equal(got_s[k].numpy(), state[k])
    mixed = np.array([1, num_rows, 4, -1], np.int64)
    rows.fused_stateful_rows(got_d, got_s, _t(mixed), _t(d), opt, up)
    want_d, want_s = _jax_fused_reference(name, data, state, mixed, d, opt)
    assert np.array_equal(got_d.numpy(), want_d)
    for k in state:
        assert np.array_equal(got_s[k].numpy(), want_s[k])
    untouched = [r for r in range(num_rows) if r not in (1, 4)]
    assert np.array_equal(got_d.numpy()[untouched], data[untouched])


@pytest.mark.parametrize("name", STATEFUL + ["dcasgda"])
def test_rows_math_bitwise_at_table_width(name):
    """100,000 elements: torch's float32 CPU ``sqrt`` is one ulp off on a
    fraction of a large tensor's elements, so the port's updaters take
    the square root in float64 (exact once rounded) and stay bitwise."""
    rng = np.random.default_rng(17)
    j_up, t_up = jupd._REGISTRY[name](), tupd._REGISTRY[name]()
    shape = (2000, 50)
    d_rows = rng.normal(size=shape).astype(np.float32)
    delta = rng.normal(size=shape).astype(np.float32)
    st = {k: np.abs(rng.normal(size=shape)).astype(np.float32)
          for k in t_up.init_state(shape, torch.float32, 1,
                                   torch.device("cpu"))}
    jd, js = j_up.rows_math(jnp.asarray(d_rows),
                            {k: jnp.asarray(v) for k, v in st.items()},
                            jnp.asarray(delta), _opt(0))
    td, ts = t_up.rows_math(_t(d_rows), {k: _t(v) for k, v in st.items()},
                            _t(delta), _opt(0))
    assert np.array_equal(np.asarray(jd), td.numpy()), name
    for k in js:
        assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (name, k)


def test_fused_stateful_refuses_stateless_updater():
    with pytest.raises(ValueError, match="state leaf"):
        rows.fused_stateful_rows(torch.zeros(4, 4), {}, torch.zeros(1),
                                 torch.zeros(1, 4), _opt(0),
                                 tupd._REGISTRY["sgd"]())


def test_combine_long_run_is_lane_order_fold():
    """A run of hundreds of duplicates sums in lane order, 0 + d0 + d1 +
    ..., with the same bits as the JAX package's segment_sum."""
    rng = np.random.default_rng(11)
    ids = np.concatenate([np.full(400, 5), rng.integers(0, 50, 60),
                          np.full(250, 49)]).astype(np.int32)
    rng.shuffle(ids)
    deltas = (rng.normal(size=(len(ids), 6)) *
              10.0 ** rng.integers(-3, 4, size=(len(ids), 1))
              ).astype(np.float32)
    r_eff, d_c = tupd.combine_duplicate_rows(_t(ids).to(torch.int64),
                                             _t(deltas), 50)
    order = np.argsort(ids, kind="stable")
    for row in (5, 49):
        lanes = order[ids[order] == row]
        acc = np.zeros(6, np.float32)
        for j in lanes:
            acc = acc + deltas[j]
        first = int(np.searchsorted(ids[order], row))
        got = d_c.numpy()[first:first + len(lanes)]
        assert np.array_equal(got, np.broadcast_to(acc, got.shape)), row
        assert r_eff[first] == row
        assert (r_eff[first + 1:first + len(lanes)] == 50).all()
    jr, jd = jupd.combine_duplicate_rows(jnp.asarray(ids),
                                         jnp.asarray(deltas), 50)
    assert np.array_equal(np.asarray(jr), r_eff.numpy())
    assert np.array_equal(np.asarray(jd), d_c.numpy())
    # The fold alone, on the sorted lanes.
    fold = rows.fold_sorted_runs(_t(ids[order]).to(torch.int64),
                                 _t(deltas[order]))
    assert np.array_equal(fold.numpy(), d_c.numpy())
    assert rows.LAUNCHES["fold_sorted_runs"] == 0          # CPU: plain


# ---------------------------------------------------------------------------
# B4: tiled scatter-add
# ---------------------------------------------------------------------------
def _tiled_case(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "random":
        table = rng.normal(size=(1000, 128)).astype(np.float32)
        ids = rng.integers(0, 1000, size=512)
    elif case == "nonmultiple_tile_edges":
        table = rng.normal(size=(777, 128)).astype(np.float32)
        ids = np.array([0, 255, 255, 256, 511, 512, 512, 512, 776, 776])
    elif case == "small_sgd":
        table = np.zeros((300, 8), np.float32)
        ids = np.array([3, 3, 299])
    else:   # a run of hundreds of one id, deltas of many magnitudes
        table = rng.normal(size=(64, 24)).astype(np.float32)
        ids = np.concatenate([np.full(300, 17), rng.integers(0, 64, 30)])
    ids = np.sort(ids).astype(np.int32)
    deltas = (rng.normal(size=(len(ids), table.shape[1])) *
              10.0 ** rng.integers(-3, 4, size=(len(ids), 1))
              ).astype(np.float32)
    return table, ids, deltas


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("case", ["random", "nonmultiple_tile_edges",
                                  "small_sgd", "long_run"])
def test_tiled_scatter_add_sorted_bitwise(case, sign):
    table, ids, deltas = _tiled_case(case)
    want = np.asarray(jax_tiled_sorted(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(deltas), interpret=True,
                                       sign=sign))
    got = _t(table)
    out = rows.tiled_scatter_add_sorted_rows(got, _t(ids), _t(deltas),
                                             sign=sign)
    assert out is got                                      # in place
    assert np.array_equal(got.numpy(), want)
    expected = table.astype(np.float64)
    np.add.at(expected, ids, sign * deltas.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-3)
    assert rows.LAUNCHES["tiled_scatter_add_sorted_rows"] == 0


def test_tiled_scatter_differs_from_group_fold_rounding():
    """B4 adds a row's deltas one by one; B2 sums each 8-lane group first.
    On a long run of deltas of many magnitudes the two roundings part."""
    table, ids, deltas = _tiled_case("long_run")
    b4 = rows.tiled_scatter_add_sorted_rows(_t(table), _t(ids), _t(deltas))
    b2 = rows.scatter_add_sorted_rows(_t(table), _t(ids), _t(deltas))
    assert not np.array_equal(b4.numpy(), b2.numpy())
    np.testing.assert_allclose(b4.numpy(), b2.numpy(), rtol=1e-4, atol=1e-3)


def test_tiled_scatter_unsorted_wrapper_bitwise():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(300, 16)).astype(np.float32)
    ids = rng.integers(0, 300, size=97).astype(np.int32)
    deltas = rng.normal(size=(97, 16)).astype(np.float32)
    for sign in (1.0, -1.0):
        want = np.asarray(jax_tiled(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(deltas), interpret=True,
                                    sign=sign))
        got = rows.tiled_scatter_add_rows(_t(table), _t(ids), _t(deltas),
                                          sign=sign)
        assert np.array_equal(got.numpy(), want), sign


def test_tiled_scatter_empty_and_sign_check():
    table = torch.ones(4, 8)
    rows.tiled_scatter_add_sorted_rows(table, torch.zeros(0, dtype=torch.int32),
                                       torch.zeros(0, 8))
    assert torch.equal(table, torch.ones(4, 8))
    with pytest.raises(ValueError):
        rows.tiled_scatter_add_sorted_rows(table, torch.zeros(1),
                                           torch.zeros(1, 8), sign=2.0)


def test_tiled_scatter_eligible_matches_jax():
    for n in (0, 1, 4096, 8192, 16384, 100_000):
        for cols in (1, 50, 128, 256, 1024):
            for dtype in (np.float32, np.float16, np.float64):
                want = jax_tiled_eligible(n, cols, dtype)
                assert rows.tiled_scatter_eligible(n, cols, dtype) == want
                tdt = {np.float32: torch.float32, np.float16: torch.float16,
                       np.float64: torch.float64}[dtype]
                assert rows.tiled_scatter_eligible(n, cols, tdt) == want
    assert rows.tiled_scatter_eligible(8192, 128, np.float32)   # bench shape


# ---------------------------------------------------------------------------
# The store's stateful row Add is in place (the JAX package donates)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", STATEFUL + ["dcasgd", "dcasgda"])
def test_store_stateful_row_add_is_in_place(name, use_pallas):
    import multiverso_tpu_torch as mv
    mv.init(["-platform=cpu"], num_local_workers=2)
    t = mv.create_table(mv.MatrixTableOption(40, 6, updater=name,
                                             use_pallas=use_pallas))
    if use_pallas and name in STATEFUL:
        assert t.store._pallas_cap == "fused_stateful"
    ptrs = {"data": t.store.data.data_ptr(),
            **{k: v.data_ptr() for k, v in t.store.state.items()}}
    before = t.store.store_state()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 40, size=25).astype(np.int32)
    t.add_rows(ids, rng.normal(size=(25, 6)).astype(np.float32),
               mv.AddOption(worker_id=1, momentum=0.5, learning_rate=0.1,
                            rho=0.1, lambda_=0.01))
    after = {"data": t.store.data.data_ptr(),
             **{k: v.data_ptr() for k, v in t.store.state.items()}}
    assert after == ptrs, name
    now = t.store.store_state()
    for key in before:                   # and every buffer was written
        assert not np.array_equal(now[key], before[key]), (name, key)
    mv.shutdown()


# ---------------------------------------------------------------------------
# The fused route: the combine and B3 in one pass over sorted runs
# ---------------------------------------------------------------------------
def _bits(a):
    return np.asarray(a).view(np.uint32)


def _int32_range(ids):
    """The ids as the JAX package (int32, no x64) can take them: clipped
    to the int32 range, so each id stays in range or out of it, on its
    side."""
    return np.clip(ids, -2 ** 31, 2 ** 31 - 1).astype(np.int32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", STATEFUL)
def test_fused_sorted_route_bitwise_vs_jax_pieces(name, layout):
    """The route's plain version (what the kernel is held to on the card)
    against the JAX pieces on the raw ids: duplicates, runs across tile
    edges, a run of 2,700 lanes, Zipf, one id in every lane, ids out of
    range, -0.0 deltas, no ids."""
    ids = LAYOUTS[layout]
    rng = np.random.default_rng(zlib.crc32(f"{name}/{layout}".encode()))
    cols = 8
    deltas = chip_smoke.stateful_deltas(layout, len(ids), cols, rng)
    data = rng.normal(size=(LAYOUT_ROWS, cols)).astype(np.float32)
    state = _init_state(name, rng, (LAYOUT_ROWS, cols), 1)
    opt = _opt(0)
    r_eff, d_c = jupd.combine_duplicate_rows(jnp.asarray(_int32_range(ids)),
                                             jnp.asarray(deltas),
                                             LAYOUT_ROWS)
    want_d, want_s = _jax_fused_reference(name, data, state,
                                          np.asarray(r_eff),
                                          np.asarray(d_c), opt)
    got_d, got_s = _t(data), {k: _t(v) for k, v in state.items()}
    out = rows.fused_stateful_sorted_rows(got_d, got_s, _t(ids), _t(deltas),
                                          opt, tupd._REGISTRY[name]())
    assert out[0] is got_d and out[1] is got_s              # in place
    assert np.array_equal(_bits(got_d.numpy()), _bits(want_d)), name
    for k in want_s:
        assert np.array_equal(_bits(got_s[k].numpy()), _bits(want_s[k])), k
    assert rows.LAUNCHES["fused_stateful_sorted_rows"] == 0  # CPU: plain


def test_fused_sorted_route_per_worker_plane():
    """AdaGrad with 2 workers at worker 1: only plane 1 of g2 moves, and
    the route is bitwise the JAX pieces."""
    ids = LAYOUTS["zipf"]
    rng = np.random.default_rng(5)
    cols = 8
    deltas = chip_smoke.stateful_deltas("zipf", len(ids), cols, rng)
    data = rng.normal(size=(LAYOUT_ROWS, cols)).astype(np.float32)
    state = _init_state("adagrad", rng, (LAYOUT_ROWS, cols), 2)
    opt = _opt(1)
    r_eff, d_c = jupd.combine_duplicate_rows(jnp.asarray(_int32_range(ids)),
                                             jnp.asarray(deltas),
                                             LAYOUT_ROWS)
    want_d, want_s = _jax_fused_reference("adagrad", data, state,
                                          np.asarray(r_eff),
                                          np.asarray(d_c), opt)
    got_d, got_s = _t(data), {k: _t(v) for k, v in state.items()}
    rows.fused_stateful_sorted_rows(got_d, got_s, _t(ids), _t(deltas), opt,
                                    tupd._REGISTRY["adagrad"]())
    assert np.array_equal(_bits(got_d.numpy()), _bits(want_d))
    assert np.array_equal(_bits(got_s["g2"].numpy()), _bits(want_s["g2"]))
    assert np.array_equal(got_s["g2"][0].numpy(), state["g2"][0])
    assert not np.array_equal(got_s["g2"][1].numpy(), state["g2"][1])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sort_rows_int32_keys_keep_the_int64_permutation(layout):
    """Out-of-range ids become -1 or ``rows`` before the cast, so no id
    past 2^31 wraps into range; the in-range lanes keep the int64 sort's
    positions, order and ids."""
    ids = _t(LAYOUTS[layout])
    keys, order = rows.sort_rows(ids, LAYOUT_ROWS)
    k64, o64 = torch.sort(ids, stable=True)
    assert keys.dtype == torch.int32 and order.dtype == torch.int64
    keep = (k64 >= 0) & (k64 < LAYOUT_ROWS)
    assert torch.equal(order[keep], o64[keep])
    assert torch.equal(keys[keep].to(torch.int64), k64[keep])
    low, high = keys[~keep & (k64 < 0)], keys[~keep & (k64 >= LAYOUT_ROWS)]
    assert (low == -1).all() and (high == LAYOUT_ROWS).all()
    assert sorted(order[~keep].tolist()) == sorted(o64[~keep].tolist())
    # A table past the int32 range sorts int64 keys as they are.
    wide_keys, wide_order = rows.sort_rows(ids, 2 ** 31)
    assert wide_keys.dtype == torch.int64
    assert torch.equal(wide_keys, k64) and torch.equal(wide_order, o64)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_add_rows_sorted_routes_bitwise(layout, sign):
    """The card's route (the ids wrapped, a stable sort of int32 keys,
    then B4's plain version), the CPU's (``index_add_`` over the kept
    lanes) and JAX's ``.at[ids].add(sign * values, mode="drop")``: one set
    of bits. JAX wraps an id in [-rows, 0) to the table's end before
    ``mode="drop"``, and so does the port's route (ROADMAP C5)."""
    ids = LAYOUTS[layout]
    rng = np.random.default_rng(zlib.crc32(f"add/{layout}".encode()))
    cols = 8
    table = rng.normal(size=(LAYOUT_ROWS, cols)).astype(np.float32)
    table[rng.random(LAYOUT_ROWS) < 0.1] = -0.0
    values = chip_smoke.stateful_deltas(layout, len(ids), cols, rng)
    card = _t(table)
    wrapped = np.where(ids < 0, ids + LAYOUT_ROWS, ids)
    keys, order = rows.sort_rows(_t(wrapped), LAYOUT_ROWS)
    rows.tiled_scatter_add_sorted_rows_plain(
        card, keys, _t(values).index_select(0, order), sign)
    cpu = rows.add_rows_sorted(_t(table), _t(ids), _t(values), sign)
    keep = (wrapped >= 0) & (wrapped < LAYOUT_ROWS)
    plain = _t(table).index_add_(0, _t(wrapped[keep]),
                                 _t(values[keep]) * sign)
    want = np.asarray(jnp.asarray(table).at[_int32_range(ids)].add(
        sign * jnp.asarray(values), mode="drop"))
    for got in (card, cpu, plain):
        assert np.array_equal(_bits(got.numpy()), _bits(want)), layout
    assert rows.LAUNCHES["tiled_scatter_add_sorted_rows"] == 0


@pytest.mark.parametrize("dtype", ["float64", "int32", "bfloat16"])
def test_add_rows_sorted_other_dtypes(dtype):
    """float64 (lane order, the CPU's index_add_), int32 (exact) and
    bfloat16 (a rounding after every add, XLA's order) tables, 1-D too."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-3, 43, 300)
    ids[:90] = 7
    tdt = getattr(torch, dtype)
    table = torch.as_tensor(rng.normal(size=(40, 5))).to(tdt)
    values = torch.as_tensor(rng.normal(size=(300, 5)) * 4).to(tdt)
    wrapped = np.where(ids < 0, ids + 40, ids)      # ROADMAP C5
    keep = (wrapped >= 0) & (wrapped < 40)
    got = rows.add_rows_sorted(table.clone(), _t(ids), values)
    if dtype == "bfloat16":
        want = rows.add_rows_lane_order(table.clone(), _t(wrapped), values)
    else:
        want = table.clone().index_add_(0, _t(wrapped[keep]),
                                        values[_t(keep)])
    assert torch.equal(got, want)
    flat = rows.add_rows_sorted(table[:, 0].clone(), _t(ids), values[:, 0],
                                sign=-1.0)
    assert torch.equal(flat, rows.add_rows_sorted(
        table.clone(), _t(ids), values, sign=-1.0)[:, 0])
