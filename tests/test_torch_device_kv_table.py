"""Port parity: ``DeviceKVTable`` (a value slab on the device under a key
directory) on the CPU against the JAX package, both directory backings.

Mirrors ``tests/test_device_kv_table.py``. Every case drives a JAX table
and a port table with the same calls and holds the port BITWISE to JAX:
values read back, and the checkpoint payload (``data``, ``kv_keys``,
``kv_slots``, in the same order). The JAX store's stateful row Add raises
on this tree's jax (ROADMAP C1), so a stateful slab is held against the
JAX package's pure pieces instead: its directory's slots, then
``combine_duplicate_rows`` and ``Updater.rows_math`` on the gathered rows.
"""

import numpy as np
import pytest

import _torch_port
import jax
import jax.numpy as jnp

import multiverso_tpu as mvj
from multiverso_tpu.core import updater as jupd
from multiverso_tpu.tables.device_kv_table import DeviceKVTable as JKV

mvt = TKV = torch = None  # set by _load_port

BACKINGS = [False, True]          # device_directory


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, TKV, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.tables.device_kv_table import \
        DeviceKVTable as TKV


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


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()


def _pair(device_directory, value_dim=1, **kw):
    j = JKV(mvj.KVTableOption(device=True, device_directory=device_directory,
                              **kw), value_dim=value_dim)
    t = TKV(mvt.KVTableOption(device=True, device_directory=device_directory,
                              **kw), value_dim=value_dim)
    return j, t


def _same_payload(j, t):
    jp, tp = j.store_state(), t.store_state()
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert np.asarray(jp[k]).dtype == tp[k].dtype, k
        assert np.array_equal(np.asarray(jp[k]), tp[k]), k


def _get(j, t, keys):
    want, got = np.asarray(j.get(keys)), t.get(keys)
    assert np.array_equal(want, got)
    return got


@pytest.mark.parametrize("dd", BACKINGS)
def test_scalar_values_accumulate(both, dd):
    j, t = _pair(dd, capacity=64)
    for tab in (j, t):
        tab.add([10, 99, 10**12], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(_get(j, t, [10, 99, 10**12]),
                                  [1.0, 2.0, 3.0])
    for tab in (j, t):
        tab.add([99], [10.0])
    np.testing.assert_array_equal(_get(j, t, [99]), [12.0])
    assert len(t) == len(j) == 3
    _same_payload(j, t)


@pytest.mark.parametrize("dd", BACKINGS)
def test_missing_keys_zero(both, dd):
    j, t = _pair(dd, capacity=8)
    np.testing.assert_array_equal(_get(j, t, [123, 456]), [0.0, 0.0])
    assert len(t) == 0


@pytest.mark.parametrize("dd", BACKINGS)
def test_vector_values_on_device(both, dd):
    j, t = _pair(dd, value_dim=16, capacity=128)
    for tab in (j, t):
        tab.add([7, 8], np.ones((2, 16), dtype=np.float32))
    got = _get(j, t, [8, 7, 9])
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(got[2], np.zeros(16))
    assert t.store.data.device == mvt.core.zoo.Zoo.get().device


@pytest.mark.parametrize("dd", BACKINGS)
def test_capacity_exhaustion_is_fatal(both, dd):
    from multiverso_tpu_torch.utils.log import FatalError
    _, t = _pair(dd, capacity=2)
    t.add([1, 2], [1.0, 1.0])
    with pytest.raises(FatalError):
        t.add([3], [1.0])


@pytest.mark.parametrize("dd", BACKINGS)
def test_updater_applies(both, dd):
    j, t = _pair(dd, capacity=8, updater="sgd")
    for tab in (j, t):
        tab.add([5], [2.0])
    np.testing.assert_array_equal(_get(j, t, [5]), [-2.0])


@pytest.mark.parametrize("dd", BACKINGS)
def test_checkpoint_roundtrip(both, dd, tmp_path):
    from multiverso_tpu.core import checkpoint as jck
    from multiverso_tpu_torch.core import checkpoint as tck
    j, t = _pair(dd, capacity=32, name="dkv")
    for tab in (j, t):
        tab.add([100, 200], [1.0, 2.0])
    _same_payload(j, t)
    tck.save_table(t, f"file://{tmp_path}/t.npz")
    jck.save_table(j, f"file://{tmp_path}/j.npz")
    for tab in (j, t):
        tab.add([100, 300], [50.0, 7.0])
    tck.load_table(t, f"file://{tmp_path}/j.npz")     # JAX's file
    jck.load_table(j, f"file://{tmp_path}/t.npz")     # the port's file
    np.testing.assert_array_equal(_get(j, t, [100, 200, 300]),
                                  [1.0, 2.0, 0.0])
    assert len(t) == len(j) == 2
    _same_payload(j, t)


@pytest.mark.parametrize("dd", BACKINGS)
def test_factory_routes_device_flag(both, dd):
    opt = dict(device=True, device_directory=dd, capacity=16, value_dim=4)
    j = mvj.create_table(mvj.KVTableOption(**opt))
    t = mvt.create_table(mvt.KVTableOption(**opt))
    assert isinstance(t, TKV) and t._device_dir == dd
    for tab in (j, t):
        tab.add([3], np.ones((1, 4), dtype=np.float32))
    np.testing.assert_array_equal(_get(j, t, [3]), np.ones((1, 4)))


def test_backings_give_one_payload_across_zipf_batches(both):
    """Zipf batches of int64 keys over the whole range (negative keys
    included), then a restore across backings: the two JAX backings and
    the two port backings hold the same values, and each port payload is
    its JAX twin's."""
    rng = np.random.default_rng(2)
    universe = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                            size=900, dtype=np.int64)
    pairs = [_pair(dd, value_dim=3, capacity=1024) for dd in BACKINGS]
    for _ in range(3):
        keys = universe[np.minimum(rng.zipf(1.3, size=300) - 1, 899)]
        vals = rng.normal(size=(300, 3)).astype(np.float32)
        for j, t in pairs:
            j.add(keys, vals)
            t.add(keys, vals)
    probe = np.concatenate([universe[:40], [1, -1]])
    for j, t in pairs:
        _same_payload(j, t)
        _get(j, t, probe)
    # A host-dict payload restores into a device directory, slots verbatim.
    _, host = pairs[0]
    _, dev = pairs[1]
    dev.load_state(host.store_state())
    np.testing.assert_array_equal(dev.get(probe), host.get(probe))


@pytest.mark.parametrize("dd", BACKINGS)
@pytest.mark.parametrize("name", ["adagrad", "momentum_sgd"])
def test_stateful_slab_against_jax_rows_math(both, dd, name):
    """A stateful slab: the JAX directory resolves the keys (its store's
    stateful Add raises, C1), then JAX's combine and ``rows_math`` give
    the expected slab and state; the port's Adds must equal them."""
    rng = np.random.default_rng(4)
    cap, dim = 64, 5
    j, t = _pair(dd, value_dim=dim, capacity=cap, updater=name)
    j_up = jupd._REGISTRY[name]()
    data = np.zeros((cap, dim), np.float32)
    state = {k: np.asarray(v).copy() for k, v in
             j_up.init_state((cap, dim), jnp.float32,
                             mvj.num_workers()).items()}
    opt = mvt.AddOption(learning_rate=0.1, rho=0.2, momentum=0.5)
    for _ in range(3):
        keys = rng.integers(-40, 40, size=24).astype(np.int64) * 1_000_003
        delta = rng.normal(size=(24, dim)).astype(np.float32)
        slots = np.asarray(j._resolve(keys, allocate=True))
        r_eff, d_c = (np.asarray(a) for a in jupd.combine_duplicate_rows(
            jnp.asarray(slots), jnp.asarray(delta), cap))
        keep = r_eff < cap
        clip = np.minimum(r_eff, cap - 1)
        st_rows = {k: jnp.asarray((v[0] if k in j_up.per_worker_state
                                   else v)[clip]) for k, v in state.items()}
        nd, ns = j_up.rows_math(jnp.asarray(data[clip]), st_rows,
                                jnp.asarray(d_c), opt.scalars())
        data[r_eff[keep]] = np.asarray(nd)[keep]
        for k in state:
            tgt = state[k][0] if k in j_up.per_worker_state else state[k]
            tgt[r_eff[keep]] = np.asarray(ns[k])[keep]
        t.add(keys, delta, opt)
    payload = t.store_state()
    assert np.array_equal(payload["data"], data)
    for k in state:
        assert np.array_equal(payload[f"state/{k}"], state[k]), k
    jp = j.store_state()
    assert np.array_equal(np.asarray(jp["kv_keys"]), payload["kv_keys"])
    assert np.array_equal(np.asarray(jp["kv_slots"]), payload["kv_slots"])
