"""Port parity: the device hash directory (``ops/device_hash``) and the
device KV table's directory backing, on the CPU against the JAX package.

Mirrors ``tests/test_device_hash.py`` case by case. Every case runs the
same key batches through both packages and holds the port BITWISE to JAX:
the directory arrays (``k_hi``, ``k_lo``, ``slot``), ``next_slot``, the
slots returned, and the overflow flag.
"""

import numpy as np
import pytest

import _torch_port
import jax

from multiverso_tpu.ops import device_hash as jdh

tdh = mvt = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global tdh, mvt, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.ops import device_hash as tdh


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


def _split(keys):
    hi, lo = jdh.split_keys(np.asarray(keys, dtype=np.int64))
    thi, tlo = tdh.split_keys(np.asarray(keys, dtype=np.int64))
    assert np.array_equal(hi, thi) and np.array_equal(lo, tlo)
    return hi, lo


def _same_dir(js, ts):
    assert np.array_equal(np.asarray(js.k_hi), ts.k_hi.numpy())
    assert np.array_equal(np.asarray(js.k_lo), ts.k_lo.numpy())
    assert np.array_equal(np.asarray(js.slot), ts.slot.numpy())
    assert int(js.next_slot) == ts.next_slot
    assert int(js.capacity) == ts.capacity


class _Pair:
    """One directory in each package, driven by the same calls."""

    def __init__(self, cap):
        self.j = jdh.make_state(cap)
        self.t = tdh.make_state(cap)
        _same_dir(self.j, self.t)

    def insert(self, keys):
        hi, lo = _split(keys)
        self.j, js, jo = jdh.insert(self.j, hi, lo)
        self.t, ts, to = tdh.insert(self.t, hi, lo)
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert bool(jo) == to
        _same_dir(self.j, self.t)
        return ts.numpy(), to

    def lookup(self, keys):
        hi, lo = _split(keys)
        js = np.asarray(jdh.lookup(self.j, hi, lo))
        ts = tdh.lookup(self.t, hi, lo).numpy()
        assert np.array_equal(js, ts)
        return ts

    def preassign(self, keys, slots):
        hi, lo = _split(keys)
        slots = np.asarray(slots, dtype=np.int32)
        self.j, jo = jdh.insert_preassigned(self.j, hi, lo, slots)
        self.t, to = tdh.insert_preassigned(self.t, hi, lo, slots)
        assert bool(jo) == to
        _same_dir(self.j, self.t)
        return to


def test_mix_matches_jax_on_high_bit_and_negative_keys():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     size=4096, dtype=np.int64),
        np.asarray([0, -1, 1, (1 << 63) - 1, -(1 << 63), 1 << 31,
                    (1 << 32) - 1, -(1 << 31), 0x9E3779B9], np.int64)])
    hi, lo = _split(keys)
    want = np.asarray(jdh._mix(jax.numpy.asarray(hi),
                               jax.numpy.asarray(lo))).view(np.uint32)
    got = tdh._mix(torch.as_tensor(hi), torch.as_tensor(lo)).numpy()
    assert np.array_equal(want.astype(np.int64), got)


def test_lookup_miss_on_empty():
    p = _Pair(8)
    assert (p.lookup([1, 2, 1 << 40]) == -1).all()


def test_insert_then_lookup_roundtrip():
    p = _Pair(16)
    keys = [5, 17, -3, 1 << 35, 0]
    slots, overflow = p.insert(keys)
    assert not overflow
    assert sorted(slots.tolist()) == list(range(len(keys)))
    np.testing.assert_array_equal(p.lookup(keys), slots)
    assert (p.lookup([1234, 9999]) == -1).all()


def test_duplicate_keys_within_batch_converge():
    p = _Pair(8)
    slots, overflow = p.insert([42, 7, 42, 42, 7])
    assert not overflow
    assert slots[0] == slots[2] == slots[3]
    assert slots[1] == slots[4] and slots[0] != slots[1]
    assert p.t.next_slot == 2


def test_multi_round_contention_dense_batch():
    cap = 64
    p = _Pair(cap)
    keys = np.arange(cap, dtype=np.int64) * 7919 + 1
    slots, overflow = p.insert(keys)
    assert not overflow
    assert sorted(slots.tolist()) == list(range(cap))
    np.testing.assert_array_equal(p.lookup(keys), slots)


def test_contention_takes_several_rounds_like_jax():
    """A full slab of keys that collide in few buckets: several claim
    rounds, same slot ids as JAX."""
    p = _Pair(256)
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 62), 1 << 62, size=256, dtype=np.int64)
    slots, overflow = p.insert(keys)
    assert not overflow
    assert tdh.ROUNDS["insert_rounds"] >= 2
    np.testing.assert_array_equal(p.lookup(keys), slots)


def test_slab_overflow_detected_before_directory_full():
    p = _Pair(8)
    slots, overflow = p.insert(np.arange(12, dtype=np.int64) + 100)
    assert overflow
    assert slots.max() < 8 and p.t.next_slot <= 8
    assert p.t.slot.max().item() < 8


def test_incremental_fill_then_overflow():
    p = _Pair(4)
    s1, ov = p.insert([1, 2])
    assert not ov
    s2, ov = p.insert([3, 4])
    assert not ov
    _, ov = p.insert([5])
    assert ov
    np.testing.assert_array_equal(p.lookup([1, 2, 3, 4]),
                                  np.concatenate([s1, s2]))


def test_reinsert_existing_allocates_nothing():
    p = _Pair(8)
    first, _ = p.insert([11, 22])
    again, overflow = p.insert([11, 22])
    assert not overflow
    np.testing.assert_array_equal(first, again)
    assert p.t.next_slot == 2


def test_high_bit_keys_mix_unsigned():
    p = _Pair(32)
    keys = [-1, -2, -(1 << 40), (1 << 63) - 1, -(1 << 62)]
    slots, overflow = p.insert(keys)
    assert not overflow
    assert sorted(slots.tolist()) == list(range(len(keys)))
    np.testing.assert_array_equal(p.lookup(keys), slots)


def test_zipf_batches_with_duplicates_and_negative_keys():
    """Zipf-skewed batches over the whole int64 range (negative keys and
    keys with the top bit of either half set), several batches into one
    directory: every slot, every array bitwise JAX's."""
    rng = np.random.default_rng(11)
    universe = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                            size=3000, dtype=np.int64)
    p = _Pair(4096)
    for _ in range(4):
        keys = universe[np.minimum(rng.zipf(1.2, size=700) - 1,
                                   len(universe) - 1)]
        _, overflow = p.insert(keys)
        assert not overflow
    p.lookup(np.concatenate([universe[:50], [7, -7]]))


def test_insert_preassigned_reproduces_mapping():
    p = _Pair(16)
    keys = np.arange(10, dtype=np.int64) * 1_000_003
    slots, _ = p.insert(keys)
    perm = np.random.RandomState(0).permutation(10)
    q = _Pair(16)
    assert not q.preassign(keys[perm], slots[perm])
    np.testing.assert_array_equal(q.lookup(keys), slots)
    assert q.t.next_slot == 10


def test_insert_preassigned_overflow_on_bad_slot():
    p = _Pair(4)
    assert p.preassign([1], [7])


def test_insert_preassigned_conflict_reported():
    p = _Pair(8)
    slots, _ = p.insert([42])
    assert slots[0] == 0
    assert p.preassign([42], [5])


def test_full_slab_restores_verbatim():
    """A slab filled to capacity, restored from its (key, slot) pairs in
    bucket order: the rebuilt directory is bitwise the original's."""
    p = _Pair(64)
    rng = np.random.default_rng(5)
    keys = rng.integers(-(1 << 62), 1 << 62, size=64, dtype=np.int64)
    slots, overflow = p.insert(keys)
    assert not overflow and p.t.next_slot == 64
    occ = p.t.slot >= 0
    saved_keys = tdh.join_keys(p.t.k_hi[occ].numpy(), p.t.k_lo[occ].numpy())
    q = _Pair(64)
    assert not q.preassign(saved_keys, p.t.slot[occ].numpy())
    np.testing.assert_array_equal(q.lookup(keys), slots)


def test_device_directory_requires_device_flag():
    with pytest.raises(ValueError):
        mvt.KVTableOption(device_directory=True, capacity=8)


# -- DeviceKVTable wiring ---------------------------------------------------

@pytest.fixture
def port():
    mvt.init(["-platform=cpu"])
    yield mvt
    mvt.shutdown()


def _dir_table(**kw):
    from multiverso_tpu_torch.tables.device_kv_table import DeviceKVTable
    return DeviceKVTable(mvt.KVTableOption(device=True,
                                           device_directory=True, **kw))


def test_kv_device_directory_semantics(port):
    t = _dir_table(capacity=64)
    t.add([10, 99, 10**12], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(t.get([10, 99, 10**12]), [1.0, 2.0, 3.0])
    t.add([99], [10.0])
    np.testing.assert_array_equal(t.get([99]), [12.0])
    np.testing.assert_array_equal(t.get([555]), [0.0])
    assert len(t) == 3


def test_kv_device_directory_capacity_fatal(port):
    from multiverso_tpu_torch.utils.log import FatalError
    t = _dir_table(capacity=2)
    t.add([1, 2], [1.0, 1.0])
    with pytest.raises(FatalError):
        t.add([3], [1.0])


def test_kv_device_directory_checkpoint_roundtrip(port, tmp_path):
    from multiverso_tpu_torch.core import checkpoint as ckpt
    t = _dir_table(capacity=32, name="dkvdir")
    t.add([100, 200, 300], [1.0, 2.0, 3.0])
    uri = f"file://{tmp_path}/dkvdir.npz"
    ckpt.save_table(t, uri)
    t.add([100, 400], [50.0, 7.0])
    ckpt.load_table(t, uri)
    np.testing.assert_array_equal(t.get([100, 200, 300, 400]),
                                  [1.0, 2.0, 3.0, 0.0])
    assert len(t) == 3


def test_factory_routes_device_directory(port):
    from multiverso_tpu_torch.tables.device_kv_table import DeviceKVTable
    t = mvt.create_table(mvt.KVTableOption(device=True, device_directory=True,
                                           capacity=16, value_dim=4))
    assert isinstance(t, DeviceKVTable) and t._device_dir
    t.add([3], np.ones((1, 4), dtype=np.float32))
    np.testing.assert_array_equal(t.get([3]), np.ones((1, 4)))
