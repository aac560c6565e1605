"""Port parity: the URI stream layer (``utils/stream``) and npz checkpoints
(``core/checkpoint``) on the CPU, against the JAX package.

Mirrors ``tests/test_checkpoint.py`` except its orbax cases, which
``tests/test_torch_async_checkpoint.py`` mirrors (the port's async
backend). The npz file format is shared, so checkpoints cross between the
packages in both directions and are compared BITWISE: every payload
entry, bfloat16 included, which both packages store as its 16-bit pattern
(2 bytes an element) under the ``__extension_dtypes__`` tag. The JAX
store's stateful row Add raises on this tree's jax (ROADMAP C1), so
stateful JAX tables are only created and saved, never row-updated.
"""

import io
import os

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj
from multiverso_tpu.core import checkpoint as jck

mvt = tck = stream = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tck, stream, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.core import checkpoint as tck
    from multiverso_tpu_torch.utils import stream


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
def port():
    mvt.init(["-platform=cpu"])
    yield mvt
    mvt.shutdown()


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()


# -- streams ------------------------------------------------------------------

def test_stream_roundtrip(tmp_path):
    uri = f"file://{tmp_path}/sub/dir/data.bin"
    with stream.open_stream(uri, "w") as s:
        s.write(b"hello multiverso")
    assert stream.exists(uri)
    with stream.open_stream(uri, "r") as s:
        assert s.read() == b"hello multiverso"


def test_plain_path_is_file_scheme(tmp_path):
    p = str(tmp_path / "x.bin")
    with stream.open_stream(p, "w") as s:
        s.write(b"1")
    assert stream.exists(p)


def test_atomic_write_aborts_on_error(tmp_path):
    p = str(tmp_path / "keep.bin")
    with stream.open_stream(p, "w") as s:
        s.write(b"good")
    with pytest.raises(RuntimeError):
        with stream.open_stream(p, "w") as s:
            s.write(b"half")
            raise RuntimeError("died mid-write")
    with open(p, "rb") as f:
        assert f.read() == b"good"
    assert os.listdir(tmp_path) == ["keep.bin"]


def test_unknown_and_gated_schemes(monkeypatch):
    monkeypatch.delenv("STORAGE_EMULATOR_HOST", raising=False)
    monkeypatch.delenv("GCS_OAUTH_TOKEN", raising=False)
    with pytest.raises(stream.StreamError):
        stream.open_stream("weird://x", "r")
    with pytest.raises(stream.StreamError, match="STORAGE_EMULATOR_HOST"):
        stream.open_stream("gs://bucket/obj", "r")


def test_register_scheme(tmp_path):
    calls = []

    def opener(path, mode):
        calls.append(path)
        return open(str(tmp_path / "custom.bin"), mode + "b")

    stream.register_scheme("mem", opener)
    with stream.open_stream("mem://anything", "w") as s:
        s.write(b"x")
    assert calls == ["anything"]


def test_text_reader(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("alpha\nbeta\r\ngamma")
    with stream.TextReader(f"file://{p}") as r:
        assert list(r) == ["alpha", "beta", "gamma"]
        assert r.get_line() is None


@pytest.fixture
def fake_gcs(monkeypatch):
    from test_checkpoint import _FakeGCS
    gcs = _FakeGCS()
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", gcs.address)
    yield gcs
    gcs.close()


def test_gcs_stream_roundtrip_and_exists(fake_gcs):
    with stream.open_stream("gs://bucket/dir/blob.bin", "w") as s:
        s.write(b"payload-123")
    assert fake_gcs.store["bucket/dir/blob.bin"] == b"payload-123"
    with stream.open_stream("gs://bucket/dir/blob.bin", "r") as s:
        assert s.read() == b"payload-123"
    assert stream.exists("gs://bucket/dir/blob.bin")
    assert not stream.exists("gs://bucket/missing")
    with pytest.raises(stream.StreamError):
        stream.open_stream("gs://bucket/missing", "r")


def test_gcs_aborted_write_preserves_old_object(fake_gcs):
    with stream.open_stream("gs://bucket/ckpt.bin", "w") as s:
        s.write(b"good-checkpoint")
    with pytest.raises(RuntimeError):
        with stream.open_stream("gs://bucket/ckpt.bin", "w") as s:
            s.write(b"half-")
            raise RuntimeError("died mid-write")
    with stream.open_stream("gs://bucket/ckpt.bin", "r") as s:
        assert s.read() == b"good-checkpoint"


def test_checkpoint_through_gcs_scheme(fake_gcs, port):
    table = mvt.create_table(mvt.ArrayTableOption(size=64, name="gcs_ckpt"))
    table.add(np.arange(64, dtype=np.float32))
    tck.save_table(table, "gs://ckpts/run1/table.npz")
    table.add(np.ones(64, dtype=np.float32))
    tck.load_table(table, "gs://ckpts/run1/table.npz")
    np.testing.assert_array_equal(table.get(), np.arange(64))


def test_word2vec_save_takes_uris(port, tmp_path):
    from multiverso_tpu_torch.models.word2vec import (Dictionary, Word2Vec,
                                                      Word2VecConfig)
    d = Dictionary.build([["a", "b", "a"], ["c", "a"]], min_count=1)
    w = Word2Vec(Word2VecConfig(embedding_size=4, device_pipeline=False), d)
    w.save(str(tmp_path / "plain.txt"))
    w.save(f"file://{tmp_path}/uri.txt")
    plain = (tmp_path / "plain.txt").read_text()
    assert plain == (tmp_path / "uri.txt").read_text()
    assert plain.splitlines()[0] == "3 4"


# -- table checkpoints ----------------------------------------------------------

def test_array_table_store_load(port, tmp_path):
    t = mvt.create_table(mvt.ArrayTableOption(size=100, updater="adagrad"))
    opt = mvt.AddOption(rho=0.1, learning_rate=0.1)
    t.add(np.ones(100, dtype=np.float32), opt)
    before = t.get()
    uri = f"file://{tmp_path}/array.npz"
    tck.save_table(t, uri)
    t.add(np.ones(100, dtype=np.float32), opt)
    assert not np.array_equal(t.get(), before)
    tck.load_table(t, uri)
    np.testing.assert_array_equal(t.get(), before)
    t.add(np.ones(100, dtype=np.float32), opt)
    replay = t.get()
    tck.load_table(t, uri)
    t.add(np.ones(100, dtype=np.float32), opt)
    np.testing.assert_array_equal(t.get(), replay)


def test_save_all_load_all(port, tmp_path):
    a = mvt.create_table(mvt.ArrayTableOption(size=10, name="weights"))
    m = mvt.create_table(mvt.MatrixTableOption(num_row=4, num_col=4,
                                               name="embed"))
    kv = mvt.create_table(mvt.KVTableOption(name="counts"))
    a.add(np.ones(10, dtype=np.float32))
    m.add(np.full((4, 4), 2.0, dtype=np.float32))
    kv.add([7], [3.0])
    path = tck.save_all(str(tmp_path), step=42)
    assert os.path.exists(os.path.join(path, "meta.json"))
    assert tck.checkpoint_manifests(path)[0]["tables"] == \
        ["weights", "embed", "counts"]
    a.add(np.ones(10, dtype=np.float32))
    kv.add([7], [10.0])
    assert tck.load_all(path) == 42
    np.testing.assert_array_equal(a.get(), np.ones(10))
    np.testing.assert_array_equal(m.get(), np.full((4, 4), 2.0))
    np.testing.assert_array_equal(kv.get([7]), [3.0])


def test_checkpoint_manager_periodic_and_resume(port, tmp_path):
    t = mvt.create_table(mvt.ArrayTableOption(size=4, name="w"))
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=10,
                                keep_last=2)
    for step in range(1, 41):
        t.add(np.ones(4, dtype=np.float32))
        mgr.maybe_save(step)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert kept == ["ckpt_000000000030", "ckpt_000000000040"]
    assert tck.latest_checkpoint(str(tmp_path)).endswith(kept[-1])
    t.add(np.full(4, 100.0, dtype=np.float32))
    assert mgr.restore_latest() == 40
    np.testing.assert_array_equal(t.get(), np.full(4, 40.0))


def test_restore_latest_empty_dir(port, tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "nope"))
    assert mgr.restore_latest() is None


def test_orbax_backend_raises_citing_a4(port, tmp_path):
    """The async backend that raised "ROADMAP A4" is ported: the manager
    takes it, saves an ``orbax_<step>`` tree and restores it."""
    t = mvt.create_table(mvt.ArrayTableOption(size=4, name="a4"))
    mgr = tck.CheckpointManager(str(tmp_path), backend="orbax")
    t.add(np.ones(4, dtype=np.float32))
    assert mgr.maybe_save(1000).endswith("orbax_000000001000")
    mgr.finalize()
    t.add(np.ones(4, dtype=np.float32))
    assert mgr.restore_latest() == 1000
    np.testing.assert_array_equal(t.get(), np.ones(4))
    with pytest.raises(Exception, match="unknown backend"):
        tck.CheckpointManager(str(tmp_path), backend="zarr")


def _layout(root):
    """Checkpoint dirs of both backings, complete and not, plus staging."""
    def mk(name, marker=None):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        if marker:
            open(os.path.join(root, name, marker), "w").close()
    for step in (1, 3, 5):
        mk(f"ckpt_{step:012d}", "meta.json")
    for step in (2, 4):
        mk(f"orbax_{step:012d}", "manifest.json")
    mk(f"ckpt_{0:012d}")                          # crash garbage
    mk(f"orbax_{6:012d}")                         # newer, incomplete
    mk(f"orbax_{2:012d}.tmp-7", "manifest.json")  # superseded staging
    mk(f"orbax_{9:012d}.tmp-8", "manifest.json")  # newest staging


def test_prune_treats_orbax_trees_as_jax_does(tmp_path):
    """A directory that already holds orbax trees is pruned exactly as
    the JAX package's manager prunes it, and both list the same
    manifested orbax candidates."""
    _layout(tmp_path / "j")
    _layout(tmp_path / "t")
    jm = jck.CheckpointManager(str(tmp_path / "j"), keep_last=2)
    tm = tck.CheckpointManager(str(tmp_path / "t"), keep_last=2)
    assert sorted(jm._orbax_candidates()) == sorted(tm._orbax_candidates())
    jm._prune()
    tm._prune()
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "t")) == [
        "ckpt_000000000005", "orbax_000000000004", "orbax_000000000006",
        "orbax_000000000009.tmp-8"]


def test_bf16_momentum_state_dtype_roundtrip(port, tmp_path):
    t = mvt.create_table(mvt.MatrixTableOption(
        num_row=8, num_col=4, dtype="bfloat16", updater="momentum_sgd"))
    t.add(np.ones((8, 4), dtype=np.float32), mvt.AddOption(momentum=0.5))
    uri = f"file://{tmp_path}/bf16m.npz"
    before = {k: v.copy() for k, v in t.store.store_state().items()}
    tck.save_table(t, uri)
    t.add(np.ones((8, 4), dtype=np.float32), mvt.AddOption(momentum=0.5))
    tck.load_table(t, uri)
    assert t.store.state["smooth"].dtype == torch.bfloat16
    assert t.store.data.dtype == torch.bfloat16
    after = t.store.store_state()
    for k in before:
        assert np.array_equal(before[k], after[k]), k
    t.add(np.ones((8, 4), dtype=np.float32), mvt.AddOption(momentum=0.5))
    assert t.store.data.dtype == torch.bfloat16


# -- across the two packages ----------------------------------------------------

def _tables(mv, seed_rng):
    """The same set of tables, in the same order, in either package. The
    stateful ones are created with random data and never row-updated."""
    bf16 = np.dtype("bfloat16") if mv is mvj else "bfloat16"
    out = {
        "arr": mv.create_table(mv.ArrayTableOption(size=33, name="arr",
                                                   updater="sgd")),
        "mat": mv.create_table(mv.MatrixTableOption(
            20, 7, name="mat", random_init=True, seed=4)),
        "bf": mv.create_table(mv.MatrixTableOption(
            20, 7, dtype=bf16, name="bf", random_init=True, seed=5)),
        "bfm": mv.create_table(mv.MatrixTableOption(
            12, 3, dtype=bf16, name="bfm", random_init=True, seed=6,
            updater="momentum_sgd")),
        "ada": mv.create_table(mv.MatrixTableOption(
            20, 7, name="ada", random_init=True, seed=7, updater="adagrad",
            use_pallas=True)),
        "sp": mv.create_table(mv.MatrixTableOption(
            20, 7, name="sp", is_sparse=True, random_init=True, seed=8)),
        "kv": mv.create_table(mv.KVTableOption(name="kv")),
        "dkv": mv.create_table(mv.KVTableOption(
            name="dkv", device=True, device_directory=True, capacity=64,
            value_dim=2)),
        "hkv": mv.create_table(mv.KVTableOption(
            name="hkv", device=True, capacity=64, value_dim=2)),
    }
    rng = np.random.default_rng(seed_rng)
    out["arr"].add(rng.normal(size=33).astype(np.float32))
    ids = rng.integers(0, 20, size=9).astype(np.int32)
    deltas = rng.normal(size=(9, 7)).astype(np.float32)
    out["mat"].add_rows(ids, deltas)
    out["sp"].add_rows(ids, deltas)
    out["bf"].add_rows(ids, deltas)
    keys = rng.integers(-(1 << 62), 1 << 62, size=10, dtype=np.int64)
    vals = rng.normal(size=(10, 2)).astype(np.float32)
    out["kv"].add(keys, vals[:, 0])
    out["dkv"].add(keys, vals)
    out["hkv"].add(keys, vals)
    return out


def _payload(table):
    return table.store_state() if hasattr(table, "store_state") \
        else table.store.store_state()


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype.name == "bfloat16" else v


def test_checkpoints_cross_between_packages_bitwise(both, tmp_path):
    jt, tt = _tables(mvj, 1), _tables(mvt, 1)
    saved = {name: _payload(t) for name, t in jt.items()}
    probe = np.asarray([0, 1, -5], np.int64)
    dkv_probe = tt["dkv"].get(probe)
    jpath = jck.save_all(str(tmp_path / "jax"), step=3)
    tpath = tck.save_all(str(tmp_path / "port"), step=3)
    # The two files of every table hold the same entries, bit for bit,
    # bfloat16 as 2 bytes an element.
    for name in jt:
        with np.load(os.path.join(jpath, f"{name}.npz")) as jf, \
                np.load(os.path.join(tpath, f"{name}.npz")) as tf:
            assert sorted(jf.files) == sorted(tf.files), name
            for k in jf.files:
                assert jf[k].dtype == tf[k].dtype, (name, k)
                assert np.array_equal(jf[k], tf[k]), (name, k)
    with np.load(os.path.join(tpath, "bf.npz")) as f:
        assert f["data"].dtype == np.uint16 and f["data"].nbytes == 20 * 7 * 2
    # The JAX reader sees the port's bfloat16 entries as bfloat16.
    jp = jck.read_table_payload(os.path.join(tpath, "bfm.npz"))
    assert jp["data"].dtype.name == "bfloat16"
    assert jp["state/smooth"].dtype.name == "bfloat16"
    # Each package loads the other's checkpoint into fresh tables.
    mvt.shutdown()
    mvj.shutdown()
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    jt2, tt2 = _tables(mvj, 2), _tables(mvt, 2)
    assert tck.load_all(jpath) == 3
    assert jck.load_all(tpath) == 3
    for name in jt:
        want, got = saved[name], _payload(tt2[name])
        back = _payload(jt2[name])
        assert sorted(want) == sorted(got) == sorted(back), name
        for k in want:
            w = _bits(want[k])
            g = np.asarray(got[k])
            if np.asarray(want[k]).dtype.name == "bfloat16":
                g = tck.bfloat16_bits(g)
            assert np.array_equal(w, g), (name, k)
            assert np.array_equal(w, _bits(back[k])), (name, k)
    # The device directory was rebuilt slot for slot.
    assert np.array_equal(tt2["dkv"].get(probe), dkv_probe)


def test_bfloat16_codec_is_exact_on_every_pattern():
    """Every finite bfloat16 pattern survives widen -> bits exactly."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    wide = tck.bfloat16_widen(bits)
    finite = np.isfinite(wide)
    assert np.array_equal(tck.bfloat16_bits(wide)[finite], bits[finite])
    t = torch.from_numpy(wide[finite].copy()).to(torch.bfloat16)
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          bits[finite])


def test_read_table_payload_needs_no_live_table(port, tmp_path):
    t = mvt.create_table(mvt.MatrixTableOption(6, 2, dtype="bfloat16",
                                               name="ro", random_init=True))
    uri = f"file://{tmp_path}/ro.npz"
    tck.save_table(t, uri)
    payload = tck.read_table_payload(uri)
    assert payload["data"].dtype == np.float32
    assert np.array_equal(payload["data"], t.get())
    buf = io.BytesIO(open(f"{tmp_path}/ro.npz", "rb").read())
    with np.load(buf) as f:
        assert f["__extension_dtypes__"].tolist() == ["data=bfloat16"]
