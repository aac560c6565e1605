"""Port parity: the async checkpoint backend
(``multiverso_tpu_torch.core.checkpoint_orbax`` and
``CheckpointManager(backend="orbax")``) on the CPU, against the JAX
package's orbax backend.

Mirrors the orbax cases of ``tests/test_checkpoint.py``: the round trip,
the manager's trigger, retention over mixed ``ckpt_``/``orbax_`` roots,
the crash windows of the staging directory and ``restore_latest``. The
port writes its own format (orbax is a JAX library), so the JAX package
runs the same calls on its own tables and the two are compared by what
they restore, bitwise, and by the directories they leave. Added: Adds
issued right after ``save_all_async`` returns, which the port's row
kernels and stateful routes apply IN PLACE, must not reach the
checkpoint; bfloat16 leaves round-trip as 16-bit patterns; a tree the
JAX package's orbax backend wrote is refused with an error that names
its format.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj
from multiverso_tpu.core import checkpoint as jck
from multiverso_tpu.core import checkpoint_orbax as jco

mvt = tck = tco = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tck, tco, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.core import checkpoint as tck
    from multiverso_tpu_torch.core import checkpoint_orbax as tco


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


def _orbax_roots(path):
    return sorted(d for d in os.listdir(path)
                  if re.fullmatch(r"orbax_\d{12}", d))


def test_async_backend_roundtrip(both, tmp_path):
    """Save an adagrad array table, a matrix table and a host KV table,
    drift them, load: both packages restore the saved values bitwise."""
    got = {}
    for pkg, co, d in ((mvj, jco, tmp_path / "j"), (mvt, tco, tmp_path / "t")):
        a = pkg.create_table(pkg.ArrayTableOption(size=64, updater="adagrad",
                                                  name="ow"))
        m = pkg.create_table(pkg.MatrixTableOption(num_row=16, num_col=4,
                                                   name="om"))
        kv = pkg.create_table(pkg.KVTableOption(name="okv"))
        opt = pkg.AddOption(rho=0.1, learning_rate=0.1)
        a.add(np.ones(64, dtype=np.float32), opt)
        m.add(np.full((16, 4), 2.0, dtype=np.float32))
        kv.add([5], [1.5])
        before = (np.asarray(a.get()), np.asarray(m.get()))
        path = co.save_all(str(d), step=7)
        assert os.path.basename(path) == "orbax_000000000007"
        assert os.path.exists(os.path.join(path, "manifest.json"))
        a.add(np.ones(64, dtype=np.float32), opt)
        m.add(np.ones((16, 4), dtype=np.float32))
        kv.add([5], [10.0])
        co.load_all(path)
        got[pkg] = (np.asarray(a.get()), np.asarray(m.get()),
                    np.asarray(kv.get([5])))
        for want, have in zip(before, got[pkg]):
            assert np.array_equal(want, have)
        assert np.array_equal(got[pkg][2], [1.5])
    # The matrix and KV values match bitwise; the adagrad array within
    # the 2e-6 that XLA's jitted rewrite of a division by a square root
    # costs the JAX store (tests/test_torch_updaters.py).
    np.testing.assert_allclose(got[mvt][0], got[mvj][0], rtol=2e-6)
    for j, t in zip(got[mvj][1:], got[mvt][1:]):
        assert np.array_equal(j, t)
    meta = json.loads(open(tmp_path / "t" / "orbax_000000000007" /
                           "manifest.json").read())
    assert meta["tables"] == ["ow", "om", "okv"]
    assert meta["format"] == tco.FORMAT
    assert sorted(os.listdir(tmp_path / "t" / "orbax_000000000007" / "ow")
                  ) == ["data.npy", "leaves.json", "state_g2.npy"]


def test_checkpoint_manager_async_backend(both, tmp_path):
    """Periodic triggers stage and return, at most one save in flight,
    retention keeps the last keep_last trees, an interrupted root (no
    manifest) is invisible to restore; both packages keep the same
    roots and restore the same step and bytes."""
    out = {}
    for pkg, ck, d in ((mvj, jck, tmp_path / "j"), (mvt, tck, tmp_path / "t")):
        m = pkg.create_table(pkg.MatrixTableOption(num_row=128, num_col=16,
                                                   name="mgr_orbax"))
        mgr = ck.CheckpointManager(str(d), save_every_steps=2, keep_last=2,
                                   backend="orbax")
        snapshots = {}
        for step in range(1, 9):
            m.add(np.ones((128, 16), dtype=np.float32))
            if mgr.maybe_save(step):
                snapshots[step] = np.asarray(m.get())
        mgr.finalize()
        kept = _orbax_roots(d)
        m.add(np.ones((128, 16), dtype=np.float32))
        os.makedirs(d / "orbax_000000000099" / "mgr_orbax")
        step = mgr.restore_latest()
        assert step == max(snapshots)
        assert np.array_equal(np.asarray(m.get()), snapshots[step])
        out[pkg] = (kept, step, np.asarray(m.get()))
    assert out[mvj][0] == out[mvt][0] == ["orbax_000000000006",
                                          "orbax_000000000008"]
    assert out[mvj][1] == out[mvt][1]
    assert np.array_equal(out[mvj][2], out[mvt][2])


def test_crash_recovery_resave_and_retention(port, tmp_path):
    a = mvt.create_table(mvt.ArrayTableOption(size=32, name="crash_a"))
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=2,
                                keep_last=1, backend="orbax")
    a.add(np.ones(32, dtype=np.float32))
    assert mgr.maybe_save(2)
    mgr.finalize()
    snap = a.get()
    os.makedirs(tmp_path / "orbax_000000000004" / "crash_a")
    mgr._prune()
    assert (tmp_path / "orbax_000000000002" / "manifest.json").exists()
    a.add(np.ones(32, dtype=np.float32))
    assert mgr.restore_latest() == 2
    assert np.array_equal(a.get(), snap)
    mgr._last_saved_step = -1
    a.add(np.ones(32, dtype=np.float32))
    assert mgr.maybe_save(4)
    mgr.finalize()
    assert (tmp_path / "orbax_000000000004" / "manifest.json").exists()
    assert not (tmp_path / "orbax_000000000002").exists()   # keep_last 1
    os.makedirs(tmp_path / "orbax_000000000003")
    mgr._prune()
    assert not (tmp_path / "orbax_000000000003").exists()


def test_manifested_staging_is_restorable(port, tmp_path):
    a = mvt.create_table(mvt.ArrayTableOption(size=16, name="stage_a"))
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=1,
                                keep_last=2, backend="orbax")
    a.add(np.ones(16, dtype=np.float32))
    mgr.maybe_save(1)
    mgr.finalize()
    a.add(np.ones(16, dtype=np.float32))
    mgr._last_saved_step = -1
    mgr.maybe_save(3)
    mgr.finalize()
    shutil.move(str(tmp_path / "orbax_000000000003"),
                str(tmp_path / "orbax_000000000003.tmp-99999"))
    mgr._prune()
    assert (tmp_path / "orbax_000000000003.tmp-99999").exists()
    a.add(np.ones(16, dtype=np.float32))
    assert mgr.restore_latest() == 3
    assert np.array_equal(a.get(), np.full(16, 2.0, np.float32))
    mgr._last_saved_step = -1
    mgr.maybe_save(4)
    mgr.finalize()
    mgr._prune()
    assert not (tmp_path / "orbax_000000000003.tmp-99999").exists()


def test_async_save_overlaps_training(port, tmp_path):
    m = mvt.create_table(mvt.MatrixTableOption(num_row=512, num_col=64,
                                               name="async_m"))
    m.add(np.ones((512, 64), dtype=np.float32))
    snap = m.get()
    handle = tco.save_all_async(str(tmp_path), step=3)
    assert handle.staged_s >= 0 and handle.total_s is None
    for _ in range(3):
        m.add(np.ones((512, 64), dtype=np.float32))
    path = handle.wait_until_finished()
    assert path == handle.root and handle.total_s >= handle.staged_s
    assert np.array_equal(m.get(), np.full((512, 64), 4.0, np.float32))
    tco.load_all(path)
    assert np.array_equal(m.get(), snap)
    assert handle.wait_until_finished() == path


@pytest.mark.parametrize("updater", ["sgd", "adagrad", "default"])
def test_in_place_adds_after_save_stay_out(port, tmp_path, updater):
    """``use_pallas`` tables update ``store.data`` (and the fused stateful
    route every state leaf) IN PLACE. Row Adds issued right after
    ``maybe_save`` returns must be absent from the loaded checkpoint:
    the snapshot is the pre-Add table, bitwise, leaves included."""
    rng = np.random.default_rng(0)
    m = mvt.create_table(mvt.MatrixTableOption(
        num_row=256, num_col=8, name="inplace", updater=updater,
        use_pallas=True))
    opt = mvt.AddOption(learning_rate=0.1, rho=0.1)
    ids = rng.integers(0, 256, 300).astype(np.int32)
    m.add_rows(ids, rng.normal(size=(300, 8)).astype(np.float32), opt)
    before = {k: v.copy() for k, v in m.store.store_state().items()}
    data_ptr = m.store.data.data_ptr()
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=1,
                                backend="orbax")
    assert mgr.maybe_save(1)
    for _ in range(3):
        m.add_rows(ids, rng.normal(size=(300, 8)).astype(np.float32), opt)
    if updater != "default":       # the kernels' routes: in place
        assert m.store.data.data_ptr() == data_ptr
    after = {k: v.copy() for k, v in m.store.store_state().items()}
    assert not np.array_equal(after["data"], before["data"])
    mgr.finalize()
    assert mgr.restore_latest() == 1
    restored = m.store.store_state()
    assert sorted(restored) == sorted(before)
    for k in before:
        assert np.array_equal(restored[k], before[k]), k


def test_staging_buffers_are_reused(port, tmp_path):
    m = mvt.create_table(mvt.MatrixTableOption(num_row=64, num_col=8,
                                               updater="adagrad",
                                               name="reuse"))
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=1,
                                backend="orbax")
    mgr.maybe_save(1)
    bufs = dict(mgr._staging._bufs)
    assert sorted(k[1] for k in bufs) == ["data", "state_g2"]
    mgr.maybe_save(2)
    assert all(mgr._staging._bufs[k] is v for k, v in bufs.items())
    assert mgr._staging.nbytes == 64 * 8 * 4 * 2
    mgr.finalize()
    assert mgr.last_handle.total_s is not None


def test_failed_async_save_never_commits(port, tmp_path, monkeypatch):
    """A writer that fails makes the join raise, and a second join (a
    caller that survived the error and calls ``finalize`` again, or the
    next ``maybe_save``) must not manifest the partial tree: no
    ``orbax_`` root, no staging directory, and ``restore_latest`` finds
    the earlier complete save."""
    m = mvt.create_table(mvt.MatrixTableOption(num_row=64, num_col=8,
                                               name="fails"))
    m.add(np.ones((64, 8), dtype=np.float32))
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=1,
                                keep_last=3, backend="orbax")
    mgr.maybe_save(1)
    mgr.finalize()
    snap = m.get()
    real = tco._write_table

    def broken(path, leaves, event):
        real(path, leaves, event)
        raise OSError("disk full")

    monkeypatch.setattr(tco, "_write_table", broken)
    m.add(np.ones((64, 8), dtype=np.float32))
    mgr.maybe_save(2)
    with pytest.raises(OSError, match="disk full"):
        mgr.finalize()
    mgr.finalize()
    assert _orbax_roots(str(tmp_path)) == ["orbax_000000000001"]
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]
    monkeypatch.setattr(tco, "_write_table", real)
    assert mgr.restore_latest() == 1
    assert np.array_equal(m.get(), snap)


def test_bfloat16_leaves_roundtrip_as_16_bits(port, tmp_path):
    t = mvt.create_table(mvt.MatrixTableOption(
        num_row=8, num_col=4, dtype="bfloat16", updater="momentum_sgd",
        name="bf"))
    t.add(np.full((8, 4), 0.3, np.float32), mvt.AddOption(momentum=0.5))
    before = t.store.store_state()
    path = tco.save_all(str(tmp_path), step=1)
    leaves = json.loads(open(os.path.join(path, "bf", "leaves.json")).read())
    assert leaves["leaves"] == {"data": "bfloat16",
                                "state_smooth": "bfloat16"}
    raw = np.load(os.path.join(path, "bf", "data.npy"))
    assert raw.dtype == np.uint16 and raw.nbytes == 8 * 4 * 2
    t.add(np.ones((8, 4), np.float32), mvt.AddOption(momentum=0.5))
    tco.load_all(path)
    assert t.store.data.dtype == torch.bfloat16
    for k, v in t.store.store_state().items():
        assert np.array_equal(v, before[k]), k


def test_load_all_refuses_a_jax_orbax_tree(both, tmp_path):
    """A tree the JAX package's orbax backend wrote is refused with an
    error naming its format, never misread."""
    jt = mvj.create_table(mvj.MatrixTableOption(num_row=8, num_col=4,
                                                name="x"))
    jt.add(np.ones((8, 4), np.float32))
    path = jco.save_all(str(tmp_path), step=5)
    mvt.create_table(mvt.MatrixTableOption(num_row=8, num_col=4, name="x"))
    with pytest.raises(tco.CheckpointFormatError, match="orbax"):
        tco.load_all(path)
    mgr = tck.CheckpointManager(str(tmp_path), backend="orbax")
    with pytest.raises(tco.CheckpointFormatError, match="JAX package"):
        mgr.restore_latest()
    # A port tree whose table directory lost its format mark is refused.
    mine = tco.save_all(str(tmp_path / "p"), step=1)
    os.unlink(os.path.join(mine, "x", "leaves.json"))
    with open(os.path.join(mine, "x", "leaves.json"), "w") as f:
        json.dump({"leaves": {"data": "float32"}}, f)
    with pytest.raises(tco.CheckpointFormatError):
        tco.load_all(mine)


def test_async_checkpoint_on_card_keeps_the_snapshot():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned buffers and the stream event")
    import tempfile
    mvt.init([])
    m = mvt.create_table(mvt.MatrixTableOption(
        num_row=100_000, num_col=50, updater="adagrad", use_pallas=True,
        name="card"))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100_000, 20_000).astype(np.int32)
    m.add_rows(ids, rng.normal(size=(20_000, 50)).astype(np.float32))
    before = m.store.store_state()
    with tempfile.TemporaryDirectory() as d:
        handle = tco.save_all_async(d, 1)
        for _ in range(5):
            m.add_rows(ids, rng.normal(size=(20_000, 50)).astype(np.float32))
        tco.load_all(handle.wait_until_finished())
    for k, v in m.store.store_state().items():
        assert np.array_equal(v, before[k]), k
    mvt.shutdown()
