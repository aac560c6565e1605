"""Port parity: the PS service against the JAX package's, on the CPU.

* The same Add/Get sequence through an in-process JAX ``PSService`` pair
  and a port pair gives bitwise the same replies, for the default and sgd
  updaters, dense and by rows (duplicates included), under every wire
  mode (``-wire_compression``).
* Stateful shards (adagrad, momentum_sgd, ftrl) are held against the JAX
  ``Updater.rows_math`` on the combined duplicate rows, Add by Add (the
  JAX store's stateful row Add itself raises on this tree's jax, ROADMAP
  C1): bitwise.
* Wire compatibility: a world of one JAX rank and one port rank, each
  client reading and writing the other's shard over loopback TCP, ends
  bitwise where a world of two JAX ranks does (the port keeps the JAX
  framing and payload codec).
* A write-ahead log written by a JAX shard replays into a port shard
  bitwise, and the reverse (the record format is the JAX package's).
"""

import numpy as np
import pytest

import _torch_port
import jax
import jax.numpy as jnp

import multiverso_tpu as mvj
from multiverso_tpu.core import updater as jupd
from multiverso_tpu.parallel import ps_service as jps
from multiverso_tpu.utils import configure as jconf

mvt = tps = tconf = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tps, tconf
    _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.parallel import ps_service as tps
    from multiverso_tpu_torch.utils import configure as tconf


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()
    from multiverso_tpu_torch.core.zoo import Zoo
    Zoo._reset_for_tests()
    tconf.reset_flags()
    jconf.set_flag("wire_compression", "sparse")


ROWS, COLS, SIZE = 40, 6, 30


def _world(kinds, updater):
    """Two services, a matrix and an array table on each; ``kinds`` gives
    the package of rank 0 and of rank 1."""
    svcs = [k.PSService() for k in kinds]
    peers = [s.address for s in svcs]
    mats = [k.DistributedMatrixTable(7, ROWS, COLS, svcs[r], peers, r,
                                     updater=updater)
            for r, k in enumerate(kinds)]
    arrs = [k.DistributedArrayTable(8, SIZE, svcs[r], peers, r,
                                    updater=updater)
            for r, k in enumerate(kinds)]
    return svcs, mats, arrs


def _drive(mats, arrs, seed):
    """One Add/Get sequence; returns every reply (as bytes) in order."""
    rng = np.random.default_rng(seed)
    replies = []
    for step in range(6):
        ids = rng.integers(0, ROWS, size=25).astype(np.int32)
        d = rng.normal(size=(25, COLS)).astype(np.float32)
        d[rng.random(d.shape) < 0.6] = 0.0        # sparse-mode payloads
        mats[step % 2].add_rows(ids, d)
        arrs[(step + 1) % 2].add(rng.normal(size=SIZE).astype(np.float32))
        for r in range(2):
            replies.append(np.asarray(mats[r].get_rows(
                rng.integers(0, ROWS, size=12))).tobytes())
            replies.append(np.asarray(arrs[r].get()).tobytes())
    replies.append(np.asarray(mats[0].get_rows(np.arange(ROWS))).tobytes())
    return replies


def _set_wire(mode):
    jconf.set_flag("wire_compression", mode)
    tconf.set_flag("wire_compression", mode)


@pytest.mark.parametrize("mode", ["none", "sparse", "bf16"])
@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_replies_bitwise_jax_pair(both, updater, mode):
    _set_wire(mode)
    out = []
    for pkg in (jps, tps):
        svcs, mats, arrs = _world((pkg, pkg), updater)
        try:
            out.append(_drive(mats, arrs, seed=17))
        finally:
            for s in svcs:
                s.close()
    assert len(out[0]) == len(out[1])
    for i, (a, b) in enumerate(zip(*out)):
        assert a == b, f"reply {i} differs"


@pytest.mark.parametrize("kinds", ["jax,port", "port,jax"])
@pytest.mark.parametrize("mode", ["none", "sparse", "bf16"])
@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_wire_compat_mixed_world(both, updater, mode, kinds):
    """A JAX client talks to a port service and a port client to a JAX
    service in one world; every reply matches the all-JAX world's."""
    _set_wire(mode)
    pick = {"jax": jps, "port": tps}
    worlds = {"ref": (jps, jps), "mixed": tuple(pick[k]
                                               for k in kinds.split(","))}
    out = {}
    for name, ks in worlds.items():
        svcs, mats, arrs = _world(ks, updater)
        try:
            out[name] = _drive(mats, arrs, seed=23)
        finally:
            for s in svcs:
                s.close()
    for i, (a, b) in enumerate(zip(out["ref"], out["mixed"])):
        assert a == b, f"reply {i} differs in the {kinds} world"


def _jopt(opt):
    """The AddOption scalars as the JAX rows_math takes them (0-d JAX
    arrays, as the store's jit would)."""
    return tuple(jnp.asarray(x) for x in opt.scalars())


@pytest.mark.parametrize("name", ["adagrad", "momentum_sgd", "ftrl"])
def test_stateful_shards_match_jax_rows_math(both, name):
    """Each Add (global ids with duplicates, across both shards) against
    combine -> gather -> rows_math -> set of the JAX package, shard by
    shard, data and every state leaf bitwise."""
    rng = np.random.default_rng(31)
    svcs = [tps.PSService() for _ in range(2)]
    peers = [s.address for s in svcs]
    try:
        mats = [tps.DistributedMatrixTable(9, ROWS, COLS, svcs[r], peers, r,
                                           updater=name) for r in range(2)]
        j_up = jupd._REGISTRY[name]()
        offs = mats[0].row_offsets
        model = []
        for r in range(2):
            n = offs[r + 1] - offs[r]
            st = j_up.init_state((n, COLS), jnp.float32, 2)
            model.append((np.zeros((n, COLS), np.float32),
                          {k: np.array(v) for k, v in st.items()}))
        opt = mvt.AddOption(worker_id=0, momentum=0.6, learning_rate=0.2,
                            rho=0.3, lambda_=0.05)
        for step in range(5):
            ids = rng.integers(0, ROWS, size=30).astype(np.int32)
            d = rng.normal(size=(30, COLS)).astype(np.float32)
            client = mats[step % 2]
            client.add_rows(ids, d, opt)
            wid = client._gid(0)
            sc = _jopt(mvt.AddOption(
                worker_id=wid, momentum=0.6, learning_rate=0.2, rho=0.3,
                lambda_=0.05))
            for r in range(2):
                keep = (ids >= offs[r]) & (ids < offs[r + 1])
                if not keep.any():
                    continue
                data, st = model[r]
                n = data.shape[0]
                rows, dc = jupd.combine_duplicate_rows(
                    jnp.asarray(ids[keep] - offs[r]), jnp.asarray(d[keep]), n)
                rows, dc = np.asarray(rows), np.asarray(dc)
                live = rows < n
                clip = np.minimum(rows, n - 1)
                st_rows = {k: jnp.asarray(
                    (v[wid] if k in j_up.per_worker_state else v)[clip])
                    for k, v in st.items()}
                nd, ns = j_up.rows_math(jnp.asarray(data[clip]), st_rows,
                                        jnp.asarray(dc), sc)
                data[rows[live]] = np.asarray(nd)[live]
                for k in st:
                    tgt = st[k][wid] if k in j_up.per_worker_state else st[k]
                    tgt[rows[live]] = np.asarray(ns[k])[live]
        for r in range(2):
            got = mats[r].local_store.store_state()
            data, st = model[r]
            assert got["data"].tobytes() == data.tobytes(), (name, r)
            for k, v in st.items():
                assert got[f"state/{k}"].tobytes() == v.tobytes(), (name, k)
    finally:
        for s in svcs:
            s.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_across_packages(both, tmp_path, writer):
    """Adds logged by one package's shard replay into the other's shard
    and leave bitwise the same table."""
    pick = {"jax": jps, "port": tps}
    w, r = pick[writer], pick["port" if writer == "jax" else "jax"]
    wal_dir = str(tmp_path / "wal")
    s0, s1 = w.PSService(), w.PSService()
    s1.attach_wal(wal_dir, sync_acks=True)
    peers = [s0.address, s1.address]
    rng = np.random.default_rng(41)
    try:
        m0 = w.DistributedMatrixTable(5, ROWS, COLS, s0, peers, 0,
                                      updater="sgd")
        m1 = w.DistributedMatrixTable(5, ROWS, COLS, s1, peers, 1,
                                      updater="sgd")
        a0 = w.DistributedArrayTable(6, SIZE, s0, peers, 0)
        a1 = w.DistributedArrayTable(6, SIZE, s1, peers, 1)
        for _ in range(5):
            ids = rng.integers(0, ROWS, size=30).astype(np.int32)
            m0.add_rows(ids, rng.normal(size=(30, COLS)).astype(np.float32))
            a0.add(rng.normal(size=SIZE).astype(np.float32))
        want = {"m": m1.store_state()["data"], "a": a1.store_state()["data"]}
    finally:
        s0.close()
        s1.close()
    svc = r.PSService()
    try:
        svc.attach_wal(wal_dir, sync_acks=True)
        peers = [("127.0.0.1", 1), svc.address]
        rm = r.DistributedMatrixTable(5, ROWS, COLS, svc, peers, 1,
                                      updater="sgd", announce=False)
        ra = r.DistributedArrayTable(6, SIZE, svc, peers, 1, announce=False)
        report = svc.replay_wal()
        assert report["applied"] == 10, report
        assert np.asarray(rm.local_store.store_state()["data"]).tobytes() \
            == np.asarray(want["m"]).tobytes()
        assert np.asarray(ra.local_store.store_state()["data"]).tobytes() \
            == np.asarray(want["a"]).tobytes()
    finally:
        svc.close()
