"""Port parity: the lookup serving plane on the CPU — the hot-row cache,
``quant.encode_table``, the checkpoint replica, the live and replica
lookup runners, ``MatrixTable.serving_runner``, ``RoutedLookupClient``
and ``serve_main`` — against the JAX package.

Mirrors ``tests/test_serving_replica.py`` and the lookup cases of
``tests/test_serving_pipeline.py`` and ``tests/test_serving_e2e.py``.
Tolerances: live lookups and f32 replica lookups are BITWISE the table's
rows (``get_rows`` of either package, the checkpoint's data); bf16 and
int8 replica lookups are within ``quant.roundtrip_bound`` of the
checkpoint and BITWISE the JAX replica runner's dequant gather;
``encode_table``'s int8 payload and scale are the JAX package's bit for
bit. Checkpoints cross between the packages (the npz format is shared).
The JAX threaded batcher is never the oracle (ROADMAP C3): JAX runners
are called through ``run()``; the port's are driven through its own
batcher, ``ServingService`` and ``ServingClient`` on localhost.
"""

import os
import threading
import time

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj
from multiverso_tpu.core import checkpoint as jck
from multiverso_tpu.serving import cache as jcache
from multiverso_tpu.serving import quant as jquant
from multiverso_tpu.serving import replica as jreplica
from multiverso_tpu.serving import runners as jrunners

mvt = tck = ts = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tck, ts, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch import serving as ts
    from multiverso_tpu_torch.core import checkpoint as tck


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    reset_telemetry()


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


def _cpu():
    return torch.device("cpu")


def _filled(pkg, rows=64, cols=4, seed=0, name=None, **kw):
    t = pkg.create_table(pkg.MatrixTableOption(num_row=rows, num_col=cols,
                                               name=name, **kw))
    rng = np.random.default_rng(seed)
    t.add_rows(np.arange(rows, dtype=np.int32),
               rng.normal(size=(rows, cols)).astype(np.float32))
    return t


def _padded(queries, bucket):
    mat = np.zeros((len(queries), bucket), np.int32)
    lens = np.zeros(len(queries), np.int32)
    for i, q in enumerate(queries):
        mat[i, :len(q)] = q
        lens[i] = len(q)
    return mat, lens


# -- the codec ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_encode_table_bitwise_jax(dtype):
    rng = np.random.default_rng(1)
    data = (rng.normal(size=(40, 9)) * 3).astype(np.float32)
    data[3] = 0.0                                 # an all-zero row
    data[5, 2] = 127.5
    jp, js = jquant.encode_table(data, dtype)
    tp, tsc = ts.quant.encode_table(data, dtype, _cpu())
    if dtype == "bf16":
        assert tp.dtype == torch.bfloat16
        assert np.array_equal(tp.view(torch.int16).numpy(),
                              np.asarray(jp).view(np.int16))
    else:
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert tp.numpy().dtype == np.asarray(jp).dtype
    if dtype == "int8":
        assert np.array_equal(tsc.numpy(), np.asarray(js))
        assert tsc.shape == (40, 1)
    else:
        assert tsc is None and js is None
    dec = ts.quant.decode_rows(tp, tsc, dtype).numpy()
    assert np.abs(dec - data).max() <= \
        ts.quant.roundtrip_bound(data, dtype) + 1e-7


# -- the hot-row cache ---------------------------------------------------------

def test_cache_lru_eviction_and_capacity():
    """Op by op against the JAX cache: LRU victim, all-or-nothing, stamps."""
    for mod in (jcache, ts.cache):
        c = mod.HotRowCache(capacity=2, staleness=0)
        c.put_rows(np.asarray([1]), np.ones((1, 4), np.float32), 0)
        c.put_rows(np.asarray([2]), np.ones((1, 4), np.float32) * 2, 0)
        assert len(c) == 2
        assert c.get_rows(np.asarray([1]), 0) is not None
        c.put_rows(np.asarray([3]), np.ones((1, 4), np.float32) * 3, 0)
        assert len(c) == 2
        assert c.get_rows(np.asarray([2]), 0) is None
        assert c.get_rows(np.asarray([1]), 0) is not None
        assert c.get_rows(np.asarray([1, 9]), 0) is None
        c.put_rows(np.asarray([7]), np.full((1, 4), 7.0, np.float32), 5)
        hit = c.get_rows(np.asarray([7, 1]), 5)
        assert hit is None                      # 1 is 5 ticks stale
        c.put_rows(np.asarray([1]), np.ones((1, 4), np.float32), 4)
        c.staleness = 1
        hit = c.get_rows(np.asarray([7, 1]), 5)
        assert hit.clock_stamp == 4.0 and hit.shape == (2, 4)
        c.resize(1)
        assert len(c) == 1
        c.invalidate()
        assert len(c) == 0


def test_cache_autosizer_steps_like_jax():
    """The same advice sequence under a fake clock: both autosizers take
    the same actions to the same capacities."""
    rows = np.ones((1, 16), np.float32)
    advice = ([{"predicted_hit_rate": 0.5, "predicted_hit_rate_2x": 0.6}]
              * 4 + [{"predicted_hit_rate": 0.9,
                      "predicted_hit_rate_2x": 0.9}] * 8)
    trace = {}
    for mod in (jcache, ts.cache):
        cache = mod.HotRowCache(256)
        for k in range(40):
            cache.put_rows(np.asarray([k]), rows, 0)
        auto = mod.CacheAutosizer(cache, mem_budget=1 << 16, windows=2,
                                  cooldown_s=1.0, min_rows=64)
        trace[mod] = [(auto.on_advice(a, now=float(i)), cache.capacity)
                      for i, a in enumerate(advice)]
    assert trace[jcache] == trace[ts.cache]
    assert any(act == "grow" for act, _ in trace[ts.cache])
    assert any(act == "shrink" for act, _ in trace[ts.cache])


def test_cache_from_flags(port):
    assert ts.cache_from_flags() is None
    mvt.set_flag("serve_cache_rows", 32)
    mvt.set_flag("serve_cache_staleness", 2)
    mvt.set_flag("serve_cache_mem_budget", 4096)
    c = ts.cache_from_flags()
    assert (c.capacity, c.staleness) == (32, 2)
    assert isinstance(c.autosizer, ts.CacheAutosizer)


# -- live-table lookups --------------------------------------------------------

def test_live_runner_bitwise_get_rows_of_both_packages(both):
    """Live lookups through ``run()`` (padding rows and columns, ids past
    the end clipped): bitwise the port's and the JAX table's rows."""
    jt = _filled(mvj, seed=3)
    tt = _filled(mvt, seed=3)
    runner = tt.serving_runner()
    jrun = jt.serving_runner()
    queries = [[5, 63, 0, 17], [1], [70, 2, 9]]
    mat, lens = _padded(queries, 8)
    out = runner.run(mat, lens)
    jout = np.asarray(jrun.run(mat, lens))
    assert np.array_equal(out, jout)
    for i, q in enumerate(queries):
        got = runner.slice_result(out, i, len(q))
        assert np.array_equal(got, tt.get_rows(q))
        assert np.array_equal(got, np.asarray(jt.get_rows(q)))
    assert runner.clock() == -1.0 and runner.try_cached(
        np.asarray([1], np.int32)) is None
    # the sketch saw the real keys only (no pads)
    from multiverso_tpu_torch.telemetry.sketch import get_sketch_hub
    hub = get_sketch_hub()
    hub.flush()
    assert hub.summary("serve.lookup")["keys"] == 8


def test_live_runner_row_offset_and_bf16_table(port):
    t = _filled(mvt, rows=32, cols=3, seed=1)
    runner = ts.SparseLookupRunner(t.store, row_offset=16)
    mat, lens = _padded([[16, 20, 47, 3]], 4)
    out = runner.run(mat, lens)[0]
    assert np.array_equal(out, t.get_rows([0, 4, 31, 0]))
    b = _filled(mvt, rows=8, cols=2, dtype="bfloat16", seed=2)
    got = b.serving_runner().run(*_padded([[7, 1]], 2))[0]
    assert got.dtype == np.float32 and np.array_equal(got, b.get_rows([7, 1]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_live_gathers_take_b1_for_every_float32_table(port, monkeypatch,
                                                      use_pallas):
    """The live runner reads through ``ServerStore.read_rows``, which
    gathers every float32 table with B1's wrapper, ``use_pallas`` or not
    (on the CPU the wrapper runs its plain version), and a bfloat16 table
    with ``index_select``; the ids reach it clipped into range."""
    from multiverso_tpu_torch.ops import rows
    seen = []
    real = rows.gather_rows

    def spy(table, ids):
        seen.append(ids.clone())
        return real(table, ids)

    monkeypatch.setattr(rows, "gather_rows", spy)
    t = _filled(mvt, rows=32, cols=3, seed=1, use_pallas=use_pallas,
                updater="sgd")
    mat, lens = _padded([[5, 40, 0], [31]], 4)
    out = t.serving_runner().run(mat, lens)
    assert len(seen) == 1 and seen[0].tolist() == [5, 31, 0, 0,
                                                   31, 0, 0, 0]
    assert np.array_equal(out[0, :3], t.get_rows([5, 31, 0]))
    b = _filled(mvt, rows=8, cols=2, dtype="bfloat16", seed=2)
    seen.clear()
    b.serving_runner().run(*_padded([[7, 1]], 2))
    assert seen == []


def test_pipelined_live_table_bitwise_parity(port):
    t = _filled(mvt, rows=128, cols=8, seed=3)
    runner = t.serving_runner()
    svc = ts.ServingService()
    svc.register_runner(runner, buckets=(4, 8), max_batch=4,
                        max_wait_ms=1.0, pipeline_depth=2)
    cli = ts.ServingClient(*svc.address)
    rng = np.random.default_rng(3)
    try:
        for n in (2, 4, 7, 8, 3):
            q = rng.integers(0, 128, n).astype(np.int32)
            assert np.array_equal(cli.lookup(q, deadline_ms=10_000),
                                  t.get_rows(q))
        assert svc.batcher(0).pipeline_depth == 2
    finally:
        cli.close()
        svc.close()


def test_cache_hits_bitwise_equal_under_training_writes(port):
    """Clock discipline (BSP): with staleness=1 an entry stamped at clock c
    serves through c+1 and refetches at c+2; every reply is bitwise the
    table's rows at the clock it claims."""
    from multiverso_tpu_torch.telemetry import get_registry
    t = _filled(mvt, rows=64, cols=4, seed=0)
    clock = [0.0]
    runner = ts.SparseLookupRunner(t.store, clock_fn=lambda: (clock[0], 0.0),
                                   cache=ts.HotRowCache(64, staleness=1))
    svc = ts.ServingService()
    svc.register_runner(runner, buckets=(8,), max_batch=2,
                        max_wait_ms=0.5, pipeline_depth=0)
    cli = ts.ServingClient(*svc.address)
    reg = get_registry()
    q = np.asarray([5, 17, 30], np.int32)
    try:
        v0 = cli.lookup(q, deadline_ms=10_000)
        assert np.array_equal(v0, t.get_rows(q))
        hits0 = reg.counter("serve.cache.hit").value
        assert np.array_equal(cli.lookup(q, deadline_ms=10_000),
                              t.get_rows(q))
        assert reg.counter("serve.cache.hit").value == hits0 + 1
        old = t.get_rows(q)
        t.add_rows(q, np.ones((3, 4), np.float32))
        clock[0] = 1.0
        vals, stamp = cli.request_async(q, 10_000).wait(30)
        assert np.array_equal(vals, old) and stamp == 0
        assert reg.counter("serve.cache.hit").value == hits0 + 2
        clock[0] = 2.0
        stale0 = reg.counter("serve.cache.stale").value
        vals, stamp = cli.request_async(q, 10_000).wait(30)
        assert reg.counter("serve.cache.stale").value == stale0 + 1
        assert np.array_equal(vals, t.get_rows(q)) and stamp == 2
        assert np.array_equal(cli.lookup(q, deadline_ms=10_000),
                              t.get_rows(q))
        assert reg.counter("serve.cache.hit").value == hits0 + 3
    finally:
        cli.close()
        svc.close()


def test_cache_staleness_zero_always_fresh_under_writes(port):
    t = mvt.create_table(mvt.MatrixTableOption(num_row=32, num_col=4))
    t.add_rows(np.arange(32, dtype=np.int32),
               np.arange(128, dtype=np.float32).reshape(32, 4))
    clock = [0.0]
    runner = ts.SparseLookupRunner(t.store, clock_fn=lambda: (clock[0], 0.0),
                                   cache=ts.HotRowCache(32, staleness=0))
    svc = ts.ServingService()
    svc.register_runner(runner, buckets=(8,), max_batch=2, max_wait_ms=0.5)
    cli = ts.ServingClient(*svc.address)
    q = np.asarray([1, 2, 3], np.int32)
    try:
        for step in range(4):
            direct = t.get_rows(q)
            for _ in range(2):
                assert np.array_equal(cli.lookup(q, deadline_ms=10_000),
                                      direct)
            t.add_rows(q, np.full((3, 4), float(step + 1), np.float32))
            clock[0] += 1.0
        assert np.array_equal(cli.lookup(q, deadline_ms=10_000),
                              t.get_rows(q))
    finally:
        cli.close()
        svc.close()


def test_clockless_live_table_never_serves_from_cache(port):
    t = mvt.create_table(mvt.MatrixTableOption(num_row=16, num_col=4))
    t.add_rows(np.arange(16, dtype=np.int32),
               np.arange(64, dtype=np.float32).reshape(16, 4))
    cache = ts.HotRowCache(16, staleness=0)
    q = np.asarray([1, 2], np.int32)
    mat, lens = _padded([q, []], 4)
    for runner in (ts.SparseLookupRunner(t.store, clock_fn=None, cache=cache),
                   t.serving_runner(cache=cache)):   # async mode: no clock
        runner.run(mat, lens)
        assert len(cache) == 0 and runner.try_cached(q) is None
        t.add_rows(q, np.ones((2, 4), np.float32))
        assert np.array_equal(runner.run(mat, lens)[0, :2], t.get_rows(q))


def test_concurrent_inflight_requests_one_connection(port):
    t = mvt.create_table(mvt.MatrixTableOption(num_row=128, num_col=4))
    t.add_rows(np.arange(128, dtype=np.int32),
               np.arange(128 * 4, dtype=np.float32).reshape(128, 4))
    svc = ts.ServingService()
    svc.register_runner(t.serving_runner(), buckets=(8,), max_batch=4,
                        max_wait_ms=2.0)
    cli = ts.ServingClient(*svc.address)
    errors = []

    def hit(seed):
        rng = np.random.default_rng(seed)
        for _ in range(10):
            q = rng.integers(0, 128, 5).astype(np.int32)
            want = np.stack([np.arange(r * 4, r * 4 + 4) for r in q]) \
                .astype(np.float32)
            if not np.array_equal(cli.lookup(q, deadline_ms=10_000), want):
                errors.append(q.tolist())
                return

    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        assert not errors, errors[:2]
    finally:
        cli.close()
        svc.close()


def test_shed_and_wire_bf16(port):
    from multiverso_tpu_torch.serving import ShedError
    t = _filled(mvt, rows=32, cols=4, seed=1)
    svc = ts.ServingService()
    svc.register_runner(t.serving_runner(), buckets=(4,), max_batch=2,
                        max_wait_ms=1.0)
    cli = ts.ServingClient(*svc.address)
    try:
        with pytest.raises(ShedError):
            cli.lookup(np.arange(9, dtype=np.int32), deadline_ms=10_000)
        with pytest.raises(ShedError):
            cli.lookup(np.arange(2, dtype=np.int32), deadline_ms=0.0)
        q = np.asarray([3, 1, 30], np.int32)
        mvt.set_flag("serve_wire_dtype", "bf16")
        served = cli.lookup(q, deadline_ms=10_000)
        direct = t.get_rows(q)
        want = torch.tensor(direct).to(torch.bfloat16).float().numpy()
        assert np.array_equal(served, want)
        mvt.set_flag("serve_wire_dtype", "f32")
        assert np.array_equal(cli.lookup(q, deadline_ms=10_000), direct)
    finally:
        cli.close()
        svc.close()


def test_routed_client_over_two_live_shards(port):
    """Two services, each over half the rows by ``row_offset``: routed
    lookups return the whole table's rows bitwise, in request order."""
    full = _filled(mvt, rows=40, cols=6, seed=5)
    rows = full.get()
    halves = []
    for lo, hi in ((0, 24), (24, 40)):
        h = mvt.create_table(mvt.MatrixTableOption(num_row=hi - lo,
                                                   num_col=6))
        h.add_rows(np.arange(hi - lo, dtype=np.int32), rows[lo:hi])
        halves.append((lo, h))
    svcs = []
    for lo, h in halves:
        svc = ts.ServingService()
        svc.register_runner(ts.SparseLookupRunner(h.store, row_offset=lo),
                            buckets=(4, 8), max_batch=4, max_wait_ms=1.0)
        svcs.append(svc)
    cli = ts.RoutedLookupClient([s.address for s in svcs], offsets=[0, 24, 40])
    try:
        rng = np.random.default_rng(7)
        for n in (3, 4, 2, 7, 8, 1):
            q = rng.integers(0, 40, n).astype(np.int64)
            got = cli.lookup(q, deadline_ms=10_000)
            assert got.dtype == np.float32
            assert np.array_equal(got, rows[q])
        assert cli.lookup(np.empty(0, np.int64),
                          deadline_ms=10_000).shape == (0, 6)
        from multiverso_tpu_torch.utils.log import FatalError
        with pytest.raises(FatalError):
            cli.lookup([40])
    finally:
        cli.close()
        for s in svcs:
            s.close()


def test_backoff_envelope_matches_jax():
    import random
    from multiverso_tpu.serving import client as jclient
    for attempts in (1, 2, 5):
        a = ts.backoff_delays(attempts, rng=random.Random(3))
        b = jclient.backoff_delays(attempts, rng=random.Random(3))
        assert a == b


# -- checkpoint replicas -------------------------------------------------------

def _train_and_checkpoint(pkg, ck, table, path, steps, seed=0):
    expected = {}
    rng = np.random.default_rng(seed)
    for step in steps:
        table.add(rng.normal(size=(32, 4)).astype(np.float32))
        ck.save_all(str(path), step=step)
        expected[step] = np.asarray(table.get())
    return expected


def test_replica_loads_a_checkpoint_either_package_wrote(both, tmp_path):
    """The port's replica over a checkpoint the JAX package wrote, and the
    JAX replica over one the port wrote: the same tables, bitwise."""
    jt = mvj.create_table(mvj.MatrixTableOption(num_row=32, num_col=4,
                                                name="served"))
    tt = mvt.create_table(mvt.MatrixTableOption(num_row=32, num_col=4,
                                                name="served"))
    jexp = _train_and_checkpoint(mvj, jck, jt, tmp_path / "j", [10, 20])
    texp = _train_and_checkpoint(mvt, tck, tt, tmp_path / "t", [10, 20])
    rep = ts.CheckpointReplica(str(tmp_path / "j"))
    jrep = jreplica.CheckpointReplica(str(tmp_path / "t"))
    try:
        assert rep.step == 20 and jrep.step == 20
        assert rep.device == _cpu()
        got = rep.snapshot().table("served")
        assert isinstance(got, torch.Tensor)
        assert np.array_equal(got.numpy(), jexp[20])
        assert np.array_equal(np.asarray(jrep.snapshot().table("served")),
                              texp[20])
        assert rep.snapshot().names == ["served"]
    finally:
        rep.close()
        jrep.close()


def test_replica_requires_a_checkpoint(port, tmp_path):
    from multiverso_tpu_torch.utils.log import FatalError
    with pytest.raises(FatalError):
        ts.CheckpointReplica(str(tmp_path / "empty"))


def test_hot_swap_picks_up_new_checkpoint(port, tmp_path):
    t = mvt.create_table(mvt.MatrixTableOption(num_row=32, num_col=4,
                                               name="served"))
    exp = _train_and_checkpoint(mvt, tck, t, tmp_path, [1])
    rep = ts.CheckpointReplica(str(tmp_path))
    try:
        assert rep.step == 1 and not rep.refresh()
        exp.update(_train_and_checkpoint(mvt, tck, t, tmp_path, [2]))
        assert rep.refresh() and rep.step == 2
        assert np.array_equal(rep.snapshot().table("served").numpy(),
                              exp[2])
    finally:
        rep.close()


def test_hot_swap_under_concurrent_gets(port, tmp_path):
    """Readers hammer the replica through the port's batcher while
    checkpoints land and swap: every read is one coherent step's rows."""
    t = mvt.create_table(mvt.MatrixTableOption(num_row=32, num_col=4,
                                               name="served"))
    by_step = _train_and_checkpoint(mvt, tck, t, tmp_path, [1])
    rep = ts.CheckpointReplica(str(tmp_path))
    batcher = ts.DynamicBatcher(ts.ReplicaLookupRunner(rep, "served"),
                                buckets=(8,), max_batch=4, max_wait_ms=0.5)
    stop = threading.Event()
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            keys = rng.integers(0, 32, 5).astype(np.int32)
            try:
                got = batcher.submit(keys, deadline_ms=10_000).wait(30)
            except Exception as e:  # noqa: BLE001 - collected, asserted
                errors.append(repr(e))
                return
            if not any(np.array_equal(got, tab[keys])
                       for tab in list(by_step.values())):
                errors.append(f"torn read for keys {keys.tolist()}")
                return

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    try:
        for th in threads:
            th.start()
        for step in (2, 3, 4):
            by_step.update(_train_and_checkpoint(mvt, tck, t, tmp_path,
                                                 [step]))
            assert rep.refresh()
            time.sleep(0.05)
        stop.set()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert not errors, errors
        assert rep.step == 4
    finally:
        stop.set()
        batcher.close()
        rep.close()


def test_replica_reassembles_rank_shards(tmp_path):
    """A 2-rank checkpoint written with the JAX package's ``save_table``
    loads back through the port as ONE table at global offsets; a
    replicated table listed by both ranks loads as one copy; a missing
    shard fails loudly."""
    import json
    root = tmp_path / "ckpt_000000000007"
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)

    class Fake:
        def __init__(self, payload):
            self._payload = payload

        def store_state(self):
            return self._payload

    for rank, sl in ((0, slice(0, 6)), (1, slice(6, 10))):
        fname = f"dist-shard{rank}of2.npz"
        jck.save_table(Fake({"data": rows[sl], "shard_meta": np.asarray(
            [0, 0, 2, sl.start], np.int64)}), str(root / fname))
        suffix = "" if rank == 0 else f"-r{rank}"
        jck.save_table(Fake({"data": np.full((3, 2), 9.0, np.float32)}),
                       str(root / f"counts{suffix}.npz"))
        meta = {"step": 7, "tables": ["dist", "counts"],
                "files": {"dist": fname, "counts": f"counts{suffix}.npz"}}
        name = "meta.json" if rank == 0 else f"meta.r{rank}.json"
        (root / name).write_text(json.dumps(meta))
    tables = ts.load_checkpoint_tables(str(root))
    assert np.array_equal(tables["dist"], rows)
    assert np.array_equal(tables["counts"], np.full((3, 2), 9.0, np.float32))
    rep = ts.CheckpointReplica(str(tmp_path), device=_cpu())
    assert rep.step == 7
    assert np.array_equal(rep.snapshot().table("dist").numpy(), rows)
    os.unlink(root / "dist-shard0of2.npz")
    (root / "meta.json").write_text(json.dumps(
        {"step": 7, "tables": [], "files": {}}))
    with pytest.raises(Exception):
        ts.load_checkpoint_tables(str(root))


def test_auto_refresh_follows_training(port, tmp_path):
    t = mvt.create_table(mvt.MatrixTableOption(num_row=32, num_col=4,
                                               name="served"))
    exp = _train_and_checkpoint(mvt, tck, t, tmp_path, [1])
    rep = ts.CheckpointReplica(str(tmp_path))
    rep.start_auto_refresh(interval_s=0.1)
    try:
        exp.update(_train_and_checkpoint(mvt, tck, t, tmp_path, [5]))
        deadline = time.monotonic() + 20
        while rep.step < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rep.step == 5
        assert np.array_equal(rep.snapshot().table("served").numpy(),
                              exp[5])
    finally:
        rep.close()


def test_checkpoint_manager_to_replica_pipeline(port, tmp_path):
    t = mvt.create_table(mvt.MatrixTableOption(num_row=16, num_col=2,
                                               name="served"))
    mgr = tck.CheckpointManager(str(tmp_path), save_every_steps=10)
    t.add(np.ones((16, 2), np.float32))
    assert mgr.maybe_save(10) is not None
    rep = ts.CheckpointReplica(str(tmp_path))
    try:
        assert rep.step == 10
        t.add(np.ones((16, 2), np.float32))
        assert mgr.maybe_save(20) is not None
        assert rep.refresh()
        assert np.array_equal(rep.snapshot().table("served").numpy(),
                              np.full((16, 2), 2.0, np.float32))
    finally:
        rep.close()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_replica_runner_against_jax_runner(both, tmp_path, dtype):
    """Replica lookups at each storage dtype through ``run()``: f32
    bitwise the checkpoint; bf16/int8 bitwise the JAX runner's dequant
    gather and within ``roundtrip_bound`` of the checkpoint; a cache hit
    carries the checkpoint step."""
    t = _filled(mvt, rows=48, cols=5, seed=9, name="emb")
    tck.save_all(str(tmp_path), step=3)
    data = t.get()
    rep = ts.CheckpointReplica(str(tmp_path), table_dtype=dtype)
    jrep = jreplica.CheckpointReplica(str(tmp_path), table_dtype=dtype)
    cache = ts.HotRowCache(64)
    runner = ts.ReplicaLookupRunner(rep, "emb", cache=cache)
    jrun = jrunners.ReplicaLookupRunner(jrep, "emb")
    queries = [[0, 47, 3], [60, 5], [1, 2, 3, 4, 5, 6, 7, 8]]
    mat, lens = _padded(queries, 8)
    out = runner.run(mat, lens)
    assert np.array_equal(out, np.asarray(jrun.run(mat, lens)))
    assert runner.clock() == 3.0
    for i, q in enumerate(queries):
        got = runner.slice_result(out, i, len(q))
        want = data[np.minimum(q, 47)]
        if dtype == "f32":
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= \
                ts.quant.roundtrip_bound(data, dtype) + 1e-7
    hit = runner.try_cached(np.asarray([0, 47], np.int32))
    assert hit is not None and hit.clock_stamp == 3.0
    snap = rep.snapshot()
    assert torch.equal(snap.table("emb"), snap.table("emb"))   # cached
    rep.close()
    jrep.close()


def test_serve_main_on_cpu(port, tmp_path):
    """``serve_main`` over a checkpoint on the CPU: wire lookups bitwise
    the checkpoint table, the reply stamped with its step; a newer
    checkpoint is followed."""
    from multiverso_tpu_torch.apps import serve_main
    t = _filled(mvt, rows=32, cols=4, seed=2, name="matrix_0")
    tck.save_all(str(tmp_path / "ck"), step=4)
    data = t.get()
    mvt.shutdown()
    addr = tmp_path / "addr"
    rc = []
    th = threading.Thread(target=lambda: rc.append(serve_main.main([
        f"-checkpoint_dir={tmp_path / 'ck'}", "-serve_device=cpu",
        f"-serve_addr_file={addr}", "-serve_duration=4",
        "-serve_refresh_s=0.1", "-serve_buckets=4,8"])))
    th.start()
    try:
        deadline = time.monotonic() + 30
        while not addr.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        host, port_ = addr.read_text().split(":")
        cli = ts.ServingClient(host, int(port_))
        q = np.asarray([3, 0, 31], np.int32)
        vals, step = cli.request_async(q, 10_000).wait(30)
        assert np.array_equal(vals, data[q]) and step == 4
        cli.close()
    finally:
        th.join(timeout=60)
    assert rc == [0]


def test_serve_main_without_a_card_exits_1(tmp_path, monkeypatch):
    from multiverso_tpu_torch.apps import serve_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_main.main([f"-checkpoint_dir={tmp_path}",
                            "-serve_duration=1"]) == 1


def test_lookup_runners_launch_b1_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 under the lookup runners")
    from multiverso_tpu_torch.ops import rows
    mvt.init([])
    t = _filled(mvt, rows=1000, cols=50, seed=4, name="card")
    tck.save_all(str(tmp_path), step=1)
    rep = ts.CheckpointReplica(str(tmp_path))
    mat, lens = _padded([[1, 999, 5], [2000, 0]], 8)
    before = rows.LAUNCHES["gather_rows"]
    live = t.serving_runner().run(mat, lens)
    frozen = ts.ReplicaLookupRunner(rep, "card").run(mat, lens)
    assert rows.LAUNCHES["gather_rows"] == before + 2
    assert np.array_equal(live, frozen)
    assert np.array_equal(live[0, :3], t.get_rows([1, 999, 5]))
    rep.close()
    mvt.shutdown()
