"""Port mirror of ``tests/test_dist_kv_sparse.py``: its cases that are not
marked slow, run against ``multiverso_tpu_torch`` with every shard on the
CPU (``-platform=cpu``), in one process over loopback TCP."""


import numpy as np
import pytest

import _torch_port

# Set by _load_port.
AddOption = DistributedKVTable = DistributedSparseMatrixTable = None
GetOption = PSService = mv = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global AddOption, DistributedKVTable, DistributedSparseMatrixTable
    global GetOption, PSService, mv
    _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption, GetOption
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedKVTable, DistributedSparseMatrixTable, PSService)


def _reset_port():
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()


@pytest.fixture(autouse=True)
def _port_state():
    yield
    _reset_port()


@pytest.fixture
def mv_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu"])
    yield mvt
    _reset_port()


@pytest.fixture
def sync_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu", "-sync=true"])
    yield mvt
    _reset_port()


@pytest.fixture
def two_rank_world(mv_env):
    svc0 = PSService()
    svc1 = PSService()
    peers = [svc0.address, svc1.address]
    yield svc0, svc1, peers
    svc0.close()
    svc1.close()


# -- KV ----------------------------------------------------------------------
def test_kv_add_get_across_shards(two_rank_world):
    """+= merge server-side; key % num_servers routing (kv_table.h:48-50):
    even keys land on rank 0's shard, odd keys on rank 1's."""
    svc0, svc1, peers = two_rank_world
    t0 = DistributedKVTable(1, svc0, peers, rank=0)
    t1 = DistributedKVTable(1, svc1, peers, rank=1)
    keys = [2, 3, 40, 41]
    t0.add(keys, [10, 20, 30, 40])
    t1.add(keys, [1, 2, 3, 4])
    np.testing.assert_array_equal(t0.get(keys), [11, 22, 33, 44])
    np.testing.assert_array_equal(t1.get(keys), [11, 22, 33, 44])
    # hash placement is real: each shard holds exactly its residue class
    assert set(t0.local_store._map) == {2, 40}
    assert set(t1.local_store._map) == {3, 41}


def test_kv_int64_values_are_exact(two_rank_world):
    """Word counts must accumulate exactly — int64 on the wire, no float32
    round trip (2^40 is unrepresentable in float32)."""
    svc0, svc1, peers = two_rank_world
    t0 = DistributedKVTable(2, svc0, peers, rank=0)
    DistributedKVTable(2, svc1, peers, rank=1)
    big = (1 << 40) + 3
    t0.add([7], [big])
    t0.add([7], [1])
    assert int(t0.get([7])[0]) == big + 1


def test_kv_get_async_pipelines(two_rank_world):
    svc0, svc1, peers = two_rank_world
    t0 = DistributedKVTable(3, svc0, peers, rank=0)
    DistributedKVTable(3, svc1, peers, rank=1)
    t0.add([5], [9])
    op = t0.get_async([5])
    assert int(t0.wait(op)[0]) == 9


def test_kv_checkpoint_roundtrip(two_rank_world):
    svc0, svc1, peers = two_rank_world
    t0 = DistributedKVTable(4, svc0, peers, rank=0)
    DistributedKVTable(4, svc1, peers, rank=1)
    t0.add([2, 3], [10, 20])
    saved = t0.store_state()
    t0.add([2], [100])
    t0.load_state(saved)
    assert int(t0.get([2])[0]) == 10   # rank-0 shard restored


# -- sparse matrix -----------------------------------------------------------
def test_sparse_incremental_get_ships_only_touched_rows(two_rank_world):
    """First whole-table Get pulls everything; an untouched second Get
    pulls ZERO rows; after a peer adds 2 rows, the next Get pulls exactly
    those 2 — wire volume scales with touched rows, not table size."""
    svc0, svc1, peers = two_rank_world
    V = 40
    m0 = DistributedSparseMatrixTable(5, V, 4, svc0, peers, rank=0)
    m1 = DistributedSparseMatrixTable(5, V, 4, svc1, peers, rank=1)
    m0.add_rows(np.arange(V, dtype=np.int32),
                np.ones((V, 4), dtype=np.float32),
                AddOption(worker_id=0))

    got = m1.get(GetOption(worker_id=0))          # worker gid 1 (rank 1)
    np.testing.assert_allclose(got, 1.0)
    assert m1.last_incremental_rows == V          # first pull: all rows

    got = m1.get(GetOption(worker_id=0))
    np.testing.assert_allclose(got, 1.0)
    assert m1.last_incremental_rows == 0          # nothing touched since

    m0.add_rows([3, 25], np.full((2, 4), 5.0, dtype=np.float32),
                AddOption(worker_id=0))
    got = m1.get(GetOption(worker_id=0))
    assert m1.last_incremental_rows == 2          # exactly the touched rows
    np.testing.assert_allclose(got[3], 6.0)
    np.testing.assert_allclose(got[25], 6.0)
    np.testing.assert_allclose(got[4], 1.0)       # cached, not re-shipped


def test_sparse_writer_own_rows_stay_fresh(two_rank_world):
    """The writer's own adds don't invalidate its own view (ref :200-223:
    Add marks rows stale for every OTHER worker) — and its cache still
    reflects them, because adds apply client-side too."""
    svc0, svc1, peers = two_rank_world
    m0 = DistributedSparseMatrixTable(6, 10, 2, svc0, peers, rank=0)
    DistributedSparseMatrixTable(6, 10, 2, svc1, peers, rank=1)
    m0.get(GetOption(worker_id=0))                # prime: all fresh
    m0.add_rows([1], np.ones((1, 2), dtype=np.float32),
                AddOption(worker_id=0))
    got = m0.get(GetOption(worker_id=0))
    assert m0.last_incremental_rows == 0          # own write: still fresh
    np.testing.assert_allclose(got[1], 1.0)       # ...and visible locally


def test_kv_rejects_negative_keys(two_rank_world):
    """Negative keys are reserved wire sentinels (TICK/STALE): using one
    as data must fail loudly, not hit the sentinel paths."""
    from multiverso_tpu_torch.utils.log import FatalError
    svc0, svc1, peers = two_rank_world
    t0 = DistributedKVTable(7, svc0, peers, rank=0)
    DistributedKVTable(7, svc1, peers, rank=1)
    with pytest.raises(FatalError):
        t0.add([-2], [1])
    with pytest.raises(FatalError):
        t0.get([-3])


@pytest.fixture
def sync_two_rank_world():
    mv.init(["-platform=cpu", "-sync=true"], num_local_workers=1)
    svc0 = PSService()
    svc1 = PSService()
    yield svc0, svc1, [svc0.address, svc1.address]
    svc0.close()
    svc1.close()
    mv.shutdown()


def test_bsp_sparse_row_routed_does_not_wedge(sync_two_rank_world):
    """The sparse override of _send_add_rows must keep the parent's BSP
    uniform-tick invariant: workers adding to disjoint shards may not
    wedge the gates."""
    import threading
    svc0, svc1, peers = sync_two_rank_world
    m0 = DistributedSparseMatrixTable(8, 20, 4, svc0, peers, rank=0)
    m1 = DistributedSparseMatrixTable(8, 20, 4, svc1, peers, rank=1)
    assert m0._bsp
    errors = []

    def loop(table, rows):
        try:
            for _ in range(3):
                table.add_rows(rows, np.ones((len(rows), 4),
                                             dtype=np.float32),
                               AddOption(worker_id=0))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(m0, [1, 3])),
               threading.Thread(target=loop, args=(m1, [15, 17]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "BSP sparse row-routed worker wedged"
    assert not errors, errors


def test_sparse_keyed_incremental_get(two_rank_world):
    """Keyed gets are ALSO incremental (ref keyed UpdateGetState,
    :244-253): only the stale subset of the requested rows crosses the
    wire; fresh rows serve from the worker's cache; request order and
    duplicates are honored."""
    svc0, svc1, peers = two_rank_world
    m0 = DistributedSparseMatrixTable(30, 20, 4, svc0, peers, rank=0)
    m1 = DistributedSparseMatrixTable(30, 20, 4, svc1, peers, rank=1)
    m0.add_rows(np.arange(10, dtype=np.int32),
                np.arange(10, dtype=np.float32)[:, None]
                .repeat(4, 1), AddOption(worker_id=0))

    opt = GetOption(worker_id=0)
    got = m1.get_rows([2, 7, 2, 15], opt)       # 15 never written: zeros
    assert m1.last_incremental_rows == 3        # {2, 7, 15} stale
    np.testing.assert_allclose(got[0], 2.0)
    np.testing.assert_allclose(got[1], 7.0)
    np.testing.assert_allclose(got[2], 2.0)     # duplicate honored
    np.testing.assert_allclose(got[3], 0.0)

    got = m1.get_rows([2, 7], opt)              # all fresh: cache only
    assert m1.last_incremental_rows == 0
    np.testing.assert_allclose(got[0], 2.0)

    m0.add_rows([7], np.full((1, 4), 100.0, np.float32),
                AddOption(worker_id=0))
    got = m1.get_rows([2, 7], opt)              # exactly the re-staled row
    assert m1.last_incremental_rows == 1
    np.testing.assert_allclose(got[1], 107.0)
    np.testing.assert_allclose(got[0], 2.0)

    # optionless keyed get stays plain (ships everything, marks nothing)
    got = m1.get_rows([2, 7])
    np.testing.assert_allclose(got[1], 107.0)


def test_sparse_checkpoint_restore_resets_staleness(two_rank_world):
    """Restore marks EVERYTHING stale (the reference initializes
    all-stale): a fresh bit promises the worker cache holds the current
    row, and caches are not part of the checkpoint."""
    svc0, svc1, peers = two_rank_world
    m0 = DistributedSparseMatrixTable(31, 8, 2, svc0, peers, rank=0)
    DistributedSparseMatrixTable(31, 8, 2, svc1, peers, rank=1)
    m0.add_rows([1, 5], np.ones((2, 2), dtype=np.float32),
                AddOption(worker_id=0))
    m0.get(GetOption(worker_id=0))              # prime: all fresh
    assert m0.get(GetOption(worker_id=0)) is not None
    assert m0.last_incremental_rows == 0

    saved = m0.store_state()
    m0.add_rows([1], np.ones((1, 2), dtype=np.float32),
                AddOption(worker_id=0))         # diverge
    m0.load_state(saved)                        # restore rank-0 shard

    got = m0.get(GetOption(worker_id=0))
    # rank 0's shard (rows 0-3) re-shipped from the restored truth; the
    # whole local bitmap went stale, so >= the local shard's rows ship.
    assert m0.last_incremental_rows >= 4
    np.testing.assert_allclose(got[1], 1.0)     # checkpoint value, not 2
    np.testing.assert_allclose(got[5], 1.0)


def test_sparse_sgd_reference_loose_semantics(two_rank_world):
    """Stateful updaters (sgd) use the reference's exact UpdateAddState
    semantics (sparse_matrix_table.cpp:199-223): the writer's own bits
    are untouched on Add — its view is its last pull; other workers see
    the server-side sgd step on their next incremental get."""
    svc0, svc1, peers = two_rank_world
    m0 = DistributedSparseMatrixTable(13, 10, 4, svc0, peers, rank=0,
                                      updater="sgd")
    m1 = DistributedSparseMatrixTable(13, 10, 4, svc1, peers, rank=1,
                                      updater="sgd")
    lr_opt = AddOption(worker_id=0, learning_rate=0.5)

    got0 = m0.get(GetOption(worker_id=0))      # worker 0 pulls (all zero)
    np.testing.assert_allclose(got0, 0.0)

    # worker 0 adds a gradient of +1 on row 2: server does w -= lr*delta
    m0.add_rows([2], np.ones((1, 4), dtype=np.float32), lr_opt)

    # writer's own view: last pull (zeros) — reference loose semantics
    got0 = m0.get(GetOption(worker_id=0))
    assert m0.last_incremental_rows == 0
    np.testing.assert_allclose(got0[2], 0.0)

    # the OTHER worker's incremental get ships the sgd-updated row
    # (sgd: data -= delta; the client pre-scales by lr, sgd_updater.h)
    got1 = m1.get(GetOption(worker_id=0))      # gid 1 (rank 1)
    np.testing.assert_allclose(got1[2], -1.0)

    # worker 1 now writes row 2 -> worker 0's next get refreshes it
    m1.add_rows([2], np.ones((1, 4), dtype=np.float32),
                AddOption(worker_id=0, learning_rate=0.5))
    got0 = m0.get(GetOption(worker_id=0))
    assert m0.last_incremental_rows >= 1
    np.testing.assert_allclose(got0[2], -2.0)


def test_bsp_kv_identical_views(sync_two_rank_world):
    """KV tables under -sync=true: hash-routed adds/gets tick every
    server uniformly (key residues rarely cover all shards), and each
    worker's i-th get sees both workers' first i adds."""
    import threading
    svc0, svc1, peers = sync_two_rank_world
    k0 = DistributedKVTable(33, svc0, peers, rank=0)
    k1 = DistributedKVTable(33, svc1, peers, rank=1)
    assert k0._bsp
    rounds = 4
    views = {0: [], 1: []}
    errors = []

    def worker(table, gid, key):
        try:
            for i in range(rounds):
                table.add([key], [10 ** gid])      # worker g adds 10^g
                views[gid].append(int(table.get([2])[0])
                                  + int(table.get([3])[0]))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    # worker 0 only touches key 2 (shard 0), worker 1 only key 3
    # (shard 1) — the wedge shape without uniform ticks.
    threads = [threading.Thread(target=worker, args=(k0, 0, 2)),
               threading.Thread(target=worker, args=(k1, 1, 3))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "BSP KV worker wedged"
    assert not errors, errors
    # i-th view = (i+1) * (1 + 10): both workers' first i+1 adds, and
    # identical across workers.
    for i in range(rounds):
        assert views[0][i] == views[1][i] == (i + 1) * 11, \
            (i, views[0][i], views[1][i])


def test_sparse_mirror_bounded_drift_under_bf16_wire(two_rank_world):
    """-wire_compression=bf16 with a plain-add sparse table: the client
    mirrors the bf16-ROUNDED delta (what the server actually applied), so
    repeated adds contribute ZERO mirror/server drift — the only residual
    is ONE bf16 rounding of the priming pull. Adversarial order: a peer
    first drives the table to a non-bf16-representable value, THEN the
    writer primes and hammers adds; drift must stay bounded by that one
    rounding, not grow with the add count."""
    from multiverso_tpu_torch.utils.configure import set_flag

    svc0, svc1, peers = two_rank_world
    V = 16
    m0 = DistributedSparseMatrixTable(77, V, 4, svc0, peers, rank=0)
    m1 = DistributedSparseMatrixTable(77, V, 4, svc1, peers, rank=1)
    rng = np.random.default_rng(5)
    set_flag("wire_compression", "bf16")
    try:
        # peer makes server truth non-representable in bf16 (1 + 2^-10)
        m1.add_rows(np.arange(V, dtype=np.int32),
                    np.full((V, 4), 1.0, np.float32), AddOption(worker_id=0))
        m1.add_rows(np.arange(V, dtype=np.int32),
                    np.full((V, 4), 2.0 ** -10, np.float32),
                    AddOption(worker_id=0))
        m0.get(GetOption(worker_id=0))     # prime: cache = round(truth)
        deltas = rng.normal(size=(50, V, 4)).astype(np.float32) * 0.01
        for d in deltas:
            m0.add_rows(np.arange(V, dtype=np.int32), d,
                        AddOption(worker_id=0))
        # writer's view: mirror-fresh rows, served from its cache
        mine = np.asarray(m0.get(GetOption(worker_id=0)))
        assert m0.last_incremental_rows == 0   # cache hit, not re-shipped
        # The mechanism, asserted exactly: cache == round(prime) + the sum
        # of ROUNDED deltas (what the server applied). Mirroring the raw
        # f32 deltas (the old bug) diverges from this immediately.
        from multiverso_tpu_torch.utils.quantization import (bf16_bits_to_f32,
                                                       f32_to_bf16_bits)
        rnd = lambda a: bf16_bits_to_f32(  # noqa: E731
            f32_to_bf16_bits(a)).reshape(np.shape(a))
        expect = rnd(np.full((V, 4), 1.0 + 2.0 ** -10, np.float32))
        for d in deltas:
            expect = expect + rnd(d)
        np.testing.assert_array_equal(mine, expect)
        # ...and total drift vs exact f64 server truth is bounded by ~the
        # ONE prime rounding plus per-add rounding noise, not growing
        # 50x: the unrounded-mirror bug shows up as order-of-magnitude
        # larger deviation from this bound on typical draws.
        truth = np.full((V, 4), 1.0 + 2.0 ** -10, np.float64)
        for d in deltas:
            truth = truth + rnd(d).astype(np.float64)
        assert np.abs(mine - truth).max() < 2.0 ** -9, \
            np.abs(mine - truth).max()
    finally:
        set_flag("wire_compression", "sparse")


def test_bf16_bits_nan_inf_preserved():
    from multiverso_tpu_torch.utils.quantization import (bf16_bits_to_f32,
                                                   f32_to_bf16_bits)
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0], dtype=np.float32)
    y = bf16_bits_to_f32(f32_to_bf16_bits(x))
    assert np.isnan(y[0]) and np.isnan(y[1])
    assert y[2] == np.inf and y[3] == -np.inf and y[4] == 0.0
    # signaling-NaN bit pattern also maps to a quiet NaN, not inf
    s = np.array([0x7F800001, 0xFFFFFFFF], dtype=np.uint32).view(np.float32)
    z = bf16_bits_to_f32(f32_to_bf16_bits(s))
    assert np.isnan(z).all(), z
