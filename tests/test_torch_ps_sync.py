"""Port mirror of ``tests/test_ps_sync.py``: its cases that are not marked
slow, run against ``multiverso_tpu_torch`` with every shard on the CPU
(``-platform=cpu``), in one process over loopback TCP."""

import threading
import time

import numpy as np
import pytest

import _torch_port

# Set by _load_port.
AddOption = DistributedArrayTable = GetOption = PSService = mv = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global AddOption, DistributedArrayTable, GetOption, PSService, mv
    _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.core.options import AddOption, GetOption
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedArrayTable, PSService)


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
def sync_two_rank_world():
    """-sync=true world: 2 ranks x 2 local workers in one process."""
    mv.init(["-platform=cpu", "-sync=true"], num_local_workers=2)
    svc0 = PSService()
    svc1 = PSService()
    peers = [svc0.address, svc1.address]
    yield svc0, svc1, peers
    svc0.close()
    svc1.close()
    mv.shutdown()


def _worker_loop(table, local_wid, rounds, size, views, errors):
    delta = np.ones(size, dtype=np.float32)
    try:
        for i in range(rounds):
            table.add(delta, AddOption(worker_id=local_wid))
            got = table.get(GetOption(worker_id=local_wid))
            views.append((i, got.copy()))
    except Exception as e:  # noqa: BLE001 - surfaced by the main thread
        errors.append(e)


def test_sync_identical_views_2rank_2thread(sync_two_rank_world):
    """Every worker's i-th Get is identical — and equal to the closed form
    delta * (i+1) * num_workers (ref test_array_table.cpp:14-42)."""
    svc0, svc1, peers = sync_two_rank_world
    size, rounds = 32, 5
    t0 = DistributedArrayTable(1, size, svc0, peers, rank=0)
    t1 = DistributedArrayTable(1, size, svc1, peers, rank=1)
    assert t0._bsp and t1._bsp

    views = {k: [] for k in range(4)}
    errors = []
    threads = [
        threading.Thread(target=_worker_loop,
                         args=(table, lw, rounds, size,
                               views[r * 2 + lw], errors))
        for r, table in ((0, t0), (1, t1)) for lw in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive(), "BSP worker wedged"
    assert not errors, errors

    for w, seq in views.items():
        assert len(seq) == rounds
        for i, got in seq:
            np.testing.assert_allclose(
                got, np.full(size, (i + 1) * 4.0),
                err_msg=f"worker {w} round {i}")


def test_sync_finish_train_releases_stragglers(sync_two_rank_world):
    """A worker that stops participating retires via Server_Finish_Train
    (clock -> infinity, ref src/server.cpp:190-213); the others' gates
    then exclude it and training drains deterministically."""
    svc0, svc1, peers = sync_two_rank_world
    size = 16
    t0 = DistributedArrayTable(2, size, svc0, peers, rank=0)
    t1 = DistributedArrayTable(2, size, svc1, peers, rank=1)

    short_rounds, long_rounds = 2, 4
    views = {k: [] for k in range(4)}
    errors = []

    def short_worker():     # rank 0, local worker 0: quits early
        _worker_loop(t0, 0, short_rounds, size, views[0], errors)
        t0.finish_train(0)

    threads = [threading.Thread(target=short_worker)] + [
        threading.Thread(target=_worker_loop,
                         args=(table, lw, long_rounds, size,
                               views[r * 2 + lw], errors))
        for r, table, lw in ((0, t0, 1), (1, t1, 0), (1, t1, 1))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive(), "BSP worker wedged after finish_train"
    assert not errors, errors

    # closed form: 3 live workers + the retiree's min(i+1, short) adds
    for w in (1, 2, 3):
        for i, got in views[w]:
            expect = 3.0 * (i + 1) + min(i + 1, short_rounds)
            np.testing.assert_allclose(got, np.full(size, expect),
                                       err_msg=f"worker {w} round {i}")


def test_async_mode_unaffected(mv_env):
    """Without -sync the gate must not exist: LocalForward stays on and no
    clock state is allocated."""
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    t0 = DistributedArrayTable(3, 10, svc0, peers, rank=0)
    DistributedArrayTable(3, 10, svc1, peers, rank=1)
    assert not t0._bsp
    assert not svc0._sync and not svc1._sync
    t0.add(np.ones(10, dtype=np.float32))
    np.testing.assert_allclose(t0.get(), np.ones(10))
    svc0.close(); svc1.close()


def test_per_worker_updater_state_spans_dcn_world(mv_env):
    """AdaGrad per-worker accumulators must be sized by the DCN worker
    universe (world x local), not zoo.num_workers() — separate JAX runtimes
    report process_count()==1, so remote ranks' stamped worker ids would
    index out of bounds and their G^2 updates silently drop (review r3)."""
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    t0 = DistributedArrayTable(4, 8, svc0, peers, rank=0, updater="adagrad")
    t1 = DistributedArrayTable(4, 8, svc1, peers, rank=1, updater="adagrad")
    assert t0.local_store.num_workers == 2
    # each rank's adds must land in DISTINCT accumulator slots
    t0.add(np.ones(8, dtype=np.float32), AddOption(worker_id=0))
    t1.add(np.ones(8, dtype=np.float32), AddOption(worker_id=0))
    g2 = np.asarray(t0.local_store.state["g2"])
    assert g2.shape[0] == 2
    shard = t0.offsets[1] - t0.offsets[0]    # real rows; rest is padding
    assert (g2[0][:shard] > 0).all() and (g2[1][:shard] > 0).all()
    svc0.close(); svc1.close()


def test_bsp_fuzz_identical_views_with_jitter(sync_two_rank_world):
    """Fuzz the clock-gated dispatch: 2 ranks x 2 local workers with
    random per-round deltas and random timing jitter. The BSP invariant
    must hold regardless of interleaving: every worker's i-th Get is
    IDENTICAL across all four workers, and equals the sum of all
    workers' rounds 0..i of deltas."""
    import random

    svc0, svc1, peers = sync_two_rank_world
    size, rounds = 16, 6
    t0 = DistributedArrayTable(40, size, svc0, peers, rank=0)
    t1 = DistributedArrayTable(40, size, svc1, peers, rank=1)

    # delta[w][i]: deterministic per (worker, round) so the closed form
    # is computable; values differ per worker/round.
    def delta(w, i):
        return np.full(size, float((w + 1) * 100 + i), dtype=np.float32)

    views = {w: [] for w in range(4)}
    errors = []

    def worker(table, lw, gid, seed):
        rng = random.Random(seed)
        try:
            for i in range(rounds):
                time.sleep(rng.random() * 0.02)
                table.add(delta(gid, i), AddOption(worker_id=lw))
                time.sleep(rng.random() * 0.02)
                views[gid].append(table.get(GetOption(worker_id=lw)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker,
                                args=(tbl, lw, r * 2 + lw, 31 + r * 2 + lw))
               for r, tbl in ((0, t0), (1, t1)) for lw in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=180)
        assert not th.is_alive(), "BSP fuzz worker wedged"
    assert not errors, errors

    for i in range(rounds):
        expect = np.zeros(size, dtype=np.float32)
        for w in range(4):
            for j in range(i + 1):
                expect += delta(w, j)
        for w in range(4):
            np.testing.assert_allclose(
                views[w][i], expect,
                err_msg=f"worker {w} round {i} diverged")
