"""Port parity: BSP (SyncServer) semantics, mirroring
``tests/test_sync_mode.py``.

The port's ``core/sync_coordinator.py`` is held against the JAX one: the
same seeded sequence of clock operations (add and get gates, commits,
``finish_train``, elastic join and leave) goes to both, and after every
operation both admit or refuse alike and report the same membership,
per-worker lags and committed clocks. Then the port's tables run the
reference's threaded cases: vector clocks, identical i-th views across
workers, the get-first loop staying live, and ``finish_train`` releasing
a straggler.
"""

import threading

import numpy as np
import pytest

import _torch_port
from multiverso_tpu.core import sync_coordinator as jsync

torch = mvt = tsync = None   # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, mvt, tsync
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.core import sync_coordinator as tsync


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


def test_vector_clock_basics_match_jax():
    ops = [("tick", 0), ("tick", 1), ("tick", 2), ("finish", 1),
           ("tick", 0), ("tick", 2), ("set", 1), ("add_slot", None),
           ("tick", 3), ("finish", 0)]
    vj, vt = jsync.VectorClock(3), tsync.VectorClock(3)
    assert vt.min() == vj.min() == 0
    for op, arg in ops:
        if op == "set":
            vj.set(arg, 1.0)
            vt.set(arg, 1.0)
        elif op == "add_slot":
            assert vt.add_slot(1.0) == vj.add_slot(1.0)
        else:
            getattr(vj, op)(arg)
            getattr(vt, op)(arg)
        assert vt.min() == vj.min(), op
        assert vt.size() == vj.size()
        assert [vt.value(i) for i in range(vt.size())] == \
            [vj.value(i) for i in range(vj.size())]
    # The reference's case: a finished worker is excluded from the min.
    vc = tsync.VectorClock(3)
    for w in (0, 1, 2):
        vc.tick(w)
    vc.finish(1)
    vc.tick(0)
    assert vc.min() == 1


def _try(fn, *args):
    """True when the gate admits at once (timeout 0), False when it would
    wait: both coordinators raise on a timed-out gate."""
    try:
        fn(*args, timeout=0.0)
        return True
    except Exception:  # noqa: BLE001 - the timed-out gate's check
        return False


def _snapshot(c):
    st = c.status()
    del st["leave_timeout_s"]
    return (st, [c.lag(w) for w in range(c.num_workers)], c.clock(),
            list(c._inflight_adds))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coordinator_matches_jax_on_a_clock_sequence(seed):
    rng = np.random.default_rng(seed)
    cj = jsync.SyncCoordinator(4, name=f"j{seed}")
    ct = tsync.SyncCoordinator(4, name=f"t{seed}")
    admitted = {"add": set(), "get": set()}
    n_ops = {"admit": 0, "refuse": 0}
    for step in range(400):
        active = ct.active_workers()
        assert active == cj.active_workers()
        op = rng.choice(["add", "get", "add", "get", "finish", "join",
                         "leave"], p=[.3, .3, .1, .1, .06, .07, .07])
        if op in ("add", "get"):
            pending = admitted[op]
            if pending and rng.random() < 0.6:
                w = sorted(pending)[int(rng.integers(len(pending)))]
                pending.discard(w)
                getattr(cj, f"commit_{op}")(w)
                getattr(ct, f"commit_{op}")(w)
            elif active:
                w = int(active[int(rng.integers(len(active)))])
                if w in admitted["add"] or w in admitted["get"]:
                    continue
                ok_j = _try(getattr(cj, f"acquire_{op}"), w)
                ok_t = _try(getattr(ct, f"acquire_{op}"), w)
                assert ok_j == ok_t, (step, op, w)
                n_ops["admit" if ok_t else "refuse"] += 1
                if ok_t:
                    pending.add(w)
        elif op == "finish" and active:
            w = int(active[int(rng.integers(len(active)))])
            if w in admitted["add"] or w in admitted["get"]:
                continue
            cj.finish_train(w)
            ct.finish_train(w)
        elif op == "join" and not admitted["add"]:
            assert ct.join(timeout=0.0) == cj.join(timeout=0.0)
        elif op == "leave" and len(active) > 1:
            w = int(active[int(rng.integers(len(active)))])
            if w in admitted["add"] or w in admitted["get"]:
                continue
            cj.leave(w)
            ct.leave(w)
        assert _snapshot(ct) == _snapshot(cj), (step, op)
    assert n_ops["admit"] > 50 and n_ops["refuse"] > 10, n_ops


def test_sync_world_size_1():
    """test_sync.cpp:9-44 shape: sync mode, one worker: round-trips."""
    mvt.init(["-sync=true", "-platform=cpu"])
    try:
        table = mvt.create_table(mvt.ArrayTableOption(size=10))
        delta = np.ones(10, dtype=np.float32)
        for i in range(3):
            table.add(delta)
            np.testing.assert_allclose(table.get(), delta * (i + 1))
    finally:
        mvt.shutdown()


def _threaded(num_workers, rounds, body, size=8):
    mvt.init(["-sync=true", "-platform=cpu"], num_local_workers=num_workers)
    try:
        table = mvt.create_table(mvt.ArrayTableOption(size=size))
        assert table._sync is not None
        views = [[] for _ in range(num_workers)]
        threads = [threading.Thread(target=body, args=(table, w, views))
                   for w in range(num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "BSP deadlock"
        return table, views
    finally:
        mvt.shutdown()


def test_bsp_identical_views_across_workers():
    """N threaded workers doing (add, get) rounds: worker w's i-th get
    equals delta * i * N whatever the interleaving."""
    num_workers, rounds = 4, 5
    delta = np.ones(8, dtype=np.float32)

    def worker(table, wid, views):
        for _ in range(rounds):
            table.add(delta, mvt.AddOption(worker_id=wid))
            views[wid].append(table.get(mvt.GetOption(worker_id=wid)).copy())

    _, views = _threaded(num_workers, rounds, worker)
    for i in range(rounds):
        for w in range(num_workers):
            np.testing.assert_array_equal(views[w][i],
                                          delta * (i + 1) * num_workers)


def test_bsp_get_first_loop_is_live():
    """The get-train-add loop must not deadlock: a worker's first Get is
    served before anyone has Added, and its i-th Get sees i adds from
    everyone."""
    num_workers, rounds = 3, 4
    delta = np.ones(8, dtype=np.float32)

    def worker(table, wid, views):
        for _ in range(rounds):
            views[wid].append(table.get(mvt.GetOption(worker_id=wid)).copy())
            table.add(delta, mvt.AddOption(worker_id=wid))

    _, views = _threaded(num_workers, rounds, worker)
    for i in range(rounds):
        for w in range(num_workers):
            np.testing.assert_array_equal(views[w][i],
                                          delta * i * num_workers)


def test_finish_train_releases_stragglers():
    """Server_Finish_Train analog: a finished worker must not block the
    others' clocks."""
    delta = np.ones(4, dtype=np.float32)
    mvt.init(["-sync=true", "-platform=cpu"], num_local_workers=2)
    try:
        table = mvt.create_table(mvt.ArrayTableOption(size=4))

        def short_worker():
            table.add(delta, mvt.AddOption(worker_id=0))
            table.get(mvt.GetOption(worker_id=0))
            table.finish_train(0)

        def long_worker():
            for _ in range(3):
                table.add(delta, mvt.AddOption(worker_id=1))
                table.get(mvt.GetOption(worker_id=1))

        t0 = threading.Thread(target=short_worker)
        t1 = threading.Thread(target=long_worker)
        t0.start()
        t1.start()
        t0.join(timeout=30)
        t1.join(timeout=30)
        assert not t0.is_alive() and not t1.is_alive(), "BSP deadlock"
        np.testing.assert_array_equal(table.get(), delta * 4)
    finally:
        mvt.shutdown()
