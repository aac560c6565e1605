"""Port parity: the streaming hot-key sketches
(``multiverso_tpu_torch.telemetry.sketch``) against the JAX package's.

Mirrors ``tests/test_sketch.py``. The module is numpy in both packages,
so every case feeds the same seeded key streams to both and compares
EXACTLY: Count-Min rows and estimates, the Space-Saving top-k with its
errors, merges, the hub's published counters and gauges, and the
advisor's CDF. The JAX file's three timeseries and alert-rule cases need
the telemetry tick and the alert engine, which the port does not have
yet (ROADMAP A11); their sketch halves (the flushed counters, the load
ratio) are covered here.
"""

import collections
import json
import threading

import numpy as np
import pytest

import _torch_port

from multiverso_tpu.telemetry import get_registry as jregistry
from multiverso_tpu.telemetry import sketch as jsk

tsk = treg = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global tsk, treg, torch
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.telemetry import get_registry as treg
    from multiverso_tpu_torch.telemetry import sketch as tsk


@pytest.fixture(autouse=True)
def _clean():
    from multiverso_tpu.telemetry import reset_telemetry as jreset
    from multiverso_tpu_torch.telemetry import reset_telemetry
    reset_telemetry()
    jreset()
    yield
    reset_telemetry()
    jreset()


def _zipf_stream(n, rows=100_000, alpha=1.3, seed=0):
    r = np.random.default_rng(seed)
    return ((r.zipf(alpha, n) - 1) % rows).astype(np.int64)


def _same_traffic(a, b):
    assert np.array_equal(a.cms.rows, b.cms.rows)
    assert a.cms.total == b.cms.total
    assert a.heavy.topk() == b.heavy.topk()
    assert (a.keys, a.bytes, a.heavy.total) == (b.keys, b.bytes,
                                                b.heavy.total)


def test_mix64_hashes_as_jax_does():
    keys = np.concatenate([np.arange(1000), _zipf_stream(1000),
                           np.asarray([2**62, -1, -(2**40)])])
    for seed in (0, 1, 7, 123):
        assert np.array_equal(tsk._mix64(keys, seed),
                              jsk._mix64(keys, seed))


# -- Count-Min -------------------------------------------------------------------

def test_cms_error_bound_on_zipf_stream():
    n, width = 200_000, 2048
    keys = _zipf_stream(n)
    cms, jcms = tsk.CountMinSketch(width, 4), jsk.CountMinSketch(width, 4)
    cms.update(keys)
    jcms.update(keys)
    assert np.array_equal(cms.rows, jcms.rows) and cms.total == n
    true = collections.Counter(keys.tolist())
    probe = np.asarray(sorted(true, key=true.get, reverse=True)[:200]
                       + list(true)[:200], dtype=np.int64)
    est = cms.estimate(probe)
    assert np.array_equal(est, jcms.estimate(probe))
    truth = np.asarray([true[int(k)] for k in probe])
    assert (est >= truth).all()
    assert (est - truth).max() <= 2 * n / width


def test_cms_update_with_explicit_counts():
    cms, jcms = tsk.CountMinSketch(64, 3), jsk.CountMinSketch(64, 3)
    for c in (cms, jcms):
        c.update(np.asarray([5, 9]), np.asarray([10, 3]))
    est = cms.estimate(np.asarray([5, 9, 7]))
    assert np.array_equal(est, jcms.estimate(np.asarray([5, 9, 7])))
    assert est[0] >= 10 and est[1] >= 3 and cms.total == 13
    assert cms.estimate(np.asarray([])).size == 0
    with pytest.raises(ValueError):
        cms.merge(tsk.CountMinSketch(128, 3))


# -- Space-Saving ----------------------------------------------------------------

def test_spacesaving_topk_recovery_and_error_bounds():
    keys = _zipf_stream(100_000, alpha=1.5, seed=1)
    ss, jss = tsk.SpaceSaving(128), jsk.SpaceSaving(128)
    ss.update(keys)
    jss.update(keys)
    assert ss.topk() == jss.topk()
    assert ss.reliable_counts() == jss.reliable_counts()
    assert len(ss) <= 128
    true = collections.Counter(keys.tolist())
    assert {k for k, _ in true.most_common(10)} <= \
        {k for k, _, _ in ss.topk(20)}
    for k, count, err in ss.topk():
        assert count - err <= true[k] <= count


def test_spacesaving_guarantee_threshold():
    keys = np.concatenate([np.full(500, 7), np.arange(1000) + 100])
    ss, jss = tsk.SpaceSaving(64), jsk.SpaceSaving(64)
    ss.update(keys)
    jss.update(keys)
    assert ss.topk() == jss.topk()
    assert 7 in {k for k, _, _ in ss.topk()}
    ss.update(np.asarray([3, 3]), np.asarray([5, 6]))
    jss.update(np.asarray([3, 3]), np.asarray([5, 6]))
    assert ss.topk() == jss.topk() and ss.total == jss.total


# -- merges ----------------------------------------------------------------------

def test_merge_associative_across_thread_shards():
    keys = _zipf_stream(60_000, alpha=1.4, seed=2)
    shards = np.array_split(keys, 3)
    sketches = [tsk.TrafficSketch(width=512, depth=4, topk=128)
                for _ in shards]
    threads = [threading.Thread(target=sk.update, args=(part,))
               for sk, part in zip(sketches, shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    def fresh(i):
        sk = tsk.TrafficSketch(width=512, depth=4, topk=128)
        sk.merge(sketches[i])
        return sk

    ab_c = fresh(0)
    ab_c.merge(sketches[1])
    ab_c.merge(sketches[2])
    bc = fresh(1)
    bc.merge(sketches[2])
    a_bc = fresh(0)
    a_bc.merge(bc)
    assert (ab_c.cms.rows == a_bc.cms.rows).all()
    assert ab_c.keys == a_bc.keys == len(keys)
    true_top = {k for k, _ in collections.Counter(keys.tolist())
                .most_common(10)}
    assert true_top <= {k for k, _, _ in ab_c.heavy.topk(10)}
    assert true_top <= {k for k, _, _ in a_bc.heavy.topk(10)}
    # ...and the JAX package's merge of the same shards, in the same
    # order, keeps the same sketch.
    jsketches = [jsk.TrafficSketch(width=512, depth=4, topk=128)
                 for _ in shards]
    for sk, part in zip(jsketches, shards):
        sk.update(part)
    j_abc = jsk.TrafficSketch(width=512, depth=4, topk=128)
    for sk in jsketches:
        j_abc.merge(sk)
    _same_traffic(ab_c, j_abc)


def test_merge_across_processes_via_state_roundtrip():
    """JSON state out of one package's sketch, merged in the other's:
    the state format is shared and the round trip is lossless."""
    keys = _zipf_stream(20_000, alpha=1.5, seed=3)
    a, b = tsk.TrafficSketch(), jsk.TrafficSketch()
    a.update(keys[:10_000], nbytes=111)
    b.update(keys[10_000:], nbytes=222)
    wire = json.dumps(b.to_state())
    b2 = tsk.TrafficSketch.from_state(json.loads(wire))
    assert (b2.cms.rows == b.cms.rows).all()
    assert b2.heavy.topk() == b.heavy.topk()
    a.merge(b2)
    assert a.keys == len(keys) and a.bytes == 333
    single = tsk.TrafficSketch()
    single.update(keys)
    assert (a.cms.rows == single.cms.rows).all()
    back = jsk.TrafficSketch.from_state(json.loads(json.dumps(a.to_state())))
    assert back.summary() == a.summary()


# -- bounded memory --------------------------------------------------------------

def test_bounded_memory_under_1m_distinct_keys():
    sk = tsk.TrafficSketch(width=1024, depth=4, topk=128)
    for lo in range(0, 1_000_000, 100_000):
        sk.update(np.arange(lo, lo + 100_000, dtype=np.int64))
    assert sk.keys == 1_000_000 and len(sk.heavy) <= 128
    assert sk.nbytes <= 1024 * 4 * 8 + 128 * 96


def test_hub_memory_bound_and_surface_cap():
    hub = tsk.SketchHub(width=256, depth=4, topk=32)
    for i in range(hub.MAX_SURFACES + 8):
        hub.record(f"s{i}", np.arange(4))
    hub.flush()
    assert len(hub.surfaces()) == hub.MAX_SURFACES
    assert hub.memory_bytes() <= hub.memory_bound()
    assert treg().counter("telemetry.sketch.surfaces_dropped").value == 8


# -- the hub: record -> flush -> registry ----------------------------------------

def test_hub_flush_publishes_metrics_from_many_threads():
    keys = _zipf_stream(30_000, alpha=1.5, seed=4)
    shards = np.array_split(keys, 4)
    hub = tsk.SketchHub(width=512, depth=4, topk=64)

    def worker(part):
        for chunk in np.array_split(part, 10):
            hub.record("serve.lookup", chunk, int(chunk.size) * 256)

    threads = [threading.Thread(target=worker, args=(p,)) for p in shards]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    hub.flush()
    s = hub.summary("serve.lookup")
    assert s["keys"] == len(keys) and s["bytes"] == len(keys) * 256
    assert s["top1_share"] > 0.2
    reg = treg()
    assert reg.counter("sketch.serve.lookup.keys").value == len(keys)
    assert reg.counter("sketch.serve.lookup.bytes").value == len(keys) * 256
    assert reg.gauge("sketch.serve.lookup.top1_share").last > 0.2
    # One JAX hub fed the same stream in one thread holds the same sketch
    # (adds commute, and the heavy hitters of each chunk fold in order).
    jhub = jsk.SketchHub(width=512, depth=4, topk=64)
    jhub.record("serve.lookup", keys, len(keys) * 256)
    jhub.flush()
    assert np.array_equal(hub.sketch("serve.lookup").cms.rows,
                          jhub.sketch("serve.lookup").cms.rows)


def test_flush_publishes_what_a_tick_would_rate():
    """The JAX tick turns the flushed counters into rates; the port has
    no tick (A11), so the watermark-driven counters themselves are
    compared: two flushes publish the two batches' keys and bytes, as
    the JAX hub's do."""
    for mod, reg in ((tsk, treg()), (jsk, jregistry())):
        mod.reset_sketches()
        mod.record_keys("ps.table_0.get", np.arange(50), 800)
        mod.get_sketch_hub().flush()
        first = reg.counter("sketch.ps.table_0.get.keys").value
        mod.record_keys("ps.table_0.get", np.arange(100), 1600)
        mod.get_sketch_hub().flush()
        assert first == 50
        assert reg.counter("sketch.ps.table_0.get.keys").value == 150
        assert reg.counter("sketch.ps.table_0.get.bytes").value == 2400


def test_record_disabled_is_a_noop():
    hub = tsk.SketchHub()
    hub.enabled = False
    hub.record("s", np.arange(10))
    hub.flush()
    assert hub.surfaces() == []
    tsk.set_sketch_enabled(False)
    tsk.record_keys("t", np.arange(3))
    tsk.get_sketch_hub().flush()
    assert tsk.get_sketch_hub().surfaces() == []


# -- the advisor's CDF -----------------------------------------------------------

def test_coverage_cdf_predicts_zipf_hit_share():
    keys = _zipf_stream(300_000, rows=50_000, alpha=1.3, seed=5)
    ss = tsk.SpaceSaving(128)
    ss.update(keys)
    counts = ss.reliable_counts()
    true = collections.Counter(keys.tolist())
    for capacity in (64, 1024, 8192):
        predicted = tsk.coverage_at(counts, len(keys), capacity)
        assert predicted == jsk.coverage_at(counts, len(keys), capacity)
        empirical = sum(c for _, c in true.most_common(capacity)) / len(keys)
        assert abs(predicted - empirical) < 0.08
    emp10 = sum(c for _, c in true.most_common(10)) / len(keys)
    assert abs(tsk.coverage_at(counts, len(keys), 10) - emp10) < 0.02


def test_coverage_edge_cases():
    assert tsk.coverage_at([], 0, 100) == 0.0
    assert tsk.coverage_at([10], 10, 1) == 1.0
    assert tsk.coverage_at([5, 3], 8, 100) <= 1.0
    for counts in ([9, 4, 2, 1, 1], [100, 1, 1, 1, 1, 1]):
        assert tsk.coverage_at(counts, 50, 40) == \
            jsk.coverage_at(counts, 50, 40)


def test_advisor_gauges_published_for_registered_cache():
    from multiverso_tpu_torch.serving import HotRowCache
    cache = HotRowCache(capacity=32)
    hot = np.arange(4)
    cache.put_rows(hot, np.ones((4, 8), np.float32), clock=0.0)
    for _ in range(20):
        assert cache.get_rows(hot, now_clock=0.0) is not None
    cache.get_rows(np.asarray([99]), now_clock=0.0)
    tsk.get_sketch_hub().flush()
    reg = treg()
    predicted = reg.gauge("serve.cache.advisor.predicted_hit_rate").snapshot()
    measured = reg.gauge("serve.cache.advisor.measured_hit_rate").snapshot()
    assert predicted["samples"] >= 1 and measured["samples"] >= 1
    assert predicted["last"] > 0.9
    assert 0.9 < measured["last"] < 1.0


@pytest.mark.parametrize("values", [[], [100.0, 100.0], [0.0, 200.0],
                                    [1.0] * 99 + [101.0], [3.0, 1.0, 2.0]])
def test_load_ratio_shapes(values):
    assert tsk.load_ratio(values) == jsk.load_ratio(values)
    want = {0: 1.0, 2: 1.0}.get(len(values))
    if values == [0.0, 200.0]:
        want = 2.0
    if want is not None:
        assert tsk.load_ratio(values) == want
