"""Port parity of continuous-batching decode (``multiverso_tpu_torch/
serving/continuous.py``): the one-process cases of
``tests/test_serving_continuous.py`` and ``tests/test_serving_paged.py``.

Every served request's tokens are held EQUAL to the JAX package's drain
runner (``AttentionLMRunner.run``, called synchronously) on the same
prompt alone: a late joiner, a reused slot and a request that queued on a
dry pool get the tokens of decoding alone. The JAX ``ContinuousBatcher``'s
threaded loop is never the oracle (ROADMAP C3). Each test closes its
batcher, whose ``close`` joins the worker thread with a timeout.
"""

import threading
import time

import numpy as np
import pytest

import _torch_port
import _torch_serving as ts

torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch
    torch = _torch_port.load_torch()


@pytest.fixture(scope="module")
def params():
    return ts.jax_params()


@pytest.fixture(scope="module")
def oracle(params):
    """solo(prompt, bucket, max_new) from the JAX drain runner, cached."""
    runners, memo = {}, {}

    def solo(prompt, bucket, max_new):
        key = (tuple(prompt), bucket, max_new)
        if key not in memo:
            if max_new not in runners:
                runners[max_new] = ts.jax_runner(params, max_new=max_new,
                                                 max_batch=3)
            memo[key] = ts.solo(runners[max_new], prompt, bucket)
        return memo[key]
    return solo


@pytest.fixture
def batchers():
    """Batchers made by the test, closed (worker joined) after it."""
    from multiverso_tpu_torch.telemetry import reset_telemetry
    reset_telemetry()
    made = []
    yield made
    for b in made:
        b.close()
        assert not b._worker.is_alive()


def _batcher(made, params, max_new, max_batch, **kw):
    from multiverso_tpu_torch.serving import ContinuousBatcher

    runner = ts.port_runner(params, max_new=max_new, max_batch=max_batch)
    cb = ContinuousBatcher(runner, max_batch=max_batch,
                           max_queue=kw.pop("max_queue", 16), **kw)
    made.append(cb)
    return cb


def _submit(cb, prompt, deadline_ms=60_000):
    return cb.submit(np.asarray(prompt, np.int32), deadline_ms=deadline_ms)


def _counter(name):
    from multiverso_tpu_torch.telemetry import get_registry
    snap = get_registry().snapshot(buckets=False)
    return snap["counters"].get(name, {}).get("value", 0)


@pytest.mark.parametrize("paged", [False, True])
def test_late_join_tokens_equal_drain(params, oracle, batchers, paged):
    """Submit A; while A decodes, B and C join into free slots: all three
    get their solo drain tokens, and the engine ran >1 slot at once."""
    from multiverso_tpu_torch.telemetry import get_registry

    prompts = [[5, 9, 2], [1], [7, 3, 3, 3, 8, 2, 40]]
    cb = _batcher(batchers, params, 8, 3, buckets=(8,), paged=paged,
                  page=4)
    f1 = _submit(cb, prompts[0])
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        eng = cb._engines.get(8)
        if eng is not None and eng.n_active() and eng.t.max() >= 1:
            break
        time.sleep(0.001)
    f2, f3 = _submit(cb, prompts[1]), _submit(cb, prompts[2])
    for p, f in zip(prompts, (f1, f2, f3)):
        assert f.wait(60).tolist() == oracle(p, 8, 8), p
    snap = get_registry().snapshot(buckets=False)
    assert snap["gauges"]["serve.continuous.active"]["max"] >= 2
    assert snap["counters"]["serve.continuous.joins"]["value"] == 3
    if paged:
        assert cb.pool.used_pages() == 0


@pytest.mark.parametrize("paged", [False, True])
def test_slot_reuse_churn_returns_every_page(params, oracle, batchers,
                                            paged):
    """6 requests through 2 slots: reused slots give the solo tokens
    (stale K/V never leaks) and the pool drains back to 0 used pages."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 60, int(n)).tolist()
               for n in rng.integers(1, 8, 6)]
    cb = _batcher(batchers, params, 4, 2, buckets=(8,), paged=paged,
                  page=4)
    futs = [_submit(cb, p) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.wait(60).tolist() == oracle(p, 8, 4), p
    if paged:
        assert cb.pool.used_pages() == 0
        assert cb.pool.max_used > 0


def test_max_new_one(params, oracle, batchers):
    cb = _batcher(batchers, params, 1, 2, buckets=(8,), paged=True, page=4)
    for p in ([5, 9, 2], [1], [7, 3, 3]):
        assert _submit(cb, p).wait(60).tolist() == oracle(p, 8, 1), p


def test_same_boundary_completions_read_once(params, oracle, batchers):
    prompts = [[5, 9, 2], [1], [7, 3, 3]]
    cb = _batcher(batchers, params, 3, 3, buckets=(8,))
    with cb._cv:        # hold the worker until all three are queued
        futs = [_submit(cb, p) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.wait(60).tolist() == oracle(p, 8, 3), p
    assert _counter("serve.continuous.batched_reads") >= 1


def test_buckets_share_one_pool(params, oracle, batchers):
    cb = _batcher(batchers, params, 3, 2, buckets=(4, 8), paged=True,
                  page=4)
    assert _submit(cb, [5, 9]).wait(60).tolist() == oracle([5, 9], 4, 3)
    assert _submit(cb, [7, 3, 3, 3, 8]).wait(60).tolist() == \
        oracle([7, 3, 3, 3, 8], 8, 3)
    assert sorted(cb._engines) == [4, 8]
    assert _submit(cb, [5, 9]).wait(60).tolist() == oracle([5, 9], 4, 3)
    assert cb.pool.used_pages() == 0


def test_page_that_does_not_divide_the_bucket(params, oracle, batchers):
    prompts = [[7, 3, 3, 3, 8, 2, 40], [5, 9, 2]]
    cb = _batcher(batchers, params, 6, 2, buckets=(8,), paged=True, page=3)
    futs = [_submit(cb, p) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.wait(60).tolist() == oracle(p, 8, 6), p


def test_dry_pool_queues_not_crashes(params, oracle, batchers):
    """A pool of 4 pages holds about one request: the others QUEUE at the
    step-boundary admission and complete with their solo tokens."""
    prompts = [[5, 9, 2], [1], [7, 3, 3, 3, 8, 2, 40]]
    cb = _batcher(batchers, params, 6, 3, buckets=(8,), paged=True, page=4,
                  pool_pages=4)
    futs = [_submit(cb, p) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.wait(60).tolist() == oracle(p, 8, 6), p
    assert _counter("serve.kv.pool_exhausted") >= 1
    assert cb.pool.used_pages() == 0


def test_request_larger_than_the_pool_is_shed(params, batchers):
    from multiverso_tpu_torch.serving import ShedError

    cb = _batcher(batchers, params, 6, 2, buckets=(8,), paged=True, page=4,
                  pool_pages=1)
    with pytest.raises(ShedError) as e:
        _submit(cb, [7, 3, 3, 3, 8, 2, 40]).wait(30)
    assert e.value.reason == "oversize"
    with pytest.raises(ShedError):
        _submit(cb, np.arange(9) + 1).wait(30)   # past the ladder


def test_admission_sheds_and_cancels(params, batchers):
    from multiverso_tpu_torch.serving import ShedError

    cb = _batcher(batchers, params, 4, 1, buckets=(4,), max_queue=8)
    with pytest.raises(ShedError) as e:
        _submit(cb, np.arange(9) + 1).wait(30)
    assert e.value.reason == "oversize"
    with pytest.raises(ShedError) as e:
        _submit(cb, [3], deadline_ms=0.0).wait(30)
    assert e.value.reason == "deadline"


def test_quiesce_and_cancel_release_claims(params, batchers):
    """Cancel a queued request while the single slot is busy, then
    quiesce: the pool drains to 0 used pages (no leaked claims)."""
    from multiverso_tpu_torch.serving import ShedError

    cb = _batcher(batchers, params, 12, 1, buckets=(8,), paged=True,
                  page=4, max_queue=8)
    running = _submit(cb, [5, 9, 2])
    done = threading.Event()
    outcome = []

    def on_done(result):
        outcome.append(result)
        done.set()

    token = cb.submit_callback(np.asarray([7], np.int32), 60_000.0, on_done)
    if token is not None and cb.cancel(token):
        assert done.wait(30)
        assert isinstance(outcome[0], ShedError)
        assert outcome[0].reason == "cancelled"
    running.wait(60)
    assert cb.quiesce(timeout_s=60)
    assert running.event.is_set()
    assert cb.pool.used_pages() == 0


class _UnsupportedDecodeRunner:
    """A decode runner for a checkpoint shape ContinuousBatcher refuses
    (``tests/test_serving_paged.py``'s stand-in)."""

    name = "unsupported_lm"
    payload_dtype = np.int32
    pad_id = 0
    max_new = 4

    def __init__(self, cfg):
        self.cfg = cfg

    def params_ref(self):
        return {}

    def run(self, batch, lengths):
        return np.zeros((batch.shape[0], self.max_new), np.int32)

    def slice_result(self, out, i, length):
        return out[i]


def test_moe_degrades_to_drain(batchers):
    from multiverso_tpu_torch.models.attention_lm import LMConfig
    from multiverso_tpu_torch.serving import (ContinuousBatcher,
                                              DynamicBatcher, ServingService)

    svc = ServingService()
    try:
        svc.register_runner(_UnsupportedDecodeRunner(LMConfig(moe_experts=2)),
                            buckets=(8,), max_batch=2, continuous=True,
                            pipeline_depth=0)
        b = svc.batcher(0)
        assert isinstance(b, DynamicBatcher)
        assert not isinstance(b, ContinuousBatcher)
        out = b.submit(np.asarray([1, 2], np.int32),
                       deadline_ms=10_000).wait(30)
        assert out.shape == (4,)
    finally:
        svc.close()


def test_register_runner_bad_paged_config_fails_fast(batchers):
    """A flag misconfiguration fails bring-up loudly, before the degrade
    guard (``service.py:120-129``)."""
    from multiverso_tpu_torch.models.attention_lm import LMConfig
    from multiverso_tpu_torch.serving import ServingService
    from multiverso_tpu_torch.utils.log import FatalError

    svc = ServingService()
    try:
        for kw in ({"paged": False, "kv_dtype": "int8"},
                   {"paged": True, "kv_dtype": "fp4"},
                   {"paged": True, "kv_page": 0},
                   {"paged": False, "prefix_entries": 8}):
            cfg_kw = dict(paged=False, kv_dtype="f32", kv_page=4,
                          kv_pages=0, prefix_entries=0)
            cfg_kw.update(kw)
            with pytest.raises(FatalError):
                svc.register_runner(
                    _UnsupportedDecodeRunner(LMConfig()), buckets=(8,),
                    max_batch=2, continuous=True, pipeline_depth=0,
                    **cfg_kw)
        assert not svc._batchers and not svc._runners
    finally:
        svc.close()


@pytest.mark.parametrize("paged", [False, True])
def test_steps_get_copies_of_the_host_counters(params, oracle, batchers,
                                               paged):
    """The C3 witness: what a step is handed (lengths, t and the page
    table) shares no memory with the engine's host arrays, which the
    worker mutates in place after queueing the step, and keeps the values
    it was handed; and a delivered row is a copy."""
    cb = _batcher(batchers, params, 4, 2, buckets=(8,), paged=paged,
                  page=4)
    name = "_step_paged_fn" if paged else "_step_fn"
    real = getattr(cb, name)
    seen = []

    def spy(*args):
        eng = cb._engines[8]
        tensors = args[2:5] if paged else args[1:3]
        host = (eng.lengths, eng.t) + ((eng.ptab,) if paged else ())
        for x, h in zip(tensors, host):
            assert not np.shares_memory(x.numpy(), h)
        seen.append(([x.clone() for x in tensors], tensors))
        return real(*args)

    setattr(cb, name, spy)
    prompts = [[5, 9, 2], [1]]
    futs = [_submit(cb, p) for p in prompts]
    for p, f in zip(prompts, futs):
        got = f.wait(60)
        assert got.tolist() == oracle(p, 8, 4), p
        # ... and what a request is answered with is no view of the
        # engine's token buffer, which the slot's next occupant rewrites.
        assert not np.shares_memory(got, cb._engines[8].out.numpy())
    assert seen
    for snapshot, handed in seen:       # nothing mutated them afterwards
        for a, b in zip(snapshot, handed):
            assert torch.equal(a, b)


def test_token_latencies_are_observed(params, batchers):
    from multiverso_tpu_torch.telemetry import get_registry

    cb = _batcher(batchers, params, 4, 2, buckets=(8,), paged=True, page=4)
    _submit(cb, [5, 9, 2]).wait(60)
    hist = get_registry().snapshot(buckets=False)["histograms"]
    assert hist["serve.latency.first_token"]["count"] == 1
    assert hist["serve.latency.per_token"]["count"] == 1
    assert hist["serve.latency.first_token"]["min_ms"] > 0
