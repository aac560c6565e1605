"""Port parity of the prefix store (``multiverso_tpu_torch/serving/
prefix.py``) and of prefix sharing in the continuous batcher.

* ``PrefixStore`` sequences (publish, probe, consume, release, capacity
  eviction, reclaim, invalidation by a weights token) give the same hits,
  misses, entries, page references and reclaimed counts as the JAX
  ``PrefixStore`` over a JAX ``PagePool`` on the CPU, operation by
  operation.
* The batcher cases of ``tests/test_serving_paged.py``: prefix sharing
  skips the prefill and stays bitwise, under concurrent free and extend,
  evictions return pages, a weights swap invalidates, retention yields
  pages to live admissions, the weights token is monotonic. They are
  held against the port's own drain path and no-prefix runs, never the
  JAX threaded batcher (ROADMAP C3).
"""

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


def _counters(registry, names):
    snap = registry.snapshot(buckets=False)["counters"]
    return {n: snap.get(n, {}).get("value", 0) for n in names}


COUNTERS = ("serve.prefix.hits", "serve.prefix.misses",
            "serve.prefix.shared_pages", "serve.prefix.prefill_skipped",
            "serve.kv.page_evictions")


def _entry(e):
    return None if e is None else (e.tokens.tolist(), e.bucket, e.length,
                                   e.first_token, e.shared_pages,
                                   e.straddle_page, e.params_token,
                                   e.pinned, sorted(e.pages()))


def test_prefix_store_sequences_match_jax():
    from multiverso_tpu.serving.paged import PagePool as JPool
    from multiverso_tpu.serving.prefix import PrefixStore as JStore
    from multiverso_tpu.serving.prefix import prompt_key as jkey
    from multiverso_tpu.telemetry import get_registry as jreg
    from multiverso_tpu_torch.serving.paged import PagePool as TPool
    from multiverso_tpu_torch.serving.prefix import PrefixStore as TStore
    from multiverso_tpu_torch.serving.prefix import prompt_key as tkey
    from multiverso_tpu_torch.telemetry import get_registry as treg

    jpool = JPool(12, layers=1, heads=1, page=2, dh=2)
    tpool = TPool(12, layers=1, heads=1, page=2, dh=2,
                  device=torch.device("cpu"))
    jstore, tstore = JStore(jpool, 3), TStore(tpool, 3)
    j0, t0 = _counters(jreg(), COUNTERS), _counters(treg(), COUNTERS)
    a, b, c, d = [5, 9, 2], [7, 3, 3, 3, 8], [1], [4, 4]
    assert tkey(a, 8) == jkey(a, 8) and tkey(a, 8) != tkey(a, 16)

    def both(fn, *args):
        return fn(jstore, jpool, *args), fn(tstore, tpool, *args)

    def check(what, res=None):
        if res is not None:
            assert res[0] == res[1], (what, res)
        assert tpool._ref == jpool._ref, what
        assert sorted(tpool._free) == sorted(jpool._free), what
        assert tpool.used_pages() == jpool.used_pages(), what
        assert len(tstore) == len(jstore), what
        assert [_entry(e) for e in tstore._entries.values()] == \
            [_entry(e) for e in jstore._entries.values()], what
        dj = {k: v - j0[k] for k, v in _counters(jreg(), COUNTERS).items()}
        dt = {k: v - t0[k] for k, v in _counters(treg(), COUNTERS).items()}
        assert dt == dj, (what, dt, dj)

    def publish(store, pool, prompt, token, n_shared, straddle, version):
        pages = pool.alloc(n_shared + (straddle is not None))
        store.publish(prompt, 8, token, pages[:n_shared],
                      pages[n_shared] if straddle is not None else None,
                      version)
        pool.decref(pages)          # the donor slot delivers and frees
        return pages

    def probe(store, pool, prompt, version):
        return store.probe(prompt, 8, version)

    check("start")
    check("publish a", both(publish, a, 11, 1, None, 0))
    check("publish b", both(publish, b, 12, 2, 1, 0))
    e = both(probe, a, 0)
    check("probe a (hit)", (_entry(e[0]), _entry(e[1])))
    check("consume a", (jstore.consume(e[0]), tstore.consume(e[1])))
    check("slot frees a", (jpool.decref(e[0].pages()),
                           tpool.decref(e[1].pages())))
    e = both(probe, b, 0)
    check("probe b (hit)", (_entry(e[0]), _entry(e[1])))
    check("release b", (jstore.release(e[0]), tstore.release(e[1])))
    check("probe c (miss)", tuple(_entry(x) for x in both(probe, c, 0)))
    check("publish c", both(publish, c, 13, 1, None, 0))
    check("publish d (evicts the LRU)", both(publish, d, 14, 1, 1, 0))
    check("republish d (LRU refresh only)", both(publish, d, 14, 1, 1, 0))
    e = both(probe, d, 0)                               # pinned
    check("probe d", (_entry(e[0]), _entry(e[1])))
    check("reclaim 3", (jstore.reclaim(3), tstore.reclaim(3)))
    check("release d", (jstore.release(e[0]), tstore.release(e[1])))
    check("publish a again", both(publish, a, 11, 1, None, 0))
    check("probe a under new weights (invalidates)",
          tuple(_entry(x) for x in both(probe, a, 1)))
    check("publish b, new weights", both(publish, b, 15, 2, 1, 1))
    check("invalidate", (jstore.invalidate(), tstore.invalidate()))
    check("reclaim on empty", (jstore.reclaim(5), tstore.reclaim(5)))
    assert tpool.used_pages() == 0


def _solo(params, prompt, max_new, bucket=8, **kw):
    """The port's f32 drain path on ``prompt`` alone."""
    runner = ts.port_runner(params, max_new=max_new, max_batch=3, **kw)
    return ts.solo(runner, prompt, bucket)


def _batcher(made, params, max_new, max_batch, **kw):
    from multiverso_tpu_torch.serving import ContinuousBatcher

    runner = ts.port_runner(params, max_new=max_new, max_batch=max_batch)
    cb = ContinuousBatcher(runner, buckets=(8,), max_batch=max_batch,
                           max_queue=kw.pop("max_queue", 16), paged=True,
                           **kw)
    made.append(cb)
    return cb


def _submit(cb, prompt):
    return cb.submit(np.asarray(prompt, np.int32), deadline_ms=60_000)


def _count(name):
    from multiverso_tpu_torch.telemetry import get_registry
    snap = get_registry().snapshot(buckets=False)["counters"]
    return snap.get(name, {}).get("value", 0)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefix_share_skips_prefill_and_stays_bitwise(params, batchers,
                                                      kv_dtype):
    """A repeated prompt hits: prefill skipped, prompt pages shared, the
    straddle page copied on extend (page 3), tokens equal the first
    request's and, for f32, the drain path's; afterwards the pool holds
    only the store's pages."""
    long_p = [7, 3, 3, 3, 8, 2, 40]
    cb = _batcher(batchers, params, 6, 3, page=3, prefix_entries=8,
                  kv_dtype=kv_dtype)
    first = _submit(cb, long_p).wait(60).tolist()
    if kv_dtype == "f32":
        assert first == _solo(params, long_p, 6)
    assert _submit(cb, long_p).wait(60).tolist() == first
    assert _count("serve.prefix.hits") == 1
    assert _count("serve.prefix.prefill_skipped") == 1
    assert _count("serve.prefix.shared_pages") >= 1
    assert _count("serve.prefix.copy_on_extend") == 1
    assert _count("serve.continuous.joins") == 2
    entry = next(iter(cb.prefix._entries.values()))
    assert cb.pool.used_pages() == len(entry.pages()) >= 1


def test_prefix_share_under_concurrent_free_and_extend(params, batchers):
    """Donor slots free while sharers join and extend: interleaved
    repeats of two prompts across slot churn keep each prompt's drain
    tokens."""
    a, b = [7, 3, 3, 3, 8, 2, 40], [5, 9, 2]
    want = {tuple(p): _solo(params, p, 4) for p in (a, b)}
    cb = _batcher(batchers, params, 4, 2, page=3, prefix_entries=4,
                  max_queue=32)
    order = [a, b, a, a, b, a, b, a]
    futs = [_submit(cb, p) for p in order]
    for p, f in zip(order, futs):
        assert f.wait(60).tolist() == want[tuple(p)], p
    assert _count("serve.prefix.hits") >= 1
    held = sum(len(e.pages()) for e in cb.prefix._entries.values())
    assert cb.pool.used_pages() == held


def test_prefix_eviction_returns_pages(params, batchers):
    """A capacity-1 store evicts the older entry when a second prompt
    publishes; its pages return to the pool."""
    cb = _batcher(batchers, params, 3, 2, page=4, prefix_entries=1)
    for p in ([5, 9, 2], [7, 3, 3, 3, 8]):
        assert _submit(cb, p).wait(60).tolist() == _solo(params, p, 3)
    assert len(cb.prefix) == 1
    assert _count("serve.kv.page_evictions") >= 1
    entry = next(iter(cb.prefix._entries.values()))
    assert cb.pool.used_pages() == len(entry.pages())


def test_prefix_invalidated_by_param_swap(params, batchers):
    """A weights swap drops every entry: the repeat after the swap gets
    the new weights' tokens, not the stored first token."""
    prompt = [5, 9, 2]
    cb = _batcher(batchers, params, 5, 2, page=4, prefix_entries=8)
    want = _solo(params, prompt, 5)
    assert _submit(cb, prompt).wait(60).tolist() == want
    new = ts.jax_params(key=9)
    cb.runner_ref.swap_params(new)
    want2 = ts.solo(ts.port_runner(new, max_new=5, max_batch=3), prompt, 8)
    assert want2 != want
    assert _submit(cb, prompt).wait(60).tolist() == want2
    assert _count("serve.prefix.hits") == 0
    assert _count("serve.prefix.misses") == 2


def test_prefix_retention_yields_pages_to_live_admissions(params,
                                                          batchers):
    """A pool sized for about one request and a store that holds the
    previous prompt's pages: the next, different prompt still completes,
    because the allocator reclaims LRU entries."""
    prompts = [[7, 3, 3, 3, 8, 2, 40], [5, 9, 2], [1, 2, 3, 4, 5, 6]]
    cb = _batcher(batchers, params, 6, 2, page=4, pool_pages=4,
                  prefix_entries=8, max_queue=8)
    for p in prompts:
        assert _submit(cb, p).wait(60).tolist() == _solo(params, p, 6), p
    assert _count("serve.kv.page_evictions") >= 1


def test_params_token_is_monotonic_not_identity(params, batchers):
    """The store's weights token is the runner's monotonic swap version,
    which the batcher reads; the params dict's identity is not used."""
    cb = _batcher(batchers, params, 2, 1, page=4, prefix_entries=2)
    runner = cb.runner_ref
    tokens = [cb._params_token()]
    for key in (1, 2):
        runner.swap_params(ts.jax_params(key=key))
        tokens.append(cb._params_token())
    assert tokens == sorted(tokens) and len(set(tokens)) == 3
    assert tokens[-1] == runner.params_versioned()[1]


def test_prefix_cache_serves_through_the_service(params):
    """``ServingService`` with ``-serve_paged_kv``, ``-serve_kv_dtype=int8``
    and ``-serve_prefix_cache`` (the flags' defaults for register_runner)
    answers a repeated prompt from the store over the wire."""
    from multiverso_tpu_torch.serving import ServingClient, ServingService
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import (parse_cmd_flags,
                                                      reset_flags)

    reset_telemetry()
    parse_cmd_flags(["-serve_continuous=true", "-serve_paged_kv=true",
                     "-serve_kv_dtype=int8", "-serve_prefix_cache=4",
                     "-serve_kv_page=4"])
    svc = ServingService()
    try:
        runner = ts.port_runner(params, max_new=4, max_batch=2)
        svc.register_runner(runner, buckets=(8,), max_batch=2,
                            pipeline_depth=0)
        cb = svc._batchers[0]
        assert cb.pool.kv_dtype == "int8" and cb.prefix is not None
        client = ServingClient(*svc.address)
        try:
            a = client.generate(np.asarray([5, 9, 2], np.int32),
                                deadline_ms=60_000)
            b = client.generate(np.asarray([5, 9, 2], np.int32),
                                deadline_ms=60_000)
        finally:
            client.close()
        assert np.asarray(a).tolist() == np.asarray(b).tolist()
        assert _count("serve.prefix.hits") == 1
    finally:
        svc.close()
        reset_flags()
