"""Port parity of the LM decode runner (``multiverso_tpu_torch/serving/
runners.py`` and the step functions of ``continuous.py``) against the JAX
package, on the CPU, with the same numpy weights (JAX ``init_params`` at
``PRNGKey(0)``; the LM of ``serve_bench.py``'s dry run).

Oracles: the JAX ``AttentionLMRunner.run`` (drain modes, called
synchronously) and the JAX step functions (``_prefill_fn``, ``_step_fn``,
``_prefill_paged_fn``, ``_step_paged_fn``) called directly, jitted, on
copies of the same numpy inputs (never the JAX batcher's worker loop:
ROADMAP C3). Caches and pools are held within 1e-6, absolute plus
relative (``rtol=atol=1e-6``: XLA's and torch's float32 CPU matmuls sum
in another order, a few ulps of values near 1 after two layers); greedy
tokens are held equal.
"""

import functools
import types

import numpy as np
import pytest

import _torch_port
import _torch_serving as ts

torch = None  # set by _load_port

CACHE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch
    torch = _torch_port.load_torch()


@pytest.fixture(scope="module")
def params():
    return ts.jax_params()


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    from multiverso_tpu_torch.telemetry import reset_telemetry
    reset_telemetry()


def _jax_steps(paged, page=4, max_new=4):
    """The JAX ContinuousBatcher's step functions on a stand-in ``self``
    (no worker thread is started), jitted."""
    import jax

    from multiverso_tpu.models.attention_lm import LMConfig
    from multiverso_tpu.serving.continuous import ContinuousBatcher

    me = types.SimpleNamespace(cfg=LMConfig(**ts.CFG), max_new=max_new,
                               page=page, kv_dtype="f32")

    def bound(name, *static):
        return jax.jit(functools.partial(getattr(ContinuousBatcher, name),
                                         me, *static))
    if paged:
        return bound("_prefill_paged_fn", 8), bound("_step_paged_fn", 8)
    return bound("_prefill_fn"), bound("_step_fn")


def _port_batcher(params, paged, page=4, max_new=4, max_batch=3):
    """A port ContinuousBatcher whose worker sits idle (no submits)."""
    from multiverso_tpu_torch.serving import ContinuousBatcher

    runner = ts.port_runner(params, max_new=max_new, max_batch=max_batch)
    return ContinuousBatcher(runner, buckets=(8,), max_batch=max_batch,
                             paged=paged, page=page)


def _t(x, dtype=None):
    return torch.tensor(np.array(x), dtype=dtype)


def test_paged_prefill_and_step_match_jax_step_functions(params):
    """Two prompts prefilled into their pages, then 3 steps with per-slot
    counters (slot 2 idle on the garbage page): the pool within 1e-6 of
    the JAX step's, ``out`` and ``tok`` equal, after every call."""
    import jax.numpy as jnp

    from multiverso_tpu_torch.serving import page_plan

    P, N, B, S = 3, 4, 3, 8
    jpre, jstep = _jax_steps(True, page=P, max_new=N)
    cb = _port_batcher(params, True, page=P, max_new=N, max_batch=B)
    try:
        G = cb._engine_for(S).n_logical
        L, H, dh = 2, 4, 8
        rng = np.random.default_rng(1)
        n_phys = 16
        kp = rng.normal(size=(n_phys, L, H, P, dh)).astype(np.float32)
        vp = rng.normal(size=kp.shape).astype(np.float32)
        ks = np.ones(kp.shape[:-1] + (1,), np.float32)
        vs = ks.copy()
        out = np.zeros((B, N), np.int32)
        tok = np.zeros(B, np.int32)
        ptab = np.zeros((B, G), np.int32)
        free = iter(range(1, n_phys))
        prompts = {0: [5, 9, 2], 1: [7, 3, 3, 3, 8, 2, 40]}
        lengths = np.ones(B, np.int32)
        jstate = [jnp.asarray(x) for x in (kp, vp, ks, vs, out, tok)]
        pstate = [_t(x) for x in (kp, vp, ks, vs, out, tok)]
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        pparams = cb.runner_ref.params_ref()

        def check(what):
            for j, p in zip(jstate[:4], pstate[:4]):
                np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                           err_msg=what, **CACHE_TOL)
            for j, p in zip(jstate[4:], pstate[4:]):
                np.testing.assert_array_equal(p.numpy(), np.asarray(j),
                                              err_msg=what)

        for slot, prompt in prompts.items():
            plan = page_plan(len(prompt), S, N, P)
            for logical in (*plan.shared, *plan.private):
                ptab[slot, logical] = next(free)
            tokens = np.zeros((1, S), np.int32)
            tokens[0, :len(prompt)] = prompt
            lengths[slot] = len(prompt)
            pages = ptab[slot, :plan.n_prompt].copy()
            length = np.asarray([len(prompt)], np.int32)
            jstate = list(jpre(jparams, jnp.asarray(tokens),
                               jnp.asarray(length), jnp.int32(slot),
                               jnp.asarray(pages), *jstate))
            pstate = list(cb._prefill_paged_fn(
                S, pparams, _t(tokens), _t(length), slot, _t(pages),
                *pstate))
            check(f"prefill slot {slot}")
        t = np.zeros(B, np.int32)
        for step in range(N - 1):
            jstate = list(jstep(jparams, jnp.asarray(lengths),
                                jnp.asarray(t), jnp.asarray(ptab),
                                *jstate))
            pstate = list(cb._step_paged_fn(
                S, pparams, _t(lengths), _t(t), _t(ptab), *pstate))
            check(f"step {step}")
            t[:2] += 1
    finally:
        cb.close()


def test_prealloc_prefill_and_step_match_jax_step_functions(params):
    import jax.numpy as jnp

    N, B, S = 4, 3, 8
    jpre, jstep = _jax_steps(False, max_new=N)
    cb = _port_batcher(params, False, max_new=N, max_batch=B)
    try:
        shape = cb.runner_ref.cache_shape(S, B)
        rng = np.random.default_rng(2)
        ck = rng.normal(size=shape).astype(np.float32)
        cv = rng.normal(size=shape).astype(np.float32)
        out = np.zeros((B, N), np.int32)
        tok = np.zeros(B, np.int32)
        jstate = [jnp.asarray(x) for x in (ck, cv, out, tok)]
        pstate = [_t(x) for x in (ck, cv, out, tok)]
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        pparams = cb.runner_ref.params_ref()
        lengths = np.ones(B, np.int32)

        def check(what):
            for j, p in zip(jstate[:2], pstate[:2]):
                np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                           err_msg=what, **CACHE_TOL)
            for j, p in zip(jstate[2:], pstate[2:]):
                np.testing.assert_array_equal(p.numpy(), np.asarray(j),
                                              err_msg=what)

        for slot, prompt in ((1, [5, 9, 2]), (2, [1])):
            tokens = np.zeros((1, S), np.int32)
            tokens[0, :len(prompt)] = prompt
            lengths[slot] = len(prompt)
            length = np.asarray([len(prompt)], np.int32)
            jstate = list(jpre(jparams, jnp.asarray(tokens),
                               jnp.asarray(length), jnp.int32(slot),
                               *jstate))
            pstate = list(cb._prefill_fn(pparams, _t(tokens), _t(length),
                                         slot, *pstate))
            check(f"prefill slot {slot}")
        t = np.zeros(B, np.int32)
        for step in range(N - 1):
            jstate = list(jstep(jparams, jnp.asarray(lengths),
                                jnp.asarray(t), *jstate))
            pstate = list(cb._step_fn(pparams, _t(lengths), _t(t),
                                      *pstate))
            check(f"step {step}")
            t[1:] += 1
    finally:
        cb.close()


@pytest.mark.parametrize("mode", ["prealloc", "paged page 4",
                                  "paged page 3", "paged bf16"])
def test_drain_tokens_equal_jax_runner(params, mode):
    """The drain decode (prefill + the step loop) gives the JAX runner's
    tokens, per bucket, and a paged batch returns its pages at collect."""
    kw = {} if mode == "prealloc" else dict(paged=True, page=int(mode[-1])
                                            if mode[-1].isdigit() else 4)
    if mode == "paged bf16":
        kw["kv_dtype"] = "bf16"
    jr = ts.jax_runner(params, max_new=4, max_batch=3, **kw)
    pr = ts.port_runner(params, max_new=4, max_batch=3, **kw)
    rng = np.random.default_rng(3)
    for bucket in (8, 16):
        mat, lens = ts.random_batch(rng, 3, bucket)
        np.testing.assert_array_equal(pr.run(mat, lens), jr.run(mat, lens),
                                      err_msg=f"bucket {bucket}")
    if kw.get("paged"):
        assert pr._pool.used_pages() == 0
        assert pr.pool_high_water() > 0


def test_paged_tokens_equal_prealloc_tokens(params):
    """On the CPU the paged read (the plain gather) and the preallocated
    read compute one function: equal tokens, buckets 8 and 16, pages 4
    and 3 (a straddle page)."""
    pre = ts.port_runner(params, max_new=4, max_batch=3)
    rng = np.random.default_rng(4)
    for page in (4, 3):
        paged = ts.port_runner(params, max_new=4, max_batch=3, paged=True,
                               page=page)
        for bucket in (8, 16):
            mat, lens = ts.random_batch(rng, 3, bucket)
            np.testing.assert_array_equal(paged.run(mat, lens),
                                          pre.run(mat, lens))


def test_served_tokens_match_full_forward(params):
    """KV-cached greedy decode through the serving plane equals the
    recompute-everything greedy loop on the port's full ``forward``
    (``test_serving_e2e.py:228``)."""
    from multiverso_tpu_torch.models.attention_lm import LMConfig, forward
    from multiverso_tpu_torch.serving import ServingClient, ServingService

    cfg = LMConfig(**ts.CFG)
    runner = ts.port_runner(params, max_new=4, max_batch=3)
    tparams = {k: torch.tensor(v) for k, v in params.items()}

    def ref_decode(prompt, n):
        toks = list(prompt)
        for _ in range(n):
            logits, _ = forward(tparams, torch.tensor([toks]), cfg)
            toks.append(int(torch.argmax(logits[0, -1])))
        return toks[len(prompt):]

    svc = ServingService()
    svc.register_runner(runner, buckets=(8,), max_batch=3, max_wait_ms=1.0,
                        pipeline_depth=0)
    cli = ServingClient(*svc.address)
    try:
        for prompt in ([5, 9, 2], [1], [7, 3, 3, 3, 8, 2, 40]):
            got = cli.generate(np.asarray(prompt, np.int32),
                               deadline_ms=60_000, timeout=120)
            assert got.tolist() == ref_decode(prompt, 4), prompt
    finally:
        cli.close()
        svc.close()


def test_drain_pool_grows_instead_of_deadlocking(params):
    from multiverso_tpu_torch.telemetry import get_registry

    jr = ts.jax_runner(params, max_new=4, max_batch=2)
    pr = ts.port_runner(params, max_new=4, max_batch=2, paged=True, page=4,
                        pool_pages=2)
    mat = np.zeros((2, 8), np.int32)
    mat[0, :3] = [5, 9, 2]
    mat[1, :2] = [7, 3]
    lens = np.asarray([3, 2], np.int32)
    np.testing.assert_array_equal(pr.run(mat, lens), jr.run(mat, lens))
    snap = get_registry().snapshot(buckets=False)
    assert snap["counters"]["serve.kv.pool_grows"]["value"] >= 1
    assert pr._pool.capacity > 2 and pr._pool.used_pages() == 0


def test_failed_launch_releases_pages(params, monkeypatch):
    pr = ts.port_runner(params, max_new=4, max_batch=2, paged=True, page=4)
    mat = np.zeros((2, 8), np.int32)
    mat[:, 0] = 5
    lens = np.asarray([1, 1], np.int32)
    pr.run(mat, lens)

    def boom(*a, **k):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(pr, "_decode_paged", boom)
    with pytest.raises(RuntimeError, match="launch refused"):
        pr.dispatch(mat, lens)
    assert pr._pool.used_pages() == 0


def test_int8_kv_and_prefix_cache_raise(params):
    """int8 KV and the prefix cache (refusals until they were ported)
    build and serve on every surface: the drain runner, the continuous
    batcher and ``ServingService.register_runner``."""
    from multiverso_tpu_torch.serving import (ContinuousBatcher,
                                              ServingService)

    drain = ts.port_runner(params, paged=True, kv_dtype="int8", page=4,
                           max_new=3, max_batch=2)
    assert len(ts.solo(drain, [5, 9, 2], 8)) == 3
    assert drain._pool.kp.dtype == torch.int8
    runner = ts.port_runner(params, max_new=2, max_batch=2)
    for kw in ({"kv_dtype": "int8"}, {"prefix_entries": 8},
               {"kv_dtype": "int8", "prefix_entries": 8}):
        cb = ContinuousBatcher(runner, buckets=(8,), paged=True, **kw)
        try:
            assert cb.pool.kv_dtype == kw.get("kv_dtype", "f32")
            assert (cb.prefix is not None) == ("prefix_entries" in kw)
        finally:
            cb.close()
    svc = ServingService()
    try:
        for rid, kw in enumerate(({"kv_dtype": "int8"},
                                  {"prefix_entries": 4})):
            svc.register_runner(runner, runner_id=rid, buckets=(8,),
                                max_batch=2, continuous=True, paged=True,
                                pipeline_depth=0, **kw)
            assert isinstance(svc._batchers[rid], ContinuousBatcher)
    finally:
        svc.close()


@pytest.mark.parametrize("fault", ["missing name", "extra name", "shape",
                                   "dtype"])
def test_bad_weights_refused_before_anything_moves(params, fault,
                                                   monkeypatch):
    from multiverso_tpu_torch.utils.log import FatalError

    bad = dict(params)
    if fault == "missing name":
        del bad["mlp_out_1"]
    elif fault == "extra name":
        bad["moe_router_0"] = np.zeros((32, 2), np.float32)
    elif fault == "shape":
        bad["qkv_0"] = bad["qkv_0"][:, :-1]
    else:
        bad["embed"] = bad["embed"].astype(np.float64)
    moved = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor",
                        lambda *a, **k: moved.append(1) or real(*a, **k))
    with pytest.raises(FatalError):
        ts.port_runner(bad, max_new=2, max_batch=2)
    assert not moved


def test_swap_params_versions_and_tokens(params):
    """A hot-swap bumps the monotonic version and the next batch serves
    the new weights (the JAX runner's tokens for them)."""
    runner = ts.port_runner(params, max_new=4, max_batch=3)
    _, v0 = runner.params_versioned()
    new = ts.jax_params(key=9)
    runner.swap_params(new)
    _, v1 = runner.params_versioned()
    assert v1 == v0 + 1
    want = ts.solo(ts.jax_runner(new, max_new=4, max_batch=3), [5, 9, 2], 8)
    assert ts.solo(runner, [5, 9, 2], 8) == want
