"""Port parity of int8 KV storage (``-serve_kv_dtype=int8``): the codec
(``multiverso_tpu_torch/serving/quant.py``), B7's plain int8 read
(``ops/attention.py::paged_decode_attn_plain`` with scale planes) and the
paged step functions and batchers that encode K and V into int8 pages.

Oracles and tolerances:

* the codec is BITWISE the JAX package's ``encode_rows``/``decode_rows``
  (payload, scale and round trip) for f32, bf16 and int8, and
  ``roundtrip_bound`` is equal; ``torch.round`` and ``jnp.round`` both
  round half to even;
* the plain int8 read is within B7's ``PAGED_TOL`` (``rtol=2e-5,
  atol=2e-6``) of a JAX computation of the same read: the page gather
  with ``mode="clip"``, ``decode_rows``, masked softmax attention;
* the int8 step functions against the JAX ones at heads of 8 and of 264
  (jitted, on copies of the same inputs): payloads within one
  quantization level (a K or V value whose float32 matmul differs by an
  ulp can cross a rounding boundary), scales and the dequantized rows
  within 1e-6 plus a level, tokens equal;
* served tokens (bf16 and int8 pages) equal the port's f32 drain path on
  the reference test's prompts, and continuous int8 equals drain int8.
"""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
import _torch_serving as ts
from multiverso_tpu.serving import quant as jquant

torch = quant = attention = None  # set by _load_port

RTOL, ATOL = 2e-5, 2e-6          # chip_smoke.PAGED_TOL


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, quant, attention
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import attention
    from multiverso_tpu_torch.serving import quant


@pytest.fixture(scope="module")
def params():
    return ts.jax_params()


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    from multiverso_tpu_torch.telemetry import reset_telemetry
    reset_telemetry()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _port_bits(t) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


def _codec_inputs():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 4, 64)) * 3.0).astype(np.float32)
    x[1, 2] = 0.0                           # an all-zero row: scale 1
    x[2, 0, :4] = [127.0, 0.5, 1.5, -2.5]   # scale 1: ties at .5
    x[2, 0, 4:] = 0.0
    x[3, 1] *= 1e-30                        # tiny values
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_codec_bitwise_jax(dtype):
    x = _codec_inputs()
    jq, js = jquant.encode_rows(jnp.asarray(x), dtype)
    tq, tsc = quant.encode_rows(torch.as_tensor(x), dtype)
    assert np.array_equal(_bits(jq), _port_bits(tq)), dtype
    assert np.array_equal(_bits(js), _port_bits(tsc)), dtype
    assert tq.dtype == quant.torch_dtype(dtype)
    jb = jquant.decode_rows(jq, js, dtype)
    tb = quant.decode_rows(tq, tsc, dtype)
    assert np.array_equal(_bits(jb), _port_bits(tb)), dtype
    assert quant.roundtrip_bound(x, dtype) == jquant.roundtrip_bound(x,
                                                                     dtype)
    if dtype == "int8":
        assert tq[2, 0, :4].tolist() == [127, 0, 2, -2]     # half to even
        assert float(tsc[1, 2, 0]) == 1.0


def test_quant_roundtrip_bounded_error():
    """``tests/test_serving_paged.py``'s case: every codec's round trip
    stays within ``roundtrip_bound``; f32 is the identity (the same
    object)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4, 16)).astype(np.float32) * 3.0
    tx = torch.as_tensor(x)
    for dt in ("f32", "bf16", "int8"):
        q, s = quant.encode_rows(tx, dt)
        back = quant.decode_rows(q, s, dt).numpy()
        err = float(np.max(np.abs(back - x)))
        assert err <= quant.roundtrip_bound(x, dt) + 1e-7, (dt, err)
    q, _ = quant.encode_rows(tx, "f32")
    assert q is tx


# -- B7's plain int8 read ---------------------------------------------------
READ_CASES = {
    "serving-like": dict(H=4, dh=64, P=4, G=4, bucket=8, n_phys=16,
                         lengths=[3, 1, 7], t=[0, 2, 5]),
    "idle slot on the garbage page": dict(H=4, dh=16, P=4, G=4, bucket=8,
                                          n_phys=16, lengths=[3, 1, 7],
                                          t=[0, 0, 5], idle=1),
    "page 3 does not divide bucket 8": dict(H=2, dh=32, P=3, G=4, bucket=8,
                                            n_phys=12, lengths=[8, 2, 5],
                                            t=[0, 3, 1]),
    "long table": dict(H=2, dh=64, P=4, G=64, bucket=240, n_phys=130,
                       lengths=[5, 240], t=[3, 15]),
    "narrow rows (dh 8)": dict(H=3, dh=8, P=4, G=3, bucket=8, n_phys=9,
                               lengths=[2, 8], t=[1, 3]),
    # The serving layouts (page 16, dh 64), where the card's int8 tiles
    # hold four pages: 22 and 34 live pages, each on its own physical page
    # far from its neighbours; a slot whose live pages form two runs (the
    # prompt's 7 pages, then the generated ones past bucket 512); dh 256.
    "20+ live pages, scattered physical pages": dict(
        H=2, dh=64, P=16, G=36, bucket=512, n_phys=80, lengths=[352, 512],
        t=[0, 40], distinct=True),
    "live pages in two runs": dict(H=2, dh=64, P=16, G=36, bucket=512,
                                   n_phys=80, lengths=[100, 37],
                                   t=[20, 63], distinct=True),
    "dh 256": dict(H=2, dh=256, P=16, G=12, bucket=128, n_phys=30,
                   lengths=[100, 128], t=[5, 60], distinct=True),
}


def _read_case(name):
    c = READ_CASES[name]
    rng = np.random.default_rng(len(name))
    B = len(c["lengths"])
    q = rng.normal(size=(B, c["H"], c["dh"])).astype(np.float32)
    shape = (c["n_phys"], c["H"], c["P"], c["dh"])
    k = (rng.normal(size=shape) * 2.0).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    k[0] = 0.0                                # the garbage page
    kq, ks = jquant.encode_rows(jnp.asarray(k), "int8")
    vq, vs = jquant.encode_rows(jnp.asarray(v), "int8")
    if c.get("distinct"):
        ptab = rng.permutation(c["n_phys"])[:B * c["G"]].reshape(
            B, c["G"]).astype(np.int32)
    else:
        ptab = rng.integers(0, c["n_phys"], (B, c["G"])).astype(np.int32)
    if "idle" in c:
        ptab[c["idle"]] = 0
    ptab[0, 0] = c["n_phys"] + 3              # clipped into the pool
    return (q, np.asarray(kq), np.asarray(vq), np.asarray(ks),
            np.asarray(vs), ptab, np.asarray(c["lengths"], np.int32),
            np.asarray(c["t"], np.int32), c["bucket"], c["P"])


def _jax_int8_read(q, kq, vq, ks, vs, ptab, lengths, t, bucket, page, scale):
    """The JAX step's read of int8 pages (continuous.py:442-454, 472-477):
    gather with ``mode="clip"``, ``decode_rows``, masked softmax."""
    B, H, dh = q.shape
    G = ptab.shape[1]

    def gather(pool, sc):
        g = jnp.take(jnp.asarray(pool), ptab, axis=0, mode="clip")
        g = g.transpose(0, 2, 1, 3, 4).reshape(B, H, G * page, dh)
        s = jnp.take(jnp.asarray(sc), ptab, axis=0, mode="clip")
        s = s.transpose(0, 2, 1, 3, 4).reshape(B, H, G * page, 1)
        return jquant.decode_rows(g, s, "int8")

    kf, vf = gather(kq, ks), gather(vq, vs)
    key_slot = jnp.arange(G * page)[None, :]
    mask = (key_slot < lengths[:, None]) | \
        ((key_slot >= bucket) & (key_slot <= (bucket + t)[:, None]))
    s = jnp.einsum("bhd,bhkd->bhk", q, kf) * scale
    probs = jax.nn.softmax(jnp.where(mask[:, None], s, -jnp.inf), axis=-1)
    return np.asarray(jnp.einsum("bhk,bhkd->bhd", probs, vf))


@pytest.mark.parametrize("name", sorted(READ_CASES))
def test_plain_int8_read_matches_jax_gather_decode(name):
    q, kq, vq, ks, vs, ptab, lengths, t, bucket, page = _read_case(name)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    want = _jax_int8_read(q, kq, vq, ks, vs, ptab, lengths, t, bucket, page,
                          scale)
    T = torch.as_tensor
    before = dict(attention.LAUNCHES)
    got = attention.paged_decode_attn(
        T(q), T(kq), T(vq), T(ptab), T(lengths), T(t), bucket=bucket,
        page=page, scale=scale, ks=T(ks), vs=T(vs)).numpy()
    assert attention.LAUNCHES == before                        # CPU: plain
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_int8_read_is_a_layer_view_and_ignores_other_scales():
    """The serving step passes ``pool.kp[:, i]`` and ``pool.ks[:, i]``,
    strided views of the 5-D pool; the read is that layer's. f32 and bf16
    pages ignore the scale planes, as ``decode_rows`` does."""
    q, kq, vq, ks, vs, ptab, lengths, t, bucket, page = \
        _read_case("serving-like")
    scale = 0.125
    T = torch.as_tensor
    kw = dict(bucket=bucket, page=page, scale=scale)
    pool = {n: np.repeat(a[:, None], 3, axis=1).copy()
            for n, a in (("kp", kq), ("vp", vq), ("ks", ks), ("vs", vs))}
    pool["kp"][:, 0] = 9
    pool["ks"][:, 2] = 7.0
    view = {n: T(a)[:, 1] for n, a in pool.items()}
    got = attention.paged_decode_attn(T(q), view["kp"], view["vp"], T(ptab),
                                      T(lengths), T(t), ks=view["ks"],
                                      vs=view["vs"], **kw)
    want = attention.paged_decode_attn(T(q), T(kq), T(vq), T(ptab),
                                       T(lengths), T(t), ks=T(ks), vs=T(vs),
                                       **kw)
    assert torch.equal(got, want)
    kf = T(kq).float()
    plain = attention.paged_decode_attn(T(q), kf, kf, T(ptab), T(lengths),
                                        T(t), **kw)
    junk = torch.full(ks.shape, float("nan"))
    assert torch.equal(plain, attention.paged_decode_attn(
        T(q), kf, kf, T(ptab), T(lengths), T(t), ks=junk, vs=junk, **kw))


# -- the step functions -----------------------------------------------------
def _jax_steps(page, max_new, kv_dtype, cfg):
    from multiverso_tpu.models.attention_lm import LMConfig
    from multiverso_tpu.serving.continuous import ContinuousBatcher

    me = types.SimpleNamespace(cfg=LMConfig(**cfg), max_new=max_new,
                               page=page, kv_dtype=kv_dtype)

    def bound(name):
        return jax.jit(functools.partial(getattr(ContinuousBatcher, name),
                                         me, 8))
    return bound("_prefill_paged_fn"), bound("_step_paged_fn")


#: An LM of heads wider than 256 columns (B7's wide instances on a card):
#: ``tests/test_torch_serving_wide.py``'s.
WIDE_CFG = dict(ts.CFG, dim=528, heads=2)


def test_int8_paged_step_functions_match_jax(params):
    """Two prompts prefilled into int8 pages, then 3 steps: payloads
    within one level, scales and dequantized pages close, ``out`` and
    ``tok`` equal, after every call."""
    _hold_int8_steps(params, ts.CFG)


def test_int8_paged_step_functions_match_jax_at_wide_heads():
    """The same at 2 heads of 264 columns (JAX weights of that LM)."""
    _hold_int8_steps(ts.jax_params(cfg=WIDE_CFG), WIDE_CFG)


def _hold_int8_steps(params, cfg):
    from multiverso_tpu_torch.serving import ContinuousBatcher, page_plan

    P, N, B, S = 3, 4, 3, 8
    jpre, jstep = _jax_steps(P, N, "int8", cfg)
    runner = ts.port_runner(params, cfg, max_new=N, max_batch=B)
    cb = ContinuousBatcher(runner, buckets=(S,), max_batch=B, paged=True,
                           page=P, kv_dtype="int8")
    try:
        G = cb._engine_for(S).n_logical
        L, H = cfg["layers"], cfg["heads"]
        dh = cfg["dim"] // H
        rng = np.random.default_rng(1)
        n_phys = 16
        shape = (n_phys, L, H, P, dh)
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:-1] + (1,)).astype(np.float32) * 0.05
        vs = rng.random(ks.shape).astype(np.float32) * 0.05
        out = np.zeros((B, N), np.int32)
        tok = np.zeros(B, np.int32)
        ptab = np.zeros((B, G), np.int32)
        free = iter(range(1, n_phys))
        prompts = {0: [5, 9, 2], 1: [7, 3, 3, 3, 8, 2, 40]}
        lengths = np.ones(B, np.int32)
        jstate = [jnp.asarray(x) for x in (kp, vp, ks, vs, out, tok)]
        pstate = [torch.tensor(x) for x in (kp, vp, ks, vs, out, tok)]
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        pparams = runner.params_ref()

        def check(what):
            jk, jv, jks, jvs = (np.asarray(x) for x in jstate[:4])
            tk, tv, tks, tvs = (x.numpy() for x in pstate[:4])
            for j, p in ((jk, tk), (jv, tv)):
                assert p.dtype == np.int8
                assert np.abs(j.astype(np.int32) - p).max() <= 1, what
            np.testing.assert_allclose(tks, jks, rtol=1e-6, atol=1e-7,
                                       err_msg=what)
            np.testing.assert_allclose(tvs, jvs, rtol=1e-6, atol=1e-7,
                                       err_msg=what)
            np.testing.assert_allclose(tk * tks, jk * jks, rtol=1e-6,
                                       atol=1.01 * jks.max(), err_msg=what)
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
                S, pparams, torch.tensor(tokens), torch.tensor(length), slot,
                torch.tensor(pages), *pstate))
            check(f"prefill slot {slot}")
        t = np.zeros(B, np.int32)
        for step in range(N - 1):
            jstate = list(jstep(jparams, jnp.asarray(lengths),
                                jnp.asarray(t), jnp.asarray(ptab),
                                *jstate))
            pstate = list(cb._step_paged_fn(
                S, pparams, torch.tensor(lengths), torch.tensor(t),
                torch.tensor(ptab), *pstate))
            check(f"step {step}")
            t[:2] += 1
    finally:
        cb.close()


# -- served tokens ------------------------------------------------------------
PROMPTS = [[7, 3, 3, 3, 8, 2, 40], [5, 9, 2], [1]]


def _serve(runner, prompts, **kw):
    from multiverso_tpu_torch.serving import ContinuousBatcher

    cb = ContinuousBatcher(runner, buckets=(8,), max_batch=3, max_queue=16,
                           paged=True, page=4, **kw)
    try:
        futs = [cb.submit(np.asarray(p, np.int32), deadline_ms=60_000)
                for p in prompts]
        got = [f.wait(60).tolist() for f in futs]
        assert cb.pool.used_pages() == 0
        return got
    finally:
        cb.close()


def test_kv_dtype_greedy_token_parity(params):
    """``tests/test_serving_paged.py``'s case on the port: bf16 and int8
    pages give the greedy tokens of the port's f32 drain path on these
    prompts (the bounded dequantization error flips no argmax here)."""
    f32 = ts.port_runner(params, max_new=6, max_batch=3)
    want = [ts.solo(f32, p, 8) for p in PROMPTS]
    for dt in ("bf16", "int8"):
        assert _serve(f32, PROMPTS, kv_dtype=dt) == want, dt


def test_int8_continuous_equals_int8_drain(params):
    """Continuous paged int8 against the drain paged int8 runner, prompt
    by prompt, and a batch of mixed lengths through the drain runner."""
    drain = ts.port_runner(params, max_new=5, max_batch=3, paged=True,
                           kv_dtype="int8", page=4)
    prompts = PROMPTS + [[2, 4, 6, 8, 10, 12], [33, 1]]
    want = [ts.solo(drain, p, 8) for p in prompts]
    assert drain._pool.kp.dtype == torch.int8
    assert drain._pool.used_pages() == 0
    got = _serve(ts.port_runner(params, max_new=5, max_batch=3), prompts,
                 kv_dtype="int8")
    assert got == want
    rng = np.random.default_rng(3)
    mat, lens = ts.random_batch(rng, 3, 8)
    out = drain.run(mat, lens)
    for i in range(3):
        assert out[i].tolist() == \
            ts.solo(drain, mat[i, :lens[i]].tolist(), 8), i
