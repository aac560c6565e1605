"""Port parity: B6's plain version (``flash_block_attn_plain``, the kernel's
oracle) against the JAX package's ``flash_block_attn`` in interpret mode,
with the cases of ``tests/test_pallas_attention.py``.

Tolerances are the JAX tests' own: the normalised output ``o / max(l,
1e-20)`` within ``rtol=2e-5, atol=2e-6`` and ``l`` within ``rtol=2e-5``
(the TPU kernel sums tile by tile, the plain version in one pass); ``m``
is held bitwise on the CPU, where both sides take the same float32 dot
products' maximum, and within ``rtol=1e-6`` where the order of a dot's
sum differs. The CUDA kernel is held against the plain version on the
card by the card-only test below and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import _torch_port
from multiverso_tpu.ops.pallas_attention import flash_block_attn as jax_flash
from multiverso_tpu.ops.pallas_attention import supported as jax_supported

torch = attention = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, attention
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import attention


@pytest.fixture
def card():
    """A CUDA device, or skip: the kernel runs only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B6 is a CUDA kernel with no CPU "
                    "mode (run on the card by chip_smoke.py)")
    return torch.device("cuda", 0)


def _qkv(rng, B=2, H=3, Sq=256, Sk=384, D=64, dtype=np.float32):
    return tuple(rng.normal(size=(B, H, s, D)).astype(dtype)
                 for s in (Sq, Sk, Sk))


def _jax(q, k, v, bias=None, **kw):
    out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    None if bias is None else jnp.asarray(bias),
                    interpret=True, **kw)
    return [np.asarray(t, dtype=np.float32) for t in out]


def _port(q, k, v, bias=None, **kw):
    args = [torch.as_tensor(np.array(t, np.float32)) for t in (q, k, v)]
    b = None if bias is None else torch.as_tensor(bias)
    before = attention.LAUNCHES["flash_block_attn"]
    out = attention.flash_block_attn(*args, b, **kw)
    assert attention.LAUNCHES["flash_block_attn"] == before   # CPU: plain
    return [t.numpy() for t in out]


def _assert_close(got, want, m_exact=True, m_atol=0.0):
    (o2, m2, l2), (o1, m1, l1) = got, want
    np.testing.assert_allclose(o2 / np.maximum(l2, 1e-20),
                               o1 / np.maximum(l1, 1e-20),
                               rtol=2e-5, atol=2e-6)
    if m_exact:
        np.testing.assert_array_equal(m2, m1)
    else:
        np.testing.assert_allclose(m2, m1, rtol=1e-6, atol=m_atol)
    np.testing.assert_allclose(l2, l1, rtol=2e-5)


def _band_bias(sq, sk):
    return np.where(np.arange(sk)[None, :] > np.arange(sq)[:, None] + 100,
                    -1e30, 0.0).astype(np.float32)


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_matches_jax_flash(with_bias):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    bias = _band_bias(256, 384) if with_bias else None
    scale = float(1.0 / np.sqrt(64))
    _assert_close(_port(q, k, v, bias, scale=scale),
                  _jax(q, k, v, bias, scale=scale))


@pytest.mark.parametrize("offsets", [(0, 0), (384, 128), (128, 384)])
def test_plain_causal_offsets_match_jax_flash(offsets):
    """causal=True with the ring step's global offsets, as host ints and
    as a 2-element int32 tensor."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, Sq=128, Sk=256)
    scale = float(1.0 / np.sqrt(64))
    want = _jax(q, k, v, scale=scale, causal=True,
                offsets=jnp.asarray(offsets, jnp.int32))
    _assert_close(_port(q, k, v, scale=scale, causal=True, offsets=offsets),
                  want)
    _assert_close(_port(q, k, v, scale=scale, causal=True,
                        offsets=torch.tensor(offsets, dtype=torch.int32)),
                  want)


@pytest.mark.parametrize("how", ["bias", "causal"])
def test_plain_fully_masked_block_matches_jax_convention(how):
    """A block that is entirely masked keeps finite (o, m, l) with m at
    -1e30, so the ring merge's beta zeroes it."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, Sq=128, Sk=128)
    if how == "bias":
        kw = dict(bias=np.full((128, 128), -1e30, np.float32))
    else:                               # every key after every query
        kw = dict(causal=True, offsets=(0, 128))
    jkw = dict(kw)
    if "offsets" in jkw:
        jkw["offsets"] = jnp.asarray(jkw["offsets"], jnp.int32)
    got = _port(q, k, v, scale=0.125, **kw)
    want = _jax(q, k, v, scale=0.125, **jkw)
    for a in got:
        assert np.isfinite(a).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], np.float32(-1e30))
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)


def test_plain_ignores_keys_no_query_sees():
    """The premise of the kernel's tile skip: with q 256 and k 384 at
    offsets (0, 0), keys 256-383 are masked to every query, and large
    finite K and V rows there change no bit of the plain (o, m, l) (a
    masked score is -1e30 exactly, its p exactly 0)."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, Sq=256, Sk=384)
    k_big, v_big = k.copy(), v.copy()
    k_big[:, :, 256:] = 1e6 * rng.normal(size=k_big[:, :, 256:].shape)
    v_big[:, :, 256:] = 1e30
    kw = dict(scale=0.125, causal=True, offsets=(0, 0))
    for got, want in zip(_port(q, k_big, v_big, **kw), _port(q, k, v, **kw)):
        np.testing.assert_array_equal(got, want)


def test_plain_rows_that_see_no_key_sum_every_v():
    """Where the skip must not apply: at offsets (0, 128) no query sees
    any key, so every row is o = the sum of v over all keys, l = Sk and m
    = -1e30, and every k tile counts."""
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, Sq=128, Sk=256)
    o, m, l = _port(q, k, v, scale=0.125, causal=True, offsets=(0, 128))
    np.testing.assert_array_equal(m, np.float32(-1e30))
    np.testing.assert_array_equal(l, np.float32(256))
    np.testing.assert_allclose(
        o, np.broadcast_to(v.sum(axis=2, keepdims=True), o.shape),
        rtol=1e-5, atol=1e-5)


def test_plain_bf16_inputs_compute_in_f32():
    rng = np.random.default_rng(6)
    q, k, v = (jnp.asarray(t).astype(jnp.bfloat16)
               for t in _qkv(rng, Sq=128, Sk=256, D=64))
    want = _jax(q, k, v, scale=0.125)
    bf = [torch.as_tensor(np.array(t.astype(jnp.float32))).to(
        torch.bfloat16) for t in (q, k, v)]
    out = attention.flash_block_attn(*bf, scale=0.125)
    assert all(t.dtype == torch.float32 for t in out)
    _assert_close([t.numpy() for t in out], want)


def _plain_against_jax_at_width(d, case):
    """The plain version against the JAX kernel at heads of ``d``: causal
    at the ring's offsets, a wholly masked block (m exactly -1e30) or the
    band bias. Past D = 64 the two sides sum each dot product of D terms
    in another order (torch's and XLA's CPU products), which moves a score
    by a few 1e-6 (4.5e-6 read at D = 512): m is held to rtol 1e-6 plus
    atol 1e-5, o and l to the file's tolerances."""
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, B=1, H=2, Sq=128, Sk=256, D=d)
    kw = dict(scale=float(1.0 / np.sqrt(d)))
    bias = None
    if case.startswith("causal"):
        kw.update(causal=True, offsets=tuple(
            int(x) for x in case[8:-1].split(", ")))
    elif case == "fully masked":
        kw.update(causal=True, offsets=(0, 128))
    else:
        bias = _band_bias(128, 256)
    jkw = dict(kw)
    if "offsets" in jkw:
        jkw["offsets"] = jnp.asarray(jkw["offsets"], jnp.int32)
    got = _port(q, k, v, bias, **kw)
    want = _jax(q, k, v, bias, **jkw)
    _assert_close(got, want, m_exact=False, m_atol=1e-5)
    if case == "fully masked":
        np.testing.assert_array_equal(got[1], np.float32(-1e30))
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("d", [264, 320, 512])
@pytest.mark.parametrize("case", ["causal (0, 0)", "causal (384, 128)",
                                  "causal (128, 384)", "fully masked",
                                  "band bias"])
def test_plain_wide_heads_match_jax_flash(d, case):
    """Heads wider than 256, which the card serves with B6's wide
    instances: the plain version (their oracle there) against the JAX
    kernel."""
    _plain_against_jax_at_width(d, case)


@pytest.mark.parametrize("d", [72, 128, 192, 200, 256])
@pytest.mark.parametrize("case", ["causal (0, 0)", "causal (384, 128)",
                                  "causal (128, 384)", "band bias"])
def test_plain_narrow_widths_match_jax_flash(d, case):
    """Heads of 65-256 columns, which the card serves with the narrow
    instance of two chunks (D <= 128) and the wide instance of two chunks
    a warpgroup (D in (128, 256]): the plain version (the kernels' oracle)
    against the JAX kernel, with a last chunk of 8 columns at D = 72 and
    200."""
    _plain_against_jax_at_width(d, case)


def test_b6_instance_names_follow_the_kernel_dispatch():
    """The names the wrapper counts launches under: the narrow instances
    by 64-column chunks of D up to 128, the wide ones up to 256, 384, 512
    and past it, as ``csrc/attention.cu``'s ``with_instance`` picks
    them."""
    want = {8: "narrow d<=64", 64: "narrow d<=64", 72: "narrow d<=128",
            192: "wide d<=256", 256: "wide d<=256",
            264: "wide d<=384", 384: "wide d<=384", 392: "wide d<=512",
            512: "wide d<=512", 520: "wide d>512", 1024: "wide d>512"}
    assert {d: attention.b6_instance(d) for d in want} == want
    assert set(attention.B6_INSTANCES) == set(attention.B6_INSTANCE_NAMES)


def test_supported_gate_matches_jax():
    rng = np.random.default_rng(2)
    for sq, sk, d in ((256, 384, 64), (100, 128, 64), (128, 100, 64),
                      (128, 128, 12), (128, 256, 8)):
        q, k, _ = _qkv(rng, B=1, H=1, Sq=sq, Sk=sk, D=d)
        assert attention.supported(torch.as_tensor(q), torch.as_tensor(k)) \
            == jax_supported(jnp.asarray(q), jnp.asarray(k)), (sq, sk, d)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(t) for t in _qkv(rng, B=1, H=1, Sq=128,
                                                  Sk=128, D=64))
    with pytest.raises(ValueError, match="Sq % 128"):
        attention.flash_block_attn(q[:, :, :100], k, v, scale=1.0)
    with pytest.raises(ValueError, match="all float32 or all"):
        attention.flash_block_attn(q, k.to(torch.bfloat16), v, scale=1.0)
    with pytest.raises(ValueError, match="bias must be"):
        attention.flash_block_attn(q, k, v, torch.zeros(128, 64), scale=1.0)


def test_flash_has_no_backward():
    """As in the JAX package, B6 serves the forward pass only: the error
    comes where a gradient is needed."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(t).requires_grad_()
               for t in _qkv(rng, B=1, H=1, Sq=128, Sk=128, D=8))
    o, m, l = attention.flash_block_attn(q, k, v, scale=0.5, causal=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        (o / l).sum().backward()


@pytest.mark.parametrize("case", ["causal", "bias", "bf16", "d8", "d128",
                                  "d200", "d256", "poisoned", "d264",
                                  "d320", "d512"])
def test_kernel_matches_plain_on_card(card, case):
    """The kernel against the plain version on the same inputs; for
    ``poisoned``, the kernel on inputs with NaN in the K and V rows of
    keys 256-383, which no query sees at offsets (0, 0), against the plain
    version on the clean inputs: the kernel never reads those rows."""
    rng = np.random.default_rng(7)
    d = int(case[1:]) if case.startswith("d") else 64
    q, k, v = (torch.as_tensor(t, device=card)
               for t in _qkv(rng, Sq=256, Sk=384, D=d))
    kq, vq = k, v
    kw = dict(scale=float(1.0 / np.sqrt(d)))
    if case == "causal":
        kw.update(causal=True, offsets=(384, 128))
    if case == "poisoned":
        kw.update(causal=True, offsets=(0, 0))
        kq, vq = k.clone(), v.clone()
        kq[:, :, 256:] = float("nan")
        vq[:, :, 256:] = float("nan")
    if case == "bias":
        kw["bias"] = torch.as_tensor(_band_bias(256, 384), device=card)
    if case == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        kq, vq = k, v
    before = attention.LAUNCHES["flash_block_attn"]
    served = attention.B6_INSTANCES[attention.b6_instance(d)]
    got = [t.cpu().numpy()
           for t in attention.flash_block_attn(q, kq, vq, **kw)]
    assert attention.LAUNCHES["flash_block_attn"] == before + 1
    assert attention.B6_INSTANCES[attention.b6_instance(d)] == served + 1
    want = [t.cpu().numpy()
            for t in attention.flash_block_attn_plain(q, k, v, **kw)]
    _assert_close(got, want, m_exact=False)
