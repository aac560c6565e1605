"""Port parity: B7's plain version (``paged_decode_attn_plain``, the
kernel's oracle and the CPU's read) against the JAX package's
``paged_decode_attn`` in interpret mode and against the JAX serving
step's gather formulation, on the same numpy inputs.

Tolerance: ``rtol=2e-5, atol=2e-6``, the JAX package's own
(``tests/test_pallas_attention.py:163-199``): the TPU kernel sums page by
page with an online softmax, the gather formulation in one pass. The CUDA
kernel is held against the plain version on the card by the card-only
test below and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
from multiverso_tpu.ops.pallas_attention import \
    paged_decode_attn as jax_paged

torch = attention = None  # set by _load_port

RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, attention
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import attention


@pytest.fixture
def card():
    """A CUDA device, or skip: the kernel runs only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B7 is a CUDA kernel with no CPU "
                    "mode (run on the card by chip_smoke.py)")
    return torch.device("cuda", 0)


def _bf16(x):
    """``x`` rounded to bfloat16 values, kept as float32 numpy."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _case(name):
    """Inputs of one case: (q, kp, vp, ptab, lengths, t, bucket, page,
    bf16). The first is ``test_pallas_attention.py:163-199``'s."""
    rng = np.random.default_rng(0)
    B, H, dh, P, G, bucket, n_phys = 3, 4, 8, 4, 4, 8, 16
    lengths = np.asarray([3, 1, 7], np.int32)
    t = np.asarray([0, 2, 5], np.int32)
    bf16 = False
    if name == "bf16 pool":
        bf16 = True
    elif name == "idle slot on the garbage page":
        lengths = np.asarray([3, 1, 7], np.int32)
        t = np.asarray([0, 0, 5], np.int32)
    elif name == "t = 0 everywhere":
        t = np.zeros(3, np.int32)
    elif name == "t = max_new - 1":
        # max_new = G*P - bucket = 8: the last generated slot, 15.
        t = np.full(3, G * P - bucket - 1, np.int32)
    elif name == "page 3 does not divide bucket 8":
        P, G = 3, 4          # ceil((8 + 4) / 3) = 4 logical pages
        t = np.asarray([0, 3, 1], np.int32)
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    kp = rng.normal(size=(n_phys, H, P, dh)).astype(np.float32)
    vp = rng.normal(size=(n_phys, H, P, dh)).astype(np.float32)
    ptab = rng.integers(0, n_phys, (B, G)).astype(np.int32)
    if name == "idle slot on the garbage page":
        ptab[1] = 0          # an idle slot: every logical page is page 0
    if bf16:
        kp, vp = _bf16(kp), _bf16(vp)
    return q, kp, vp, ptab, lengths, t, bucket, P, bf16


CASES = ["test_pallas_attention inputs", "bf16 pool",
         "idle slot on the garbage page", "t = 0 everywhere",
         "t = max_new - 1", "page 3 does not divide bucket 8"]


def _jax_gather(q, kp, vp, ptab, lengths, t, bucket, page, scale):
    """The JAX serving step's read (continuous.py:442-454, 472-477)."""
    B, H, dh = q.shape
    G = ptab.shape[1]
    kf = jnp.take(jnp.asarray(kp), ptab, axis=0, mode="clip") \
        .transpose(0, 2, 1, 3, 4).reshape(B, H, G * page, dh)
    vf = jnp.take(jnp.asarray(vp), ptab, axis=0, mode="clip") \
        .transpose(0, 2, 1, 3, 4).reshape(B, H, G * page, dh)
    key_slot = jnp.arange(G * page)[None, :]
    mask = (key_slot < lengths[:, None]) | \
        ((key_slot >= bucket) & (key_slot <= (bucket + t)[:, None]))
    s = jnp.einsum("bhd,bhkd->bhk", q, kf) * scale
    probs = jax.nn.softmax(jnp.where(mask[:, None], s, -jnp.inf), axis=-1)
    return np.asarray(jnp.einsum("bhk,bhkd->bhd", probs, vf))


def _port(q, kp, vp, ptab, lengths, t, bucket, page, scale, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    args = [torch.as_tensor(q), torch.as_tensor(kp).to(dt),
            torch.as_tensor(vp).to(dt), torch.as_tensor(ptab),
            torch.as_tensor(lengths), torch.as_tensor(t)]
    before = attention.LAUNCHES["paged_decode_attn"]
    out = attention.paged_decode_attn(*args, bucket=bucket, page=page,
                                      scale=scale)
    assert attention.LAUNCHES["paged_decode_attn"] == before  # CPU: plain
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_kernel_and_gather(name):
    q, kp, vp, ptab, lengths, t, bucket, page, bf16 = _case(name)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    got = _port(q, kp, vp, ptab, lengths, t, bucket, page, scale, bf16)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    kernel = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kp).astype(dt),
        jnp.asarray(vp).astype(dt), jnp.asarray(ptab), jnp.asarray(lengths),
        jnp.asarray(t), bucket=bucket, page=page, scale=scale,
        interpret=True))
    gather = _jax_gather(q, kp, vp, ptab, lengths, t, bucket, page, scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, gather, rtol=RTOL, atol=ATOL)


def test_layer_view_of_a_pool_reads_that_layer():
    """The serving step passes ``pool.kp[:, i]``, a strided view of the
    5-D pool; the read is that layer's and no other's."""
    q, kp, vp, ptab, lengths, t, bucket, page, _ = _case(CASES[0])
    scale = 0.25
    rng = np.random.default_rng(5)
    pool_k = rng.normal(size=(kp.shape[0], 3) + kp.shape[1:]) \
        .astype(np.float32)
    pool_v = rng.normal(size=pool_k.shape).astype(np.float32)
    pool_k[:, 1], pool_v[:, 1] = kp, vp
    view_k = torch.as_tensor(pool_k)[:, 1]
    assert not view_k.is_contiguous()
    got = attention.paged_decode_attn(
        torch.as_tensor(q), view_k, torch.as_tensor(pool_v)[:, 1],
        torch.as_tensor(ptab), torch.as_tensor(lengths),
        torch.as_tensor(t), bucket=bucket, page=page, scale=scale).numpy()
    want = _jax_gather(q, kp, vp, ptab, lengths, t, bucket, page, scale)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_refusals():
    q, kp, vp, ptab, lengths, t, bucket, page, _ = _case(CASES[0])
    T = torch.as_tensor
    kw = dict(bucket=bucket, page=page, scale=0.25)
    args = [T(q), T(kp), T(vp), T(ptab), T(lengths), T(t)]
    with pytest.raises(NotImplementedError, match="ROADMAP B7"):
        attention.paged_decode_attn(
            args[0], T(kp).to(torch.int8), T(vp).to(torch.int8),
            *args[3:], **kw)
    with pytest.raises(ValueError, match="page=3"):
        attention.paged_decode_attn(*args, bucket=bucket, page=3,
                                    scale=0.25)
    with pytest.raises(ValueError, match="float32 q"):
        attention.paged_decode_attn(args[0].to(torch.bfloat16), *args[1:],
                                    **kw)
    with pytest.raises(ValueError, match="integer"):
        attention.paged_decode_attn(*args[:3], args[3].float(), *args[4:],
                                    **kw)
    with pytest.raises(ValueError, match="lengths, t"):
        attention.paged_decode_attn(*args[:4], args[4][:2], args[5], **kw)
    with pytest.raises(ValueError, match="q \\[B,H,dh\\]"):
        attention.paged_decode_attn(args[0], args[1], args[2][:, :2],
                                    *args[3:], **kw)


def test_kernel_matches_plain_on_card(card):
    """B7 against its plain version on the card, f32 and bf16 pools, a
    page that does not divide the bucket and an idle slot; every launch
    counted."""
    for name in CASES:
        q, kp, vp, ptab, lengths, t, bucket, page, bf16 = _case(name)
        dt = torch.bfloat16 if bf16 else torch.float32
        args = [torch.as_tensor(q).to(card),
                torch.as_tensor(kp).to(card, dt),
                torch.as_tensor(vp).to(card, dt),
                *(torch.as_tensor(x).to(card) for x in (ptab, lengths, t))]
        kw = dict(bucket=bucket, page=page, scale=0.35)
        before = attention.LAUNCHES["paged_decode_attn"]
        got = attention.paged_decode_attn(*args, **kw)
        assert attention.LAUNCHES["paged_decode_attn"] == before + 1
        want = attention.paged_decode_attn_plain(*args, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
