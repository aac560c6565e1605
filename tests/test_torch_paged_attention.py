"""Port parity: B7's plain version (``paged_decode_attn_plain``, the
kernel's oracle and the CPU's read) against the JAX package's
``paged_decode_attn`` in interpret mode and against the JAX serving
step's gather formulation, on the same numpy inputs.

Tolerance: ``rtol=2e-5, atol=2e-6``, the JAX package's own
(``tests/test_pallas_attention.py:163-199``): the TPU kernel sums page by
page with an online softmax, the gather formulation in one pass. The CUDA
kernel is held against the plain version on the card by the card-only
tests below and by ``chip_smoke.py``. The kernel reads only the pages
that the mask admits a key of (``paged_live_pages``) and splits a slot's
pages over several CTAs; the cases below put page boundaries, G = 1 and
a long table under both.
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
    """``x`` rounded to bfloat16 values (to nearest even, as JAX rounds),
    kept as float32 numpy."""
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


def _case(name):
    """Inputs of one case: (q, kp, vp, ptab, lengths, t, bucket, page,
    bf16). The first is ``test_pallas_attention.py:163-199``'s."""
    rng = np.random.default_rng(0)
    H, dh, P, G, bucket, n_phys = 4, 8, 4, 4, 8, 16
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
    elif name == "lengths at a page boundary and one past":
        lengths = np.asarray([4, 5, 8], np.int32)     # P, P + 1, 2P
        t = np.asarray([0, 1, 2], np.int32)
    elif name == "bucket + t crosses a page boundary":
        t = np.asarray([3, 4, 5], np.int32)   # 11 ends page 2, 12 starts 3
    elif name == "G = 1":
        G, bucket = 1, 2                      # max_new 2: positions 2, 3
        lengths = np.asarray([1, 2, 0], np.int32)
        t = np.asarray([0, 1, 1], np.int32)
    elif name == "long table, one short and one full slot":
        G, bucket, n_phys = 64, 240, 130      # max_new 16
        lengths = np.asarray([5, 240], np.int32)
        t = np.asarray([3, 15], np.int32)
    elif name == "only the generated page is live":
        lengths = np.asarray([0, 3, 7], np.int32)
        t = np.asarray([2, 0, 5], np.int32)
    B = len(lengths)
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
         "t = max_new - 1", "page 3 does not divide bucket 8",
         "lengths at a page boundary and one past",
         "bucket + t crosses a page boundary", "G = 1",
         "long table, one short and one full slot",
         "only the generated page is live"]


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
    k8, v8 = T(kp).to(torch.int8), T(vp).to(torch.int8)
    with pytest.raises(ValueError, match="scale planes"):
        attention.paged_decode_attn(args[0], k8, v8, *args[3:], **kw)
    ones = torch.ones(kp.shape[:3] + (1,))
    with pytest.raises(ValueError, match="scales ks, vs"):
        attention.paged_decode_attn(args[0], k8, v8, *args[3:], **kw,
                                    ks=ones[:, :1], vs=ones)
    with pytest.raises(ValueError, match="scales ks, vs"):
        attention.paged_decode_attn(args[0], k8, v8, *args[3:], **kw,
                                    ks=ones.double(), vs=ones)
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


def test_int8_kernel_matches_plain_on_card(card):
    """B7's int8 instance against its plain version on the card: every
    case's pool encoded by the serving codec, read through its scale
    planes; every launch counted as an int8 one."""
    from multiverso_tpu_torch.serving.quant import encode_rows
    for name in CASES:
        q, kp, vp, ptab, lengths, t, bucket, page, _ = _case(name)
        (k8, ks), (v8, vs) = (encode_rows(torch.as_tensor(x).to(card),
                                          "int8") for x in (kp, vp))
        args = [torch.as_tensor(q).to(card), k8, v8,
                *(torch.as_tensor(x).to(card) for x in (ptab, lengths, t))]
        kw = dict(bucket=bucket, page=page, scale=0.35, ks=ks, vs=vs)
        before = dict(attention.LAUNCHES)
        got = attention.paged_decode_attn(*args, **kw)
        assert attention.LAUNCHES["paged_decode_attn_int8"] == \
            before["paged_decode_attn_int8"] + 1
        assert attention.LAUNCHES["paged_decode_attn"] == \
            before["paged_decode_attn"]
        want = attention.paged_decode_attn_plain(*args, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _admitted(lengths, t, bucket, page, G):
    """[B, G*P] bool: the positions the serving mask admits."""
    pos = np.arange(G * page)[None, :]
    return (pos < lengths[:, None]) | ((pos >= bucket)
                                       & (pos <= (bucket + t)[:, None]))


def _unique_pages(q, kp, vp, ptab, lengths, t, bucket, page, poison=None):
    """The case's logical cache laid out with one physical page per (slot,
    logical page), page ``1 + b*G + j`` (page 0 unused): the same keys and
    values, so the same attention. With ``poison``, every page that the
    kernel skips (``paged_live_pages`` false) is filled with it."""
    B, G = ptab.shape
    src = np.clip(ptab, 0, kp.shape[0] - 1).reshape(-1)
    kp2 = np.concatenate([np.zeros_like(kp[:1]), kp[src]])
    vp2 = np.concatenate([np.zeros_like(vp[:1]), vp[src]])
    ptab2 = (1 + np.arange(B * G, dtype=np.int32)).reshape(B, G)
    if poison is not None:
        live = attention.paged_live_pages(
            torch.as_tensor(lengths), torch.as_tensor(t), bucket=bucket,
            page=page, n_pages=G).numpy()
        dead = ptab2[~live]
        kp2[dead] = poison(kp2[dead].shape)
        vp2[dead] = poison(vp2[dead].shape)
    return q, kp2, vp2, ptab2, lengths, t


@pytest.mark.parametrize("name", CASES)
def test_live_pages_are_the_pages_with_an_admitted_key(name):
    """``paged_live_pages`` (the kernel's page rule) marks exactly the
    pages holding an admitted position; every case admits one."""
    _, _, _, ptab, lengths, t, bucket, page, _ = _case(name)
    G = ptab.shape[1]
    admitted = _admitted(lengths, t, bucket, page, G)
    assert admitted.any(axis=1).all()
    live = attention.paged_live_pages(
        torch.as_tensor(lengths), torch.as_tensor(t), bucket=bucket,
        page=page, n_pages=G).numpy()
    np.testing.assert_array_equal(
        live, admitted.reshape(len(lengths), G, page).any(axis=2))


def test_live_pages_of_a_slot_that_admits_no_key_are_all_pages():
    """With no admitted key (a negative t and no prompt) the kernel reads
    every page, as the kernel that read every page did."""
    live = attention.paged_live_pages(
        torch.tensor([0, 5]), torch.tensor([-1, -1]), bucket=8, page=4,
        n_pages=4).numpy()
    np.testing.assert_array_equal(live, [[True] * 4,
                                         [True, True, False, False]])


@pytest.mark.parametrize("name", CASES)
def test_plain_ignores_wholly_masked_pages(name):
    """The skip's premise: the pages that hold no admitted key add
    exactly nothing. The plain version on pages whose skipped pages hold
    large random values equals it on the clean pages, bitwise."""
    q, kp, vp, ptab, lengths, t, bucket, page, bf16 = _case(name)
    rng = np.random.default_rng(3)
    clean = _unique_pages(q, kp, vp, ptab, lengths, t, bucket, page)
    dirty = _unique_pages(
        q, kp, vp, ptab, lengths, t, bucket, page,
        poison=lambda shape: (1e4 * rng.normal(size=shape)).astype(
            np.float32))
    want = _port(*clean, bucket, page, 0.35, bf16)
    got = _port(*dirty, bucket, page, 0.35, bf16)
    np.testing.assert_allclose(
        want, _jax_gather(q, kp, vp, ptab, lengths, t, bucket, page, 0.35),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, want)


def _on_card(card, q, kp, vp, ptab, lengths, t, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    return [torch.as_tensor(q).to(card), torch.as_tensor(kp).to(card, dt),
            torch.as_tensor(vp).to(card, dt),
            *(torch.as_tensor(x).to(card) for x in (ptab, lengths, t))]


def test_kernel_skips_wholly_masked_pages_on_card(card):
    """NaN in every page the mask wholly excludes: the kernel never reads
    them, so it equals the plain version on the clean pages."""
    for name in CASES:
        q, kp, vp, ptab, lengths, t, bucket, page, bf16 = _case(name)
        clean = _unique_pages(q, kp, vp, ptab, lengths, t, bucket, page)
        nan = _unique_pages(q, kp, vp, ptab, lengths, t, bucket, page,
                            poison=lambda shape: np.full(shape, np.nan,
                                                         np.float32))
        kw = dict(bucket=bucket, page=page, scale=0.35)
        got = attention.paged_decode_attn(*_on_card(card, *nan, bf16), **kw)
        want = attention.paged_decode_attn_plain(
            *_on_card(card, *clean, bf16), **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_kernel_with_one_cta_per_slot_head_on_card(card, monkeypatch):
    """The kernel with its slots unsplit (the shape where B x H fills the
    card) against the plain version on every case."""
    monkeypatch.setattr(attention, "paged_splits", lambda bh, g, sms: 1)
    for name in CASES:
        q, kp, vp, ptab, lengths, t, bucket, page, bf16 = _case(name)
        args = _on_card(card, q, kp, vp, ptab, lengths, t, bf16)
        kw = dict(bucket=bucket, page=page, scale=0.35)
        got = attention.paged_decode_attn(*args, **kw)
        want = attention.paged_decode_attn_plain(*args, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_kernel_is_bitwise_repeatable_and_graph_equal_on_card(card):
    """Two launches give the same bits, and a launch replayed from a CUDA
    graph gives the bits of an eager launch (the partials merge in split
    order; the ticket counters reset themselves)."""
    for name in ("test_pallas_attention inputs",
                 "long table, one short and one full slot", "bf16 pool"):
        q, kp, vp, ptab, lengths, t, bucket, page, bf16 = _case(name)
        args = _on_card(card, q, kp, vp, ptab, lengths, t, bf16)
        kw = dict(bucket=bucket, page=page, scale=0.35)
        first = attention.paged_decode_attn(*args, **kw)
        second = attention.paged_decode_attn(*args, **kw)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            attention.paged_decode_attn(*args, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = attention.paged_decode_attn(*args, **kw)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, second), name
        assert torch.equal(captured, first), name
