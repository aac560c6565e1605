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
a long table under both. Heads of 264 and 320 columns (B7's wide
instances on a card) are held the same way, in float32 and bfloat16,
and int8 pages against the JAX codec's ``decode_rows`` after the gather.
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


def _case(name, dh=8):
    """Inputs of one case: (q, kp, vp, ptab, lengths, t, bucket, page,
    bf16). The first is ``test_pallas_attention.py:163-199``'s; ``dh``
    widens its heads."""
    rng = np.random.default_rng(0)
    H, P, G, bucket, n_phys = 4, 4, 4, 8, 16
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
    _hold_against_jax(*_case(name))


def _hold_against_jax(q, kp, vp, ptab, lengths, t, bucket, page, bf16):
    """The port's read (the plain version on the CPU) against the JAX
    kernel in interpret mode and the JAX gather."""
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


#: Cases held at wide heads: the JAX test's inputs, a generated position
#: on the next page, and a long table with a short and a full slot.
WIDE_CASES = ["test_pallas_attention inputs",
              "bucket + t crosses a page boundary",
              "long table, one short and one full slot"]


@pytest.mark.parametrize("dh", [264, 320])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", WIDE_CASES)
def test_wide_heads_plain_matches_jax_kernel_and_gather(name, bf16, dh):
    """Heads of 264 and 320 columns (B7's wide instances on a card):
    the plain version against the JAX kernel and gather."""
    q, kp, vp, ptab, lengths, t, bucket, page, _ = _case(name, dh=dh)
    if bf16:
        kp, vp = _bf16(kp), _bf16(vp)
    _hold_against_jax(q, kp, vp, ptab, lengths, t, bucket, page, bf16)


def _int8_pools(kp, vp):
    """``kp``, ``vp`` through the JAX codec: (k8, ks, v8, vs) as numpy,
    and the JAX ``decode_rows`` of each pool."""
    from multiverso_tpu.serving import quant as jquant
    (k8, ks), (v8, vs) = (jquant.encode_rows(jnp.asarray(x), "int8")
                          for x in (kp, vp))
    decoded = [np.asarray(jquant.decode_rows(p, s, "int8"))
               for p, s in ((k8, ks), (v8, vs))]
    return [np.array(x) for x in (k8, ks, v8, vs)], decoded


@pytest.mark.parametrize("dh", [264, 320, 384])
@pytest.mark.parametrize("name", WIDE_CASES)
def test_wide_heads_int8_plain_matches_jax_decode_rows(name, dh):
    """int8 pages at wide heads (dh 264: rows not whole 16-byte vectors,
    the narrow-row instance on a card): the plain read with the scale
    planes against the JAX gather of ``decode_rows``'s rows."""
    q, kp, vp, ptab, lengths, t, bucket, page, _ = _case(name, dh=dh)
    (k8, ks, v8, vs), (kd, vd) = _int8_pools(kp, vp)
    scale = float(1.0 / np.sqrt(dh))
    T = torch.as_tensor
    before = dict(attention.LAUNCHES)
    got = attention.paged_decode_attn(
        T(q), T(k8), T(v8), T(ptab), T(lengths), T(t), bucket=bucket,
        page=page, scale=scale, ks=T(ks), vs=T(vs)).numpy()
    assert attention.LAUNCHES == before                        # CPU: plain
    want = _jax_gather(q, kd, vd, ptab, lengths, t, bucket, page, scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


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


@pytest.mark.parametrize("dh, dtype, page, want", [
    (64, "float32", 16, 1), (64, "bfloat16", 16, 2), (64, "int8", 16, 4),
    (128, "int8", 16, 2), (256, "int8", 16, 1), (256, "bfloat16", 16, 1),
    (64, "int8", 3, 21), (8, "int8", 16, 16), (64, "bfloat16", 1, 32),
    (8, "float32", 1, 1)])
def test_tile_pages_fill_the_tile_bytes(dh, dtype, page, want):
    """The whole pages one B7 tile holds: for rows narrower than
    float32's as many as fit 4 KB of K rows (an int8 tile at most 256
    rows, its scales' room), at least one; a float32 tile one page. At
    the serving shape (dh 64, page 16) float32 is one page a tile,
    bfloat16 two and int8 four."""
    elem = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    tp = attention.paged_tile_pages(dh, elem, page)
    assert tp == want
    if elem == 4 or tp == 1:
        return
    assert tp * page * dh * elem <= attention.PAGED_TILE_BYTES
    assert (tp + 1) * page * dh * elem > attention.PAGED_TILE_BYTES or \
        (elem == 1 and (tp + 1) * page > attention.PAGED_MAX_SCALE_ROWS)


@pytest.mark.parametrize("n_live, tile_pages, splits", [
    (33, 4, 6), (5, 4, 6), (132, 4, 6), (9, 4, 2), (36, 1, 6), (1, 4, 6),
    (8, 2, 3), (40, 21, 2)])
def test_split_pages_hold_whole_tiles(n_live, tile_pages, splits):
    """The kernel's split of a slot's live pages: the CTAs take them in
    order, each from a tile boundary, and none takes part of a tile that
    another takes (only the slot's last tile may be short)."""
    spans = attention.paged_split_pages(n_live, tile_pages, splits)
    assert len(spans) == splits
    assert spans[0][0] == 0 and spans[-1][1] == n_live
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    for p0, p1 in spans:
        assert p0 <= p1
        assert p0 % tile_pages == 0
        assert (p1 - p0) % tile_pages == 0 or p1 == n_live
    units = [-(-(p1 - p0) // tile_pages) for p0, p1 in spans]
    assert max(units) - min(units) <= 1


def test_launch_splits_count_tiles():
    """The splits a launch takes: tiles of the table, not pages, for heads
    up to 512 (int8 at the serving shape: 36 pages are 9 tiles of 4, still
    6 CTAs a slot and head on 132 SMs; a 16-page table's 4 tiles cap them
    at 4; int8 at dh 320, tiles of 2 pages, 8 tiles cap nothing), pages
    of every column chunk for the column-chunked instance past 512, one
    CTA where B x H fills the card."""
    q = torch.zeros(8, 12, 64)
    i8 = torch.zeros(1, dtype=torch.int8)
    f32 = torch.zeros(1)
    assert attention.paged_launch_splits(q, i8, 36, 16, 132) == 6
    assert attention.paged_launch_splits(q, i8, 16, 16, 132) == 4
    assert attention.paged_launch_splits(q, f32, 16, 16, 132) == 6
    assert attention.paged_launch_splits(torch.zeros(8, 12, 320), i8, 16,
                                         16, 132) == 6
    assert attention.paged_launch_splits(torch.zeros(8, 12, 320), i8, 4,
                                         16, 132) == 2
    assert attention.paged_launch_splits(torch.zeros(8, 12, 520), i8, 16,
                                         16, 132) == 2
    assert attention.paged_launch_splits(torch.zeros(64, 12, 64), i8, 36,
                                         16, 132) == 1


@pytest.mark.parametrize("dh, dtype, page, tile_pages, chunks", [
    (264, "float32", 16, 1, 1), (320, "float32", 16, 1, 1),
    (512, "float32", 4, 1, 1), (320, "float32", 4, 2, 1),
    (320, "bfloat16", 16, 1, 1), (384, "bfloat16", 16, 1, 1),
    (264, "int8", 16, 2, 1), (320, "int8", 16, 2, 1), (384, "int8", 16, 1, 1),
    (512, "int8", 16, 1, 1), (320, "int8", 1, 32, 1), (320, "bfloat16", 2, 8, 1),
    (520, "float32", 16, 1, 3), (520, "int8", 16, 1, 3),
    (1024, "bfloat16", 16, 1, 4)])
def test_wide_layout_tiles_and_scratch(dh, dtype, page, tile_pages, chunks):
    """The wide instances' layout (heads of 257-512): tiles of up to 12 KB
    (float32) or 10 KB (bfloat16, int8) of K rows, whole pages where they
    fit, no column chunks, so a split's merge scratch is dh + 2 floats;
    past 512 the column-chunked instance, a page a unit and ceil(dh / 256)
    chunks, each with its own (m, l)."""
    elem = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    tp = attention.paged_tile_pages(dh, elem, page)
    assert tp == tile_pages
    assert attention.paged_chunks(dh) == chunks
    if dh <= attention.PAGED_MAX_WIDE_DIM:
        budget = attention.PAGED_WIDE_TILE_BYTES[elem]
        assert tp * page * dh * elem <= budget or tp == 1
        assert (tp + 1) * page * dh * elem > budget
    q = torch.zeros(8, 12, dh)
    kp = torch.zeros(1, dtype=getattr(torch, dtype))
    splits = attention.paged_launch_splits(q, kp, 36, page, 132)
    assert splits == attention.paged_splits(8 * 12 * chunks,
                                            -(-36 // tp), 132)


@pytest.mark.parametrize("dh, vec, want", [
    (64, True, "tiled"), (256, False, "tiled"),
    (264, True, "wide d<=512 vec"), (320, True, "wide d<=512 vec"),
    (512, True, "wide d<=512 vec"), (264, False, "wide d<=512 narrow-row"),
    (258, False, "wide d<=512 narrow-row"),
    (512, False, "wide d<=512 narrow-row"), (520, True, "wide d>512")])
def test_instance_names_follow_the_rows(dh, vec, want):
    """The names of the instances, in the order of the indices the
    kernel's entry point reports: the tiled ones up to 256, the wide ones
    up to 512 (by 16-byte vectors where the rows are whole vectors on
    16-byte boundaries, else one value a lane), then the column-chunked
    one."""
    assert attention.b7_instance(dh, vec) == want
    assert attention.B7_INSTANCE_NAMES.index(want) == (
        0 if dh <= 256 else 3 if dh > 512 else 1 if vec else 2)


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


def _wide_on_card(card, name, dh, dtype, poison=False):
    """A wide-head case on the card as the wrapper takes it: (args,
    kwargs); int8 pools encoded by the serving codec. With ``poison``,
    one physical page per (slot, logical page) and every page the kernel
    skips filled with NaN (int8: payloads of 127 and NaN scales)."""
    from multiverso_tpu_torch.serving.quant import encode_rows
    q, kp, vp, ptab, lengths, t, bucket, page, _ = _case(name, dh=dh)
    if poison:
        nan = _unique_pages(q, kp, vp, ptab, lengths, t, bucket, page,
                            poison=lambda shape: np.full(shape, np.nan,
                                                         np.float32))
        q, kp, vp, ptab, lengths, t = nan
    kw = dict(bucket=bucket, page=page, scale=float(dh) ** -0.5)
    kp_t, vp_t = (torch.as_tensor(x).to(card) for x in (kp, vp))
    if dtype == "int8":
        bad = torch.isnan(kp_t).all(dim=-1, keepdim=True)
        (kp_t, ks), (vp_t, vs) = (encode_rows(torch.nan_to_num(x), "int8")
                                  for x in (kp_t, vp_t))
        for x in (kp_t, vp_t):
            x.masked_fill_(bad, 127)
        for x in (ks, vs):
            x.masked_fill_(bad, float("nan"))
        kw.update(ks=ks, vs=vs)
    else:
        kp_t, vp_t = kp_t.to(getattr(torch, dtype)), vp_t.to(
            getattr(torch, dtype))
    args = [torch.as_tensor(q).to(card), kp_t, vp_t,
            *(torch.as_tensor(x).to(card) for x in (ptab, lengths, t))]
    return args, kw


@pytest.mark.parametrize("dh", [264, 320, 384, 512, 520])
def test_wide_kernel_matches_plain_on_card(card, dh):
    """B7's wide instances (and the column-chunked one at 520) against
    the plain version on the card, float32, bfloat16 and int8 pages: each
    launch counted under its instance, NaN in the pages the mask wholly
    excludes changes nothing, two launches are bitwise equal and a graph
    replay equals an eager launch."""
    for dtype in ("float32", "bfloat16", "int8"):
        for name in WIDE_CASES:
            args, kw = _wide_on_card(card, name, dh, dtype)
            # Fresh pools lie on 16-byte boundaries: only int8 rows of 264
            # are not whole 16-byte vectors.
            elem = args[1].element_size()
            inst = attention.b7_instance(dh, dh * elem % 16 == 0)
            before = dict(attention.B7_INSTANCES)
            got = attention.paged_decode_attn(*args, **kw)
            before[inst] += 1
            assert attention.B7_INSTANCES == before, (dh, dtype, inst)
            want = attention.paged_decode_attn_plain(*args, **kw)
            nan_args, nan_kw = _wide_on_card(card, name, dh, dtype,
                                             poison=True)
            nan_got = attention.paged_decode_attn(*nan_args, **nan_kw)
            first = attention.paged_decode_attn(*args, **kw)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = attention.paged_decode_attn(*args, **kw)
            graph.replay()
            torch.cuda.synchronize()
            what = f"{name}, dh {dh}, {dtype}"
            for x in (got, nan_got):
                np.testing.assert_allclose(
                    x.cpu().numpy(), want.cpu().numpy(), rtol=RTOL,
                    atol=ATOL, err_msg=what)
            assert torch.equal(first, got), what
            assert torch.equal(captured, got), what


@pytest.mark.parametrize("dh", [320, 384])
def test_wide_kernel_off_a_16_byte_boundary_on_card(card, dh):
    """A float32 pool one element off its 16-byte boundary: the entry
    point reports the narrow-row wide instance, which holds the plain
    version."""
    args, kw = _wide_on_card(card, WIDE_CASES[0], dh, "float32")
    for i in (1, 2):
        flat = torch.empty(args[i].numel() + 1, device=card)
        args[i] = flat[1:].view(args[i].shape).copy_(args[i])
    before = dict(attention.B7_INSTANCES)
    got = attention.paged_decode_attn(*args, **kw)
    before["wide d<=512 narrow-row"] += 1
    assert attention.B7_INSTANCES == before
    want = attention.paged_decode_attn_plain(*args, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dh", [264, 320, 384, 512, 520])
def test_wide_kernel_with_one_cta_per_slot_head_on_card(card, monkeypatch,
                                                        dh):
    """The wide instances with their slots unsplit."""
    monkeypatch.setattr(attention, "paged_splits", lambda bh, g, sms: 1)
    for dtype in ("float32", "int8"):
        for name in WIDE_CASES:
            args, kw = _wide_on_card(card, name, dh, dtype)
            got = attention.paged_decode_attn(*args, **kw)
            want = attention.paged_decode_attn_plain(*args, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}, {dh}, {dtype}")
