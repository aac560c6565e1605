"""Port parity of the paged KV host arithmetic and pool
(``multiverso_tpu_torch/serving/paged.py``, ``quant.py``) against the JAX
package's ``serving/paged.py``: the page plans come out identical over a
grid of (length, bucket, max_new, page), and the pool's refcounts,
exhaustion, growth and high-water mark mirror
``tests/test_serving_paged.py:45-87``."""

import dataclasses

import numpy as np
import pytest

import _torch_port
from multiverso_tpu.serving import paged as jax_paged

torch = paged = quant = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, paged, quant
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.serving import paged, quant


@pytest.fixture
def cpu():
    return torch.device("cpu")


GRID = [(length, bucket, max_new, page)
        for bucket in (4, 8, 16, 13)
        for max_new in (1, 4, 6)
        for page in (1, 3, 4, 16)
        for length in sorted({1, 2, bucket // 2 or 1, bucket - 1 or 1,
                              bucket})]


@pytest.mark.parametrize("bucket", [4, 8, 13, 16])
def test_page_plan_equals_jax(bucket):
    for length, b, max_new, page in GRID:
        if b != bucket:
            continue
        mine = paged.page_plan(length, b, max_new, page)
        want = jax_paged.page_plan(length, b, max_new, page)
        assert dataclasses.asdict(mine) == dataclasses.asdict(want), \
            (length, b, max_new, page)
        assert mine.n_backed == want.n_backed
        assert mine.straddle_has_prompt == want.straddle_has_prompt
    assert paged.pages_of(17, 4) == jax_paged.pages_of(17, 4) == 5


def test_page_plan_classification():
    """``test_serving_paged.py::test_page_plan_classification``."""
    p = paged.page_plan(3, 8, 8, 4)
    assert p.n_logical == 4 and p.n_prompt == 2
    assert p.shared == (0,) and p.pad == (1,) and p.private == (2, 3)
    assert p.straddle is None and p.n_backed == 3
    p = paged.page_plan(7, 8, 6, 3)
    assert p.straddle == 2 and p.straddle in p.private
    assert p.straddle_has_prompt
    p = paged.page_plan(2, 8, 6, 3)
    assert p.straddle == 2 and not p.straddle_has_prompt
    assert paged.page_plan(1, 64, 16, 16).n_backed \
        < paged.page_plan(60, 64, 16, 16).n_backed


def test_default_pool_pages_equals_jax():
    for args in (((8,), 3, 4, 4), ((128, 512), 8, 64, 16),
                 ((4, 8, 13), 2, 6, 3)):
        assert paged.default_pool_pages(*args) == \
            jax_paged.default_pool_pages(*args)


def test_page_pool_refcounts_and_exhaustion(cpu):
    """``test_serving_paged.py::test_page_pool_refcounts_and_exhaustion``,
    with the pool's tensors in the JAX layout."""
    pool = paged.PagePool(4, layers=1, heads=1, page=2, dh=2, device=cpu)
    assert pool.kp.shape == (5, 1, 1, 2, 2) and pool.kp.device == cpu
    assert pool.ks.shape == (5, 1, 1, 2, 1) and bool((pool.ks == 1).all())
    a = pool.alloc(3)
    assert a is not None and len(a) == 3 and paged.GARBAGE_PAGE not in a
    assert pool.alloc(2) is None          # exhausted: caller queues
    pool.incref(a)
    assert pool.decref(a) == 0            # still referenced
    assert pool.decref(a) == 3            # now free
    assert pool.free_pages() == 4
    assert pool.max_used == 3
    assert pool.alloc(0) == []


def test_page_pool_grows_keeping_pages_and_high_water(cpu):
    from multiverso_tpu_torch.telemetry import get_registry

    pool = paged.PagePool(2, layers=2, heads=3, page=4, dh=5,
                          kv_dtype="bf16", device=cpu)
    assert pool.kp.dtype == torch.bfloat16
    pages = pool.alloc(2)
    pool.kp[pages[0]] = 1.5
    pool.vp[pages[1]] = -2.0
    before = get_registry().counter("serve.kv.pool_grows").snapshot()
    pool.grow(5)
    assert pool.capacity == 5 and pool.kp.shape[0] == 6
    assert bool((pool.kp[pages[0]] == 1.5).all())
    assert bool((pool.vp[pages[1]] == -2.0).all())
    assert bool((pool.kp[3:] == 0).all()) and bool((pool.ks == 1).all())
    assert get_registry().counter("serve.kv.pool_grows").snapshot() \
        != before
    more = pool.alloc(3)
    assert sorted(more) == [3, 4, 5]
    assert pool.max_used == 5 and pool.used_pages() == 5
    pool.decref(pages + more)
    assert pool.used_pages() == 0 and pool.max_used == 5
    pool.grow(4)                          # never shrinks
    assert pool.capacity == 5
    assert pool.page_bytes() == 2 * 2 * 3 * 4 * 5 * 2


def test_int8_pool_raises(cpu):
    """An int8 pool (a refusal until int8 KV was ported): int8 payloads,
    float32 scale planes that growth carries (new pages' scales 1), and
    page bytes that count the scales."""
    pool = paged.PagePool(2, layers=1, heads=3, page=2, dh=4,
                          kv_dtype="int8", device=cpu)
    assert pool.kp.dtype == pool.vp.dtype == torch.int8
    assert pool.ks.dtype == torch.float32 and pool.ks.shape == (3, 1, 3, 2, 1)
    page = pool.alloc(1)[0]
    pool.kp[page] = 7
    pool.ks[page] = 0.5
    pool.grow(4)
    assert bool((pool.kp[page] == 7).all()) and \
        bool((pool.ks[page] == 0.5).all())
    assert bool((pool.ks[3:] == 1).all()) and bool((pool.kp[3:] == 0).all())
    assert pool.page_bytes() == 2 * (1 * 3 * 2 * 4 * 1 + 1 * 3 * 2 * 4)


def test_storage_codecs():
    x = torch.randn(3, 4, 8)
    payload, scale = quant.encode_rows(x, "f32")
    assert payload is x                          # identity codec
    assert quant.decode_rows(payload, scale, "f32") is x
    assert scale.shape == (3, 4, 1) and bool((scale == 1).all())
    payload, scale = quant.encode_rows(x, "bf16")
    assert payload.dtype == torch.bfloat16
    back = quant.decode_rows(payload, scale, "bf16")
    assert float((back - x).abs().max()) <= float(x.abs().max()) * 2 ** -8
    assert quant.storage_dtype(" BF16 ") == "bf16"
    assert quant.storage_dtype("") == "f32"
    assert quant.torch_dtype("bf16") == torch.bfloat16
    assert quant.bytes_per_element("int8") == 1.0
    assert quant.has_scale("int8") and not quant.has_scale("bf16")
    assert quant.STORAGE_DTYPES == ("f32", "bf16", "int8")
    payload, scale = quant.encode_rows(x, "int8")
    assert payload.dtype == torch.int8 and scale.shape == (3, 4, 1)
    back = quant.decode_rows(payload, scale, "int8")
    assert float((back - x).abs().max()) <= \
        quant.roundtrip_bound(x.numpy(), "int8") * (1 + 1e-6)
    from multiverso_tpu_torch.utils.log import FatalError
    with pytest.raises(FatalError):
        quant.storage_dtype("fp4")
