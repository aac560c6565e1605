"""Port parity: the sg-ns block step's plain version (the B5 oracle)
against the JAX package's ``build_sgns_grid_step`` in interpret mode.

Both sides get the same numpy tables and streams: several chunks with a
masked tail, AdaGrad and SGD. Tolerance: tables ``rtol=1e-5, atol=1e-6``
and the loss ``rtol=1e-5`` — the two frameworks implement sigmoid, log
and sqrt separately and sum the dot products (``einsum`` in JAX, an
elementwise product and ``sum`` here) in different orders; everything
else is the same op sequence. The CUDA kernel is held against this plain
version on the card by ``chip_smoke.py``. bfloat16 embedding tables (the
JAX function's other dtype) go through both as well, with the tolerance
stated in their test.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import _torch_port
from multiverso_tpu.ops.pallas_sgns import \
    build_sgns_grid_step as jax_grid_step

torch = sgns = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, sgns
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import sgns


V, D, C, K, N = 64, 16, 8, 3, 4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(V, D)).astype(np.float32),
              (0.5 * rng.normal(size=(V, D))).astype(np.float32),
              np.zeros((V, D), np.float32), np.zeros((V, D), np.float32)]
    streams = [rng.integers(0, V, (N, C)).astype(np.int32),
               rng.integers(0, V, (N, C)).astype(np.int32),
               rng.integers(0, V, (N, C, K)).astype(np.int32)]
    return tables, streams


def _jax(tables, streams, n_pairs, lr, adagrad, bf16=False):
    step = jax_grid_step(chunk=C, negative=K, adagrad=adagrad, interpret=True)
    emb = jnp.bfloat16 if bf16 else jnp.float32
    out = step(*[jnp.asarray(t.copy(), emb if i < 2 else jnp.float32)
                 for i, t in enumerate(tables)],
               *[jnp.asarray(s) for s in streams], jnp.int32(n_pairs),
               jnp.float32(lr))
    return [np.asarray(t).astype(np.float32) for t in out[:4]], \
        float(out[4])


def _port(tables, streams, n_pairs, lr, adagrad, bf16=False):
    step = sgns.build_sgns_grid_step(chunk=C, negative=K, adagrad=adagrad)
    emb = torch.bfloat16 if bf16 else torch.float32
    out = step(*[torch.as_tensor(t.copy()).to(emb if i < 2 else
                                              torch.float32)
                 for i, t in enumerate(tables)],
               *[torch.as_tensor(s) for s in streams],
               torch.tensor(n_pairs, dtype=torch.int32), np.float32(lr))
    assert out[0].dtype == out[1].dtype == emb
    return [t.float().numpy() for t in out[:4]], float(out[4])


@pytest.mark.parametrize("adagrad", [True, False])
def test_plain_block_matches_jax_grid_step(adagrad):
    tables, streams = _inputs()
    n_pairs = N * C - 5                         # masked tail chunk
    want, want_loss = _jax(tables, streams, n_pairs, 0.05, adagrad)
    got, got_loss = _port(tables, streams, n_pairs, 0.05, adagrad)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert np.isfinite(got_loss)
    assert not np.array_equal(got[0], tables[0])    # it trained
    assert sgns.LAUNCHES["sgns_block"] == 0          # CPU: plain version


@pytest.mark.parametrize("adagrad", [True, False])
def test_plain_block_bfloat16_matches_jax_grid_step(adagrad):
    """bfloat16 w_in/w_out (float32 AdaGrad sums and math), as the JAX
    package's ``test_grid_step_bfloat16_tables``. Both round each step to
    bfloat16 and fold duplicate rows in lane order with a rounding after
    every add, but their float32 dot products sum in different orders, so
    a step on a bfloat16 rounding edge may round the other way: each
    embedding element must be within one bfloat16 ulp of JAX's (2^-7 of
    its magnitude, at least 2^-7 * 2^-10), the AdaGrad sums within
    ``rtol=1e-5, atol=1e-6`` and the loss within ``rtol=1e-5``."""
    tables, streams = _inputs(seed=3)
    tables[0] *= 0.1
    n_pairs = N * C - 5
    want, want_loss = _jax(tables, streams, n_pairs, 0.05, adagrad, True)
    got, got_loss = _port(tables, streams, n_pairs, 0.05, adagrad, True)
    for i, (w, g) in enumerate(zip(want, got)):
        if i < 2:
            assert not np.array_equal(g, torch.as_tensor(
                tables[i]).bfloat16().float().numpy())   # it trained
            ulp = np.maximum(np.abs(w), 2.0 ** -10) * 2.0 ** -7
            assert (np.abs(w - g) <= ulp).all(), i
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


def test_dead_chunks_are_noops():
    tables, streams = _inputs(2)
    one, loss_one = _port(tables, streams, C, 0.1, True)        # 1 live chunk
    ref, loss_ref = _port(tables, [s[:1] for s in streams], C, 0.1, True)
    for a, b in zip(one, ref):
        assert np.array_equal(a, b)
    assert loss_one == loss_ref
    zero, loss_zero = _port(tables, streams, 0, 0.1, True)
    for a, b in zip(zero, tables):
        assert np.array_equal(a, b)
    assert loss_zero == 0.0
    want, want_loss = _jax(tables, streams, C, 0.1, True)
    for w, g in zip(want, one):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss_one, want_loss, rtol=1e-5)


def test_step_updates_tables_in_place():
    tables, streams = _inputs(3)
    t = [torch.as_tensor(x.copy()) for x in tables]
    step = sgns.build_sgns_grid_step(chunk=C, negative=K, adagrad=True)
    out = step(*t, *[torch.as_tensor(s) for s in streams],
               torch.tensor(N * C), np.float32(0.05))
    assert all(a is b for a, b in zip(out[:4], t))
    with pytest.raises(ValueError):
        sgns.build_sgns_grid_step(chunk=C + 1, negative=K, adagrad=True)(
            *t, *[torch.as_tensor(s) for s in streams], torch.tensor(1),
            np.float32(0.05))


class _Card:
    total_memory = 80 * 2**30


@pytest.fixture
def card(monkeypatch):
    """A CUDA device with an 80 GiB memory, as the eligibility rule reads
    it (no card is touched)."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: _Card)
    return torch.device("cuda", 0)


def test_eligibility_reckons_device_memory(card):
    """Unlike the TPU's VMEM rule, the flagship's 50K vocab is eligible on
    one H100; 16-bit tables, more than 16 negatives, a working set beyond
    the device's memory and a CPU device are not."""
    assert sgns.sgns_grid_eligible(50_000, 50_000, 128, 8192, 5, np.float32,
                                   card)
    assert sgns.sgns_grid_bytes(50_000, 50_000, 128, 8192, 5,
                                np.float32) < 2**28
    # The gradient scratch: grad_u and the snapshot of u, [C, D] each, and
    # one coefficient per out-lane (C * (1 + K)), in float32.
    tables = 2 * 50_000 * 128 * 8
    streams = 8192 * 7 * 4 * 3
    assert sgns.sgns_grid_bytes(50_000, 50_000, 128, 8192, 5, np.float32) \
        == tables + (2 * 8192 * 128 + 8192 * 6) * 4 + streams
    assert not sgns.sgns_grid_eligible(50_000, 50_000, 128, 8192, 5,
                                       np.dtype("float16"), card)
    assert not sgns.sgns_grid_eligible(1000, 1000, 128, 8192, 17, np.float32,
                                       card)
    assert not sgns.sgns_grid_eligible(10**8, 10**8, 128, 8192, 5,
                                       np.float32, card)
    assert not sgns.sgns_grid_eligible(1000, 1000, 128, 8192, 5, np.float32,
                                       torch.device("cpu"))


def test_glue_sorts_every_chunk_and_drops_dead_lanes():
    """The glue before the launch sorts each LIVE chunk's ids stably, with
    the lanes past n_pairs keyed out of range; the dead chunks, which the
    kernel never reads, are not sorted (one host read of n_pairs)."""
    _, (centers, contexts, negatives) = _inputs(5)
    dead = np.iinfo(np.int32).max
    for n_pairs, n_live in ((C + 3, 2), (2 * C, 2), (0, 0), (N * C, N)):
        got = sgns.sorted_row_ids(
            *[torch.as_tensor(x) for x in (centers, contexts, negatives)],
            torch.tensor([n_pairs], dtype=torch.int32))
        assert got[0] == n_live
        in_ids, in_perm, out_ids, out_perm = got[1:]
        assert in_ids.shape == (n_live, C)
        assert out_ids.shape == (n_live, C * (1 + K))
        live = (np.arange(n_live * C).reshape(n_live, C) < n_pairs)
        keys_in = np.where(live, centers[:n_live], dead)
        keys_out = np.concatenate(
            [np.where(live, contexts[:n_live], dead),
             np.where(live[:, :, None], negatives[:n_live],
                      dead).reshape(n_live, C * K)], 1)
        for keys, ids, perm in ((keys_in, in_ids, in_perm),
                                (keys_out, out_ids, out_perm)):
            order = np.argsort(keys, axis=1, kind="stable")
            assert np.array_equal(perm.numpy(), order)
            assert np.array_equal(ids.numpy(),
                                  np.take_along_axis(keys, order, 1))
    assert sgns.long_run_capacity(8192, 5) == \
        8192 // sgns.LONG_RUN + 8192 * 6 // sgns.LONG_RUN
