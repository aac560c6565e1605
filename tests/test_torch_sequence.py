"""Port parity: ring and Ulysses attention at one rank against the JAX
package's ``shard_map`` programs.

The same numpy q, k, v (S = 512, so that the JAX side's 128-row blocks on a
4-device ``"seq"`` mesh pass its flash kernel's gate) go through the port
at one rank and through the JAX functions on a 1-device mesh and on a
4-device mesh, causal and not, with ``-flash_attention`` off (the plain
block step) and on (B6; interpret mode on the JAX side). Both sides compute
the exact softmax, so they agree within float32 rounding of differently
ordered sums: ``rtol=2e-5, atol=2e-6``, the JAX flash tests' tolerance.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_port
from multiverso_tpu.parallel import sequence as jax_seq
from multiverso_tpu.utils.configure import set_flag as jax_set_flag

torch = seq = attention = port_flags = None  # set by _load_port

B, H, S, D = 1, 4, 512, 32


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, seq, attention, port_flags
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.ops import attention
    from multiverso_tpu_torch.parallel import sequence as seq
    from multiverso_tpu_torch.utils import configure as port_flags


@pytest.fixture
def flash_flag():
    """Sets ``-flash_attention`` in both packages; both reset after."""
    def set_both(on):
        jax_set_flag("flash_attention", on)
        port_flags.set_flag("flash_attention", on)
    yield set_both
    port_flags.reset_flags()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_one_rank_matches_jax_on_1_and_4_devices(flash_flag, mode, causal,
                                                  flash):
    q, k, v = _inputs()
    flash_flag(flash)
    port_fn = seq.ring_attention if mode == "ring" else seq.ulysses_attention
    jax_fn = (jax_seq.ring_attention if mode == "ring"
              else jax_seq.ulysses_attention)
    before = attention.LAUNCHES["flash_block_attn"]
    got = port_fn(*(torch.as_tensor(t) for t in (q, k, v)),
                  causal=causal).numpy()
    assert attention.LAUNCHES["flash_block_attn"] == before   # CPU: plain
    assert np.isfinite(got).all()
    for n in (1, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
        want = np.asarray(jax_fn(*(jnp.asarray(t) for t in (q, k, v)), mesh,
                                 causal=causal))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6,
                                   err_msg=f"{n} device(s)")


def test_ring_and_ulysses_match_the_dense_reference():
    q, k, v = (torch.as_tensor(t) for t in _inputs(1))
    ref = seq.reference_attention(q, k, v).numpy()
    want = np.asarray(jax_seq.reference_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v))))
    np.testing.assert_allclose(ref, want, rtol=2e-5, atol=2e-6)
    for fn in (seq.ring_attention, seq.ulysses_attention):
        np.testing.assert_allclose(fn(q, k, v).numpy(), ref, rtol=2e-5,
                                   atol=2e-6)


def test_flash_gate_follows_the_flag_and_the_shapes(flash_flag):
    assert not seq._resolve_flash(None, 128, 128, 8)      # default off
    flash_flag(True)
    assert seq._resolve_flash(None, 128, 256, 8)
    assert not seq._resolve_flash(None, 64, 128, 8)
    assert not seq._resolve_flash(None, 128, 128, 12)
    assert not seq._resolve_flash(False, 128, 128, 8)
    for args in ((128, 128, 8), (64, 128, 8), (128, 128, 12)):
        assert seq._resolve_flash(True, *args) == \
            jax_seq._resolve_flash(True, *args)


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_a_group_of_more_than_one_rank_raises(fn):
    """A group of one rank is the no-group call, bit for bit; a group of
    more than one rank runs over torch.distributed
    (``test_torch_sequence_ranks.py``) and, outside a process group,
    raises rather than computing this rank's block alone."""
    q, k, v = (torch.as_tensor(t[:, :, :128]) for t in _inputs(2))
    one = types.SimpleNamespace(rank=lambda: 0, size=lambda: 1)
    np.testing.assert_array_equal(getattr(seq, fn)(q, k, v, one).numpy(),
                                  getattr(seq, fn)(q, k, v).numpy())
    group = types.SimpleNamespace(rank=lambda: 1, size=lambda: 4)
    with pytest.raises(RuntimeError, match="process group"):
        getattr(seq, fn)(q, k, v, group, causal=True)
    with pytest.raises(RuntimeError, match="process group"):
        seq.ring_attention_block(q, k, v, 0, 2)
