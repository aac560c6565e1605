"""Port parity: the top-1 MoE block against the JAX package's ``top1_moe``.

The JAX weights (``init_moe`` from a JAX key) and numpy tokens go to both
sides. ``y`` and ``aux`` agree within float32 rounding of differently
ordered einsum sums (``rtol=1e-5, atol=1e-6``): routing is the same
argmax on the same probabilities, so no token changes expert. Capacity
factors of 1.25 (the default) and 0.5 drop tokens, whose slots
``F.one_hot`` would reject and ``jax.nn.one_hot`` zeroes; the numpy
per-token loop (the port's copy of ``reference_top1_moe``) checks the
drops token by token.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
from multiverso_tpu.parallel import expert as jax_expert

torch = expert = None  # set by _load_port

Bt, S, D, HID, E = 2, 16, 8, 32, 4


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, expert
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch.parallel import expert


def _weights(seed=0):
    p = jax_expert.init_moe(jax.random.PRNGKey(seed), D, HID, E)
    return [np.array(t) for t in (p.router, p.w1, p.w2)]


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25, 0.5])
def test_top1_moe_matches_jax(capacity_factor):
    weights = _weights()
    x = np.random.default_rng(0).normal(size=(Bt, S, D)).astype(np.float32)
    y_j, aux_j = jax_expert.top1_moe(
        jax_expert.MoEParams(*map(jnp.asarray, weights)), jnp.asarray(x),
        capacity_factor)
    params = expert.MoEParams(*map(torch.as_tensor, weights))
    y, aux = expert.top1_moe(params, torch.as_tensor(x), capacity_factor)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
    ref = expert.reference_top1_moe(params, x, capacity_factor)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ref, jax_expert.reference_top1_moe(
            jax_expert.MoEParams(*weights), x, capacity_factor),
        rtol=1e-6, atol=1e-7)
    dropped = int((np.abs(ref).sum(-1) == 0).sum())
    if capacity_factor == 4.0:      # capacity = all tokens
        assert dropped == 0
    else:
        assert dropped > 0          # the case really drops tokens


def test_top1_moe_gradients_match_jax():
    weights = _weights(1)
    x = np.random.default_rng(1).normal(size=(Bt, S, D)).astype(np.float32)

    def jax_loss(router, w1, w2, x):
        y, aux = jax_expert.top1_moe(jax_expert.MoEParams(router, w1, w2), x)
        return (y ** 2).sum() + aux

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, weights), jnp.asarray(x))
    ts = [torch.as_tensor(t).requires_grad_() for t in (*weights, x)]
    y, aux = expert.top1_moe(expert.MoEParams(*ts[:3]), ts[3])
    got = torch.autograd.grad((y ** 2).sum() + aux, ts)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_init_moe_shapes_and_seed():
    a = expert.init_moe(torch.Generator().manual_seed(3), D, HID, E)
    b = expert.init_moe(torch.Generator().manual_seed(3), D, HID, E)
    assert tuple(a.router.shape) == (D, E)
    assert tuple(a.w1.shape) == (E, D, HID)
    assert tuple(a.w2.shape) == (E, HID, D)
    for s, t in zip((a.router, a.w1, a.w2), (b.router, b.w1, b.w2)):
        assert torch.equal(s, t)
