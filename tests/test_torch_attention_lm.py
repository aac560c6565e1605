"""Port parity: the attention LM against the JAX package's ``AttentionLM``.

Both models are built at a small size (vocab 61, dim 32, 4 heads, 2
layers, seq 256), the JAX one on ``jax.devices()[:1]`` (a 1 x 1 mesh: one
rank, as the port runs), and the JAX parameters are carried into the port
with ``interop.load_attention_lm_params``. With ``-flash_attention`` on,
the JAX side runs its Pallas kernel in interpret mode and the port B6's
plain version (the CPU path).

Tolerances and why:

* logits ``rtol=1e-5, atol=1e-5`` (they are O(1)) and the loss
  ``rtol=1e-5``: the same op sequence in float32, with matrix products
  and softmax sums taken in different orders (the readings are ~2e-6 and
  ~1e-7);
* gradients, per tensor, ``rtol=1e-4`` and ``atol=1e-5 * max|g|``: one
  backward pass of the same graph (readings up to 9e-7 of max|g|);
* 3 ``fit`` steps: losses ``rtol=1e-4``; parameters ``atol=2 * lr *
  steps``. Adam's first steps are about ``-lr * sign(g)``, and where a
  gradient element is rounding noise the two frameworks can step in
  opposite directions, each by up to ~lr per step; a step of the wrong
  size or sign where the gradient is real moves the loss, which is held
  tightly.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
from multiverso_tpu.models import attention_lm as jax_lm
from multiverso_tpu.utils.configure import set_flag as jax_set_flag

torch = lm = interop = attention = port_flags = None  # set by _load_port

SMALL = dict(vocab=61, dim=32, heads=4, layers=2, seq=256)


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, lm, interop, attention, port_flags
    torch = _torch_port.load_torch()
    from multiverso_tpu_torch import interop
    from multiverso_tpu_torch.models import attention_lm as lm
    from multiverso_tpu_torch.ops import attention
    from multiverso_tpu_torch.utils import configure as port_flags


@pytest.fixture
def flash_flag():
    """Sets ``-flash_attention`` in both packages; both reset after."""
    def set_both(on):
        jax_set_flag("flash_attention", on)
        port_flags.set_flag("flash_attention", on)
    yield set_both
    port_flags.reset_flags()


def _pair(**kw):
    """(JAX model, port model) with the JAX parameters carried over."""
    cfg = dict(SMALL, **kw)
    jm = jax_lm.AttentionLM(jax_lm.LMConfig(**cfg),
                            devices=jax.devices()[:1])
    pm = lm.AttentionLM(lm.LMConfig(**cfg), device=torch.device("cpu"))
    interop.load_attention_lm_params(
        pm, {k: np.array(v) for k, v in jm.params.items()})
    return jm, pm


def _tokens(seed=0, B=2, S=256, vocab=61):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _cyclic_batches(n_batches, B=4, S=64, K=17, seed=0):
    """Deterministic cyclic sequences: token[t+1] = (token[t]+1) mod K
    (``tests/test_attention_lm.py``)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, K, size=(B, 1)) + np.arange(S)[None, :]) % K
            for _ in range(n_batches)]


CASES = {
    "dense-ring": dict(),
    "dense-ring-flash": dict(flash=True),
    "dense-ulysses": dict(sp_mode="ulysses"),
    "dense-ulysses-flash": dict(sp_mode="ulysses", flash=True),
    "moe-ring": dict(moe_experts=4),
    "moe-ulysses-flash": dict(moe_experts=4, sp_mode="ulysses", flash=True),
    "dense-ring-remat": dict(remat=True),
    "moe-ring-flash-remat": dict(moe_experts=4, flash=True, remat=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_loss_match_jax(flash_flag, case):
    kw = dict(CASES[case])
    flash = kw.pop("flash", False)
    jm, pm = _pair(**kw)
    flash_flag(flash)
    tokens = _tokens()
    logits_j, aux_j = jax_lm.forward(jm.params, jnp.asarray(tokens),
                                     jm.cfg, jm.mesh)
    before = attention.LAUNCHES["flash_block_attn"]
    with torch.no_grad():
        logits, aux = lm.forward(pm.params, torch.as_tensor(tokens).long(),
                                 pm.cfg)
    assert attention.LAUNCHES["flash_block_attn"] == before   # CPU: plain
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
    np.testing.assert_allclose(pm.loss(tokens), jm.loss(tokens), rtol=1e-5)


@pytest.mark.parametrize("case", ["dense-ring", "moe-ulysses",
                                  "dense-ring-remat"])
def test_gradients_match_jax(case):
    kw = {"dense-ring": dict(), "moe-ulysses": dict(moe_experts=4,
                                                    sp_mode="ulysses"),
          "dense-ring-remat": dict(remat=True)}[case]
    jm, pm = _pair(**kw)
    tokens = _tokens(1)
    grad_fn = jax.jit(lambda p, t: jax.grad(jax_lm.next_token_loss)(
        p, t, jm.cfg, jm.mesh))
    want = grad_fn(jm.params, jnp.asarray(tokens))
    loss = lm.next_token_loss(pm.params, torch.as_tensor(tokens).long(),
                              pm.cfg)
    names = list(pm.params)
    got = torch.autograd.grad(loss, [pm.params[n] for n in names])
    assert sorted(names) == sorted(want)
    for name, g in zip(names, got):
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("moe", [0, 4])
def test_three_fit_steps_match_jax(moe):
    lr, steps = 1e-3, 3
    jm, pm = _pair(moe_experts=moe, learning_rate=lr)
    batches = [_tokens(10 + i) for i in range(steps)]
    losses_j = jm.fit(batches)          # donates its buffers: read after
    losses = pm.fit(batches)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    assert losses[-1] < losses[0]
    for name, p in pm.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jm.params[name]),
                                   rtol=0, atol=2 * lr * steps,
                                   err_msg=name)


def test_fit_with_flash_raises_where_the_gradient_is_needed(flash_flag):
    _, pm = _pair()
    flash_flag(True)
    before = {k: v.detach().clone() for k, v in pm.params.items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        pm.fit([_tokens()])
    for name, p in pm.params.items():            # no step was taken
        assert torch.equal(p.detach(), before[name]), name
    flash_flag(False)
    assert np.isfinite(pm.fit([_tokens()])).all()


@pytest.mark.parametrize("kw,ranks,match", [
    (dict(seq_parallel=2, data_parallel=1), 1, "mesh 1x2 exceeds 1 "),
    (dict(seq=255, seq_parallel=2), 2, "seq must divide by seq_parallel"),
    (dict(pipeline_stages=2, moe_experts=4), 1, "does not compose with MoE"),
])
def test_unported_configurations_raise(kw, ranks, match):
    """The JAX ``AttentionLM``'s checks that refuse a configuration, in
    both packages: a mesh larger than the ranks (devices) it has, a
    sequence that does not split over the sequence axis, and the pipeline
    with MoE. The port's model reads only the size of its mesh before the
    checks, so a stand-in of that size takes the place of a world."""
    from multiverso_tpu_torch.utils.log import FatalError
    cfg = dict(SMALL, **kw)
    with pytest.raises(Exception, match=match):
        jax_lm.AttentionLM(jax_lm.LMConfig(**cfg),
                           devices=jax.devices()[:ranks])
    mesh = types.SimpleNamespace(size=ranks) if ranks > 1 else None
    with pytest.raises(FatalError, match=match):
        lm.AttentionLM(lm.LMConfig(**cfg), device=torch.device("cpu"),
                       mesh=mesh)


def test_the_card_is_the_default_device(monkeypatch):
    from multiverso_tpu_torch.utils.log import FatalError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FatalError, match="no CUDA device"):
        lm.AttentionLM(lm.LMConfig(**SMALL))
    port_flags.set_flag("platform", "cpu")
    try:
        assert lm.AttentionLM(lm.LMConfig(**SMALL)).device.type == "cpu"
    finally:
        port_flags.reset_flags()


def test_lm_learns_cyclic_sequence():
    """``tests/test_attention_lm.py::test_lm_learns_cyclic_sequence`` at
    one rank."""
    model = lm.AttentionLM(lm.LMConfig(vocab=32, dim=32, heads=4, layers=2,
                                       seq=64, learning_rate=3e-3),
                           device=torch.device("cpu"))
    batches = _cyclic_batches(60)
    initial = model.loss(batches[0])
    losses = model.fit(batches)
    final = model.loss(batches[0])
    assert np.isfinite(losses).all()
    assert final < initial * 0.5
    assert final < 1.0, f"final loss {final:.3f} (initial {initial:.3f})"


def test_interop_rejects_a_mismatched_model():
    from multiverso_tpu_torch.utils.log import FatalError
    jm = jax_lm.AttentionLM(jax_lm.LMConfig(**SMALL),
                            devices=jax.devices()[:1])
    params = {k: np.array(v) for k, v in jm.params.items()}
    pm = lm.AttentionLM(lm.LMConfig(**SMALL), device=torch.device("cpu"))
    renamed = {("head" if k == "out" else k): v for k, v in params.items()}
    missing = {k: v for k, v in params.items() if k != "mlp_in_1"}
    bad = [("names differ", renamed), ("names differ", missing),
           ("shape", {**params, "embed": params["embed"][:-1]}),
           ("dtype", {**params, "qkv_0": params["qkv_0"].astype(np.float64)})]
    for match, payload in bad:
        with pytest.raises(FatalError, match=match):
            interop.load_attention_lm_params(pm, payload)
    moe = lm.AttentionLM(lm.LMConfig(**dict(SMALL, moe_experts=4)),
                         device=torch.device("cpu"))
    with pytest.raises(FatalError, match="names differ"):
        interop.load_attention_lm_params(moe, params)
    # the refused loads wrote nothing
    fresh = lm.AttentionLM(lm.LMConfig(**SMALL), device=torch.device("cpu"))
    for name, p in pm.params.items():
        assert torch.equal(p, fresh.params[name]), name
