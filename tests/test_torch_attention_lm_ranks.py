"""Port parity: the attention LM across ranks against the JAX package's
``AttentionLM`` with ``seq_parallel``/``data_parallel`` set.

Each case builds the JAX model on the first n of the 8 virtual CPU devices
and a gloo world of n port rank processes on 127.0.0.1
(``tests/_torch_ranks.py``'s ``lm`` case) on the rank mesh of the same
axes, the JAX parameters carried into every rank with
``interop.load_attention_lm_params``: the LM at ``seq:2`` (ring, and
Ulysses), at ``data:2,seq:2``, and the MoE LM at ``seq:2`` (whose
capacity and queue slots follow the whole batch, as JAX's global view).
Every rank is fed the same batches (``_torch_ranks.lm_tokens``); the
ranks' parameters must stay equal (one digest).

Tolerances, as ``test_torch_attention_lm.py``'s and for the same reasons
(the same op sequence in float32, sums in other orders, here also split
over ranks): the loss ``rtol=1e-5`` (flag off, and on: B6's plain version
here, the Pallas kernel in interpret mode there); gradients per tensor
``rtol=1e-4`` and ``atol=1e-5 * max|g|``; 3 ``fit`` steps: losses
``rtol=1e-4``, parameters ``atol=2 * lr * steps``.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
from multiverso_tpu.models import attention_lm as jax_lm
from multiverso_tpu.utils.configure import reset_flags as jax_reset_flags
from multiverso_tpu.utils.configure import set_flag as jax_set_flag

ranks = None   # set by _load_port

LR, STEPS = 1e-3, 3

#: case -> (ranks, mesh, LMConfig fields beside the small widths)
CASES = {
    "seq2-ring": (2, "data:1,seq:2", dict(seq_parallel=2, data_parallel=1)),
    "seq2-ulysses": (2, "data:1,seq:2", dict(seq_parallel=2, data_parallel=1,
                                             sp_mode="ulysses")),
    "data2-seq2": (4, "data:2,seq:2", dict(seq_parallel=2, data_parallel=2)),
    "moe-seq2": (2, "data:1,seq:2", dict(seq_parallel=2, data_parallel=1,
                                         moe_experts=4)),
}


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global ranks
    _torch_port.load_torch()
    import _torch_ranks as ranks


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """The JAX model's readings and the port world's, for one case."""
    n, mesh_shape, kw = CASES[request.param]
    cfg = dict(ranks.LM_SMALL, learning_rate=LR, **kw)
    jm = jax_lm.AttentionLM(jax_lm.LMConfig(**cfg),
                            devices=jax.devices()[:n])
    out = str(tmp_path_factory.mktemp(request.param))
    np.savez(os.path.join(out, "inputs.npz"),
             **{k: np.array(v) for k, v in jm.params.items()})
    res = ranks.run_world(out, "lm", n, mesh_shape, json.dumps(cfg))
    port = dict(np.load(os.path.join(out, "rank0.npz")))

    tokens = ranks.lm_tokens(0)
    want = {"loss": jm.loss(tokens)}
    jax_set_flag("flash_attention", True)
    try:
        want["loss_flash"] = jm.loss(tokens)
    finally:
        jax_reset_flags()
    grad_fn = jax.jit(lambda p, t: jax.value_and_grad(
        jax_lm.next_token_loss)(p, t, jm.cfg, jm.mesh))
    want["grad_loss"], grads = grad_fn(jm.params,
                                       jnp.asarray(ranks.lm_tokens(1)))
    want["grads"] = {k: np.asarray(v) for k, v in grads.items()}
    want["fit"] = jm.fit([ranks.lm_tokens(10 + i) for i in range(STEPS)])
    want["params"] = {k: np.asarray(v) for k, v in jm.params.items()}
    want["loss_after"] = jm.loss(tokens)
    return res, port, want


def test_forward_and_gradients_match_jax(case):
    res, port, want = case
    for r in res:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["loss_flash"], want["loss_flash"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_loss"], float(want["grad_loss"]),
                                   rtol=1e-5)
    names = sorted(k[len("grad/"):] for k in port if k.startswith("grad/"))
    assert names == sorted(want["grads"])
    for name in names:
        w = want["grads"][name]
        np.testing.assert_allclose(port[f"grad/{name}"], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_three_fit_steps_match_jax(case):
    res, port, want = case
    assert len({r["digest"] for r in res}) == 1, "ranks' parameters differ"
    assert sorted(tuple(r["shard"]) for r in res) == sorted(
        {tuple(r["shard"]) for r in res})
    losses = res[0]["fit"]
    np.testing.assert_allclose(losses, want["fit"], rtol=1e-4)
    assert losses[-1] < losses[0]
    for name, w in want["params"].items():
        np.testing.assert_allclose(port[f"param/{name}"], w, rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)
    np.testing.assert_allclose(res[0]["loss_after"], want["loss_after"],
                               rtol=1e-4)


@pytest.mark.parametrize("world,kw", [
    (1, {}), (2, {}), (4, {}), (8, {}), (8, dict(seq_parallel=2)),
    (4, dict(data_parallel=2, seq_parallel=2)),
    (4, dict(pipeline_stages=2, seq_parallel=2)),
    (2, dict(pipeline_stages=2)),
])
def test_lm_mesh_spec_takes_the_jax_models_sizes(world, kw):
    """``parallel/mesh.py::lm_mesh_spec`` names the axes and sizes the JAX
    ``AttentionLM`` lays its devices out on for the same configuration
    (its defaults ``sp = seq_parallel or min(n, 4)``, ``dp = data_parallel
    or n // sp``; ``stage x seq`` for the pipeline)."""
    from multiverso_tpu_torch.parallel import mesh as port_mesh
    layers = 2 * kw.get("pipeline_stages", 1)
    jm = jax_lm.AttentionLM(jax_lm.LMConfig(**dict(
        ranks.LM_SMALL, layers=layers, **kw)), devices=jax.devices()[:world])
    spec = port_mesh.lm_mesh_spec(world, kw.get("seq_parallel"),
                                  kw.get("data_parallel"),
                                  kw.get("pipeline_stages", 0))
    assert port_mesh.parse_mesh_spec(spec) == dict(jm.mesh.shape)
