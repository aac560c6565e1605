"""Port parity: the 1F1B pipeline and the pipelined LM against the JAX
package.

``pipeline_train_1f1b`` and ``pipeline_apply`` at two stages: a gloo world
of two port rank processes on 127.0.0.1 (``tests/_torch_ranks.py``'s
``pipe`` case), each holding its stage's slice of the stacked parameters,
against the JAX functions on a 2-device ``"stage"`` mesh, from the same
numpy inputs (``pipe_inputs``: a tanh stage, a sum-of-squares loss
through a head). The loss, every stage's gradients, the head's and the
input's are held within ``rtol=1e-5`` and ``atol=1e-6 * max|value|`` per
tensor: the same float32 products and sums, in other orders, where a sum
over the microbatches of values up to ~15 carries roundings of ~1e-6.

The pipelined LM at ``stage:2,seq:2`` (four rank processes, the ``lm``
case) against the JAX ``AttentionLM`` with ``pipeline_stages=2,
seq_parallel=2`` from the same stage-stacked weights: the flat eval loss
and 3 ``fit`` steps, at ``test_torch_attention_lm.py``'s tolerances. The
one-process cases: one stage (no process group) against plain autograd,
the stacked layout against the flat one, and interop of JAX's stacked
parameters.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_port
from multiverso_tpu.models import attention_lm as jax_lm
from multiverso_tpu.parallel import pipeline as jax_pp

torch = ranks = lm = pp = interop = None   # set by _load_port

def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


LR, STEPS = 1e-3, 3
PIPE_LM = dict(pipeline_stages=2, seq_parallel=2, learning_rate=LR)


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, ranks, lm, pp, interop
    torch = _torch_port.load_torch()
    import _torch_ranks as ranks
    from multiverso_tpu_torch import interop
    from multiverso_tpu_torch.models import attention_lm as lm
    from multiverso_tpu_torch.parallel import pipeline as pp


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_loss(h, y, t):
    return ((y @ h["head"] - t) ** 2).sum()


@pytest.fixture(scope="module")
def pipe2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipe2"))
    res = ranks.run_world(out, "pipe", 2)
    arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
              for r in range(2)]
    ins = ranks.pipe_inputs(2)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("stage",))
    loss, sg, hg, dx = jax_pp.pipeline_train_1f1b(
        _jax_stage, _jax_loss, {"w": jnp.asarray(ins["w"]),
                                "b": jnp.asarray(ins["b"])},
        jnp.asarray(ins["xs"]), jnp.asarray(ins["tgts"]), mesh,
        head_params={"head": jnp.asarray(ins["head"])},
        return_input_grads=True)
    ys = jax_pp.pipeline_apply(_jax_stage, {"w": jnp.asarray(ins["w"]),
                                            "b": jnp.asarray(ins["b"])},
                               jnp.asarray(ins["xs"]), mesh)
    want = {"loss": float(loss), "w": np.asarray(sg["w"]),
            "b": np.asarray(sg["b"]), "head": np.asarray(hg["head"]),
            "dx": np.asarray(dx), "ys": np.asarray(ys)}
    return res, arrays, want


def test_1f1b_matches_jax_at_two_stages(pipe2):
    res, arrays, want = pipe2
    assert [r["stage"] for r in res] == [0, 1]
    for r, a in zip(res, arrays):
        close(r["loss"], want["loss"])
        s = r["stage"]
        close(a["w"], want["w"][s])
        close(a["b"], want["b"][s])
        close(a["head"], want["head"])
        close(a["dx"], want["dx"])


def test_pipeline_apply_matches_jax_at_two_stages(pipe2):
    _, arrays, want = pipe2
    for a in arrays:
        close(a["ys"], want["ys"])


@pytest.mark.parametrize("with_head", [False, True])
def test_one_stage_is_plain_autograd(with_head):
    """S = 1 (no process group): the schedule's loss and gradients are
    autograd's through the chained microbatches."""
    ins = {k: torch.as_tensor(v) for k, v in ranks.pipe_inputs(1).items()}
    stage = {"w": ins["w"][0].clone().requires_grad_(True),
             "b": ins["b"][0].clone().requires_grad_(True)}
    head = {"head": ins["head"].clone().requires_grad_(True)}
    xs = ins["xs"].clone().requires_grad_(True)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(*args):
        h, y, t = args if with_head else (head, *args)
        return ((y @ h["head"] - t) ** 2).sum()

    got = pp.pipeline_train_1f1b(stage_fn, loss_fn, stage, xs.detach(),
                                 ins["tgts"], None,
                                 head_params=head if with_head else None,
                                 return_input_grads=True)
    total = sum(loss_fn(*((head,) if with_head else ()),
                        stage_fn(stage, xs[m]), ins["tgts"][m])
                for m in range(xs.shape[0]))
    leaves = [stage["w"], stage["b"], xs] + ([head["head"]] if with_head
                                             else [])
    want = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(got[0]), float(total.detach()), rtol=1e-6)
    close(got[1]["w"], want[0])
    close(got[1]["b"], want[1])
    close(got[-1], want[2])
    if with_head:
        close(got[2]["head"], want[3])
    close(pp.pipeline_apply(stage_fn, stage, xs.detach(), None),
          torch.stack([stage_fn(stage, x) for x in xs]).detach())


def test_stacked_layout_is_the_flat_models_of_the_same_seed():
    cfg = lm.LMConfig(**dict(ranks.LM_SMALL, layers=4, pipeline_stages=2))
    stacked = lm.init_pipeline_params(cfg)
    assert {k: tuple(v.shape) for k, v in stacked.items()} == \
        lm.pipeline_param_shapes(cfg)
    flat = lm.init_params(cfg)
    back = lm.pipeline_params_to_flat(cfg, stacked)
    assert sorted(back) == sorted(flat)
    for name in flat:
        assert torch.equal(back[name], flat[name]), name


def test_interop_carries_jax_stacked_parameters():
    """The JAX pipelined model's ``[stages, blocks, ...]`` parameters pass
    the port's check against its stacked layout (the four-rank world of
    ``pipe_lm`` loads them into the pipelined model); unstacked by each
    package, they are the same flat parameters, and the port's flat LM
    from them gives the JAX model's loss."""
    cfg = dict(ranks.LM_SMALL, layers=4, pipeline_stages=2)
    jm = jax_lm.AttentionLM(jax_lm.LMConfig(**cfg), devices=jax.devices()[:2])
    params = {k: np.array(v) for k, v in jm.params.items()}
    pcfg = lm.LMConfig(**cfg)
    interop.check_attention_lm_params(params, lm.pipeline_param_shapes(pcfg))
    want = jax_lm.pipeline_params_to_flat(jm.cfg, params)
    got = lm.pipeline_params_to_flat(
        pcfg, {k: torch.as_tensor(v) for k, v in params.items()})
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    flat = lm.AttentionLM(lm.LMConfig(**dict(ranks.LM_SMALL, layers=4)),
                          device=torch.device("cpu"))
    interop.load_attention_lm_params(flat, {k: v.numpy()
                                            for k, v in got.items()})
    tokens = ranks.lm_tokens(0, B=4)
    np.testing.assert_allclose(flat.loss(tokens), jm.loss(tokens), rtol=1e-5)


@pytest.fixture(scope="module")
def pipe_lm(tmp_path_factory):
    cfg = dict(ranks.LM_SMALL, **PIPE_LM)
    jm = jax_lm.AttentionLM(jax_lm.LMConfig(**cfg), devices=jax.devices()[:4])
    out = str(tmp_path_factory.mktemp("pipe_lm"))
    np.savez(os.path.join(out, "inputs.npz"),
             **{k: np.array(v) for k, v in jm.params.items()})
    res = ranks.run_world(out, "lm", 4, "stage:2,seq:2", json.dumps(cfg))
    port = dict(np.load(os.path.join(out, "rank0.npz")))
    tokens = ranks.lm_tokens(0, B=4)
    want = {"loss": jm.loss(tokens)}
    want["fit"] = jm.fit([ranks.lm_tokens(10 + i, B=4)
                          for i in range(STEPS)])
    want["params"] = {k: np.asarray(v) for k, v in jm.params.items()}
    want["loss_after"] = jm.loss(tokens)
    return res, port, want


def test_pipelined_lm_matches_jax_at_stage2_seq2(pipe_lm):
    res, port, want = pipe_lm
    assert len({r["digest"] for r in res}) == 1, "ranks' parameters differ"
    for r in res:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
    losses = res[0]["fit"]
    np.testing.assert_allclose(losses, want["fit"], rtol=1e-4)
    assert losses[-1] < losses[0]
    for name, w in want["params"].items():
        np.testing.assert_allclose(port[f"param/{name}"], w, rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)
    np.testing.assert_allclose(res[0]["loss_after"], want["loss_after"],
                               rtol=1e-4)
