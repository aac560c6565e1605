"""Port parity of serving an LM with heads wider than 256 columns (B7's
wide instances on a card; its plain version here): 2 heads of 264, 2
layers, vocab 61, the JAX ``AttentionLM``'s weights carried into the port.

Oracles and tolerances:

* every token the port serves (continuous paged and drain paged, float32
  pages) is the argmax of the port's teacher-forced ``forward`` over the
  prompt and the served tokens, or within ``TIE_ATOL`` (1e-4,
  ``chip_smoke.py``'s) of its largest logit;
* that forward is within ``rtol=1e-5, atol=1e-5`` of the JAX package's
  ``forward`` on the same tokens (the same op sequence in float32, summed
  in other orders; ``tests/test_torch_attention_lm.py``'s tolerance);
* int8 pages served continuously equal the port's drain paged int8
  runner, prompt by prompt.

The JAX ``ContinuousBatcher``'s threaded loop is never the oracle
(ROADMAP C3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
from multiverso_tpu.models import attention_lm as jax_lm

torch = None  # set by _load_port

CFG = dict(vocab=61, dim=528, heads=2, layers=2, seq=128)
TIE_ATOL = 1e-4
PROMPTS = [[7, 3, 3, 3, 8, 2, 40], [5, 9, 2], [1],
           [4, 4, 9, 30, 2, 17, 5, 8, 11, 6, 23], [33, 1]]
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch
    torch = _torch_port.load_torch()


@pytest.fixture(scope="module")
def jax_model():
    """The JAX LM at the wide-head widths, on one CPU device."""
    return jax_lm.AttentionLM(jax_lm.LMConfig(**CFG),
                              devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def params(jax_model):
    return {k: np.array(v) for k, v in jax_model.params.items()}


def _runner(params, **kw):
    from multiverso_tpu_torch.models.attention_lm import LMConfig
    from multiverso_tpu_torch.serving import AttentionLMRunner
    return AttentionLMRunner(params, LMConfig(**CFG),
                             device=torch.device("cpu"), **kw)


def _continuous(runner, **kw):
    from multiverso_tpu_torch.serving import ContinuousBatcher
    from multiverso_tpu_torch.telemetry import reset_telemetry

    reset_telemetry()
    cb = ContinuousBatcher(runner, buckets=(8, 16), max_batch=3,
                           max_queue=16, paged=True, page=4, **kw)
    try:
        futs = [cb.submit(np.asarray(p, np.int32), deadline_ms=60_000)
                for p in PROMPTS]
        got = [f.wait(60).tolist() for f in futs]
        assert cb.pool.used_pages() == 0
        return got
    finally:
        cb.close()


def _solo(runner, prompt, bucket=16):
    mat = np.zeros((runner.max_batch, bucket), np.int32)
    mat[0, :len(prompt)] = prompt
    lens = np.zeros(runner.max_batch, np.int32)
    lens[0] = len(prompt)
    return runner.run(mat, lens)[0].tolist()


def _served(params, mode):
    if mode == "continuous":
        return _continuous(_runner(params, max_new=MAX_NEW, max_batch=3))
    drain = _runner(params, max_new=MAX_NEW, max_batch=3, paged=True,
                    page=4)
    return [_solo(drain, p) for p in PROMPTS]


def _teacher_forced(runner, served):
    """The port's ``forward`` over each prompt + its served tokens (the
    last one left out), padded into one batch: (tokens, logits)."""
    from multiverso_tpu_torch.models.attention_lm import LMConfig, forward

    seqs = [p + s[:-1] for p, s in zip(PROMPTS, served)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, x in enumerate(seqs):
        toks[i, :len(x)] = x
    with torch.no_grad():
        logits, _ = forward(runner.params_ref(),
                            torch.as_tensor(toks).long(), LMConfig(**CFG))
    return toks, logits.numpy()


@pytest.mark.parametrize("mode", ["continuous", "drain"])
def test_wide_served_tokens_are_the_teacher_forced_argmax(params, mode):
    """Each served token is the argmax of the port's teacher-forced
    logits at its position, or within TIE_ATOL of the largest."""
    served = _served(params, mode)
    _, logits = _teacher_forced(_runner(params), served)
    for i, (p, s) in enumerate(zip(PROMPTS, served)):
        assert len(s) == MAX_NEW
        lg = logits[i, len(p) - 1:len(p) - 1 + len(s)]
        chosen = lg[np.arange(len(s)), s]
        assert (chosen >= lg.max(axis=1) - TIE_ATOL).all(), (mode, i)


def test_wide_teacher_forced_forward_matches_jax(jax_model, params):
    """The port's forward over the served sequences against the JAX
    package's forward on the same weights and tokens."""
    runner = _runner(params)
    toks, logits = _teacher_forced(runner, _served(params, "continuous"))
    want, _ = jax_lm.forward(jax_model.params, jnp.asarray(toks),
                             jax_model.cfg, jax_model.mesh)
    np.testing.assert_allclose(logits, np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wide_int8_continuous_equals_int8_drain(params):
    """int8 pages at wide heads: the continuous engine's tokens equal the
    drain paged int8 runner's, prompt by prompt."""
    drain = _runner(params, max_new=MAX_NEW, max_batch=3, paged=True,
                    kv_dtype="int8", page=4)
    want = [_solo(drain, p) for p in PROMPTS]
    got = _continuous(_runner(params, max_new=MAX_NEW, max_batch=3),
                      kv_dtype="int8")
    assert got == want
