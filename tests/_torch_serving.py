"""Shared set-up of the port's serving tests (``tests/test_torch_serving_*``
and ``tests/test_torch_paged_attention.py``).

The small LM of ``scripts/serve_bench.py``'s dry run (vocab 61, dim 32,
4 heads, 2 layers, seq 128), its weights drawn by the JAX package's
``init_params`` at ``PRNGKey(0)``; the same numpy dict goes into both
packages. Everything here imports torch, JAX and the two packages inside
the functions, never when this module is imported.
"""

import numpy as np

CFG = dict(vocab=61, dim=32, heads=4, layers=2, seq=128)


def jax_params(key: int = 0):
    """The JAX ``init_params`` weights as a dict of numpy arrays."""
    import jax

    from multiverso_tpu.models.attention_lm import LMConfig, init_params
    return {k: np.asarray(v) for k, v in
            init_params(LMConfig(**CFG), jax.random.PRNGKey(key)).items()}


def jax_runner(params, **kw):
    """The JAX package's drain runner (the oracle), called synchronously
    through ``run``."""
    from multiverso_tpu.models.attention_lm import LMConfig
    from multiverso_tpu.serving import AttentionLMRunner
    return AttentionLMRunner(params, LMConfig(**CFG), **kw)


def port_runner(params, **kw):
    """The port's runner on the CPU."""
    import torch

    from multiverso_tpu_torch.models.attention_lm import LMConfig
    from multiverso_tpu_torch.serving import AttentionLMRunner
    return AttentionLMRunner(params, LMConfig(**CFG),
                             device=torch.device("cpu"), **kw)


def solo(runner, prompt, bucket):
    """``prompt`` alone through ``runner.run`` at ``bucket``."""
    mat = np.zeros((runner.max_batch, bucket), np.int32)
    mat[0, :len(prompt)] = prompt
    lens = np.zeros(runner.max_batch, np.int32)
    lens[0] = len(prompt)
    return runner.run(mat, lens)[0].tolist()


def random_batch(rng, rows, bucket):
    """A ``(rows, bucket)`` right-padded prompt matrix and its lengths."""
    mat = np.zeros((rows, bucket), np.int32)
    lens = np.zeros(rows, np.int32)
    for i in range(rows):
        n = int(rng.integers(1, bucket + 1))
        mat[i, :n] = rng.integers(1, 60, n)
        lens[i] = n
    return mat, lens
