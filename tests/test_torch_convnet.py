"""Port parity: the ASGD convnet (``models/convnet.py``) through
``PyTreeParamManager`` on the CPU.

Mirrors ``tests/test_convnet_asgd.py`` and holds the port against the JAX
convnet with its parameters carried across (``params_from_jax``): the
forward pass and one SGD step from the same parameters and batch agree
within CONV_RTOL of each tensor's largest value (XLA's and torch's
convolutions and matrix products sum in other orders).
"""

import numpy as np
import pytest

import _torch_port
import jax
import jax.numpy as jnp

from multiverso_tpu.models import convnet as jconv

torch = mv = cn = PyTreeParamManager = WorkerPool = None  # set by _load_port

CONV_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, mv, cn, PyTreeParamManager, WorkerPool
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.binding.param_manager import PyTreeParamManager
    from multiverso_tpu_torch.models import convnet as cn
    from multiverso_tpu_torch.parallel.async_engine import WorkerPool


@pytest.fixture
def mv_env():
    mv.init(["-platform=cpu"])
    yield mv
    mv.shutdown()
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    Zoo._reset_for_tests()
    reset_flags()


def _striped_images(n, size=16, seed=0):
    """Class 0: horizontal stripes; class 1: vertical stripes (+noise)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    x = np.zeros((n, size, size, 1), dtype=np.float32)
    phase = rng.integers(0, 4, size=n)
    for i in range(n):
        stripes = ((np.arange(size) + phase[i]) // 2) % 2
        img = np.tile(stripes[:, None], (1, size))
        if y[i] == 1:
            img = img.T
        x[i, :, :, 0] = img + rng.normal(0, 0.3, size=(size, size))
    return x, y.astype(np.int64)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=CONV_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("widths,channels", [((16, 32), 1), ((8,), 3)])
def test_forward_and_sgd_step_match_jax(widths, channels):
    jcfg = jconv.ConvNetConfig(widths=widths, channels=channels, seed=3)
    tcfg = cn.ConvNetConfig(widths=widths, channels=channels, seed=3)
    jp = jconv.init_params(jcfg, jax.random.PRNGKey(3))
    tp = cn.params_from_jax(jp)
    x, y = _striped_images(32, seed=4)
    x = np.repeat(x, channels, axis=3)
    _close(cn.forward(tp, torch.as_tensor(x), tcfg).numpy(),
           jconv.forward(jp, jnp.asarray(x), jcfg))
    module = cn.ConvNet(tcfg, tp)
    _close(module(torch.as_tensor(x)).detach().numpy(),
           jconv.forward(jp, jnp.asarray(x), jcfg))
    step, _ = jconv.make_sgd_step(jcfg)
    jn, jl = step({k: jnp.array(v) for k, v in jp.items()}, jnp.asarray(x),
                  jnp.asarray(y, dtype=jnp.int32))
    tn, tl = cn.sgd_step(tp, torch.as_tensor(x), torch.as_tensor(y), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=CONV_RTOL)
    assert set(tn) == set(jn)
    for k in jn:
        _close(tn[k].numpy(), jn[k])


def test_init_params_shapes_and_scales():
    cfg = cn.ConvNetConfig()
    p = cn.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "conv_0": (3, 3, 1, 16), "conv_1": (3, 3, 16, 32),
        "dense": (512, 64), "out": (64, 2)}
    again = cn.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert abs(float(p["dense"].std()) - np.sqrt(2 / 512)) < 0.01


def test_single_worker_learns(mv_env):
    cfg = cn.ConvNetConfig(seed=1)
    params = cn.init_params(cfg, torch.Generator().manual_seed(1))
    manager = PyTreeParamManager(params, name="cnn1")
    worker = cn.ASGDConvNetWorker(cfg, manager, sync_freq=4)
    x, y = _striped_images(512)
    batches = [(x[i:i + 64], y[i:i + 64]) for i in range(0, 512, 64)]
    for _ in range(6):
        worker.train(batches)
    xt, yt = _striped_images(256, seed=9)
    assert worker.accuracy(xt, yt) > 0.9


def test_multi_worker_asgd_converges(mv_env):
    cfg = cn.ConvNetConfig(seed=2, learning_rate=0.03)
    params = cn.init_params(cfg, torch.Generator().manual_seed(2))
    manager = PyTreeParamManager(params, name="cnn4")
    n_workers = 4
    x, y = _striped_images(1024, seed=3)
    shards = [(x[w::n_workers], y[w::n_workers]) for w in range(n_workers)]
    workers = [cn.ASGDConvNetWorker(cfg, manager, sync_freq=2)
               for _ in range(n_workers)]

    def run(wid):
        xs, ys = shards[wid]
        batches = [(xs[i:i + 32], ys[i:i + 32])
                   for i in range(0, len(xs), 32)]
        for _ in range(6):
            workers[wid].train(batches)

    # ASGD convergence is race-dependent: up to 3 rounds before judging.
    xt, yt = _striped_images(256, seed=11)
    acc = 0.0
    for _ in range(3):
        WorkerPool(n_workers).run(run)
        acc = cn.ASGDConvNetWorker(cfg, manager).accuracy(xt, yt)
        if acc > 0.9:
            break
    assert acc > 0.9, acc
