"""Port parity: the flat ``c_api`` surface and the param managers
(``multiverso_tpu_torch/binding``) on the CPU.

Mirrors ``tests/test_bindings.py``; the pytree manager takes a dict of
tensors and lays it out in the table in the JAX package's leaf order
(keys sorted), held against the JAX manager's table bitwise.
"""

import numpy as np
import pytest

import _torch_port
import jax
import jax.numpy as jnp

import multiverso_tpu as mvj
from multiverso_tpu.binding import PyTreeParamManager as JPyTreeParamManager

torch = mv = c_api = None  # set by _load_port
PyTreeParamManager = SyncCallback = TorchParamManager = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, mv, c_api, PyTreeParamManager, SyncCallback
    global TorchParamManager
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.binding import (PyTreeParamManager,
                                              SyncCallback,
                                              TorchParamManager)
    from multiverso_tpu_torch.binding import c_api


@pytest.fixture
def mv_env():
    mv.init(["-platform=cpu"])
    yield mv
    mv.shutdown()
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    Zoo._reset_for_tests()
    reset_flags()


def test_c_api_array_roundtrip(mv_env):
    h = c_api.MV_NewArrayTable(10, init_value=np.arange(10))
    np.testing.assert_array_equal(c_api.MV_GetArrayTable(h), np.arange(10))
    c_api.MV_AddArrayTable(h, np.ones(10))
    np.testing.assert_array_equal(c_api.MV_GetArrayTable(h),
                                  np.arange(10) + 1)
    msg = c_api.MV_AddAsyncArrayTable(h, np.ones(10))
    c_api.MV_WaitArrayTable(h, msg)
    np.testing.assert_array_equal(c_api.MV_GetArrayTable(h),
                                  np.arange(10) + 2)


def test_c_api_matrix_roundtrip(mv_env):
    h = c_api.MV_NewMatrixTable(6, 4)
    c_api.MV_AddMatrixTableAll(h, np.ones((6, 4)))
    np.testing.assert_array_equal(c_api.MV_GetMatrixTableAll(h),
                                  np.ones((6, 4)))
    c_api.MV_AddMatrixTableByRows(h, [1, 3], np.full((2, 4), 2.0))
    np.testing.assert_array_equal(c_api.MV_GetMatrixTableByRows(h, [1, 3]),
                                  np.full((2, 4), 3.0))


def test_c_api_ids_and_net(mv_env):
    assert c_api.MV_NumWorkers() == mv.num_workers()
    assert c_api.MV_WorkerId() == 0
    assert c_api.MV_NumServers() >= 1
    c_api.MV_Barrier()
    host, port = c_api.MV_NetBind()
    assert port > 0
    c_api.MV_NetConnect([(host, port)])


def test_pytree_param_manager(mv_env):
    params = {"w": torch.ones((3, 2)), "b": torch.zeros(2)}
    mgr = PyTreeParamManager(params, name="t1")
    got = mgr.get()
    assert set(got) == {"w", "b"} and got["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), np.ones((3, 2)))
    merged = mgr.sync({"w": params["w"] + 1.0, "b": params["b"] + 0.5})
    np.testing.assert_array_equal(merged["w"].numpy(), np.full((3, 2), 2.0))
    np.testing.assert_array_equal(merged["b"].numpy(), np.full(2, 0.5))
    merged2 = mgr.sync(merged)
    np.testing.assert_array_equal(merged2["w"].numpy(), merged["w"].numpy())


def test_pytree_layout_bitwise_the_jax_manager(mv_env):
    """Nested dicts and lists flatten into the table in JAX's leaf order:
    the two managers' tables hold the same bytes."""
    rng = np.random.default_rng(0)
    tree = {"z": rng.normal(size=(2, 3)).astype(np.float32),
            "a": [rng.normal(size=4).astype(np.float32),
                  {"k": rng.normal(size=(1, 2)).astype(np.float32),
                   "c": rng.normal(size=()).astype(np.float32)}]}

    def as_tree(t, leaf):
        if isinstance(t, dict):
            return {k: as_tree(v, leaf) for k, v in t.items()}
        if isinstance(t, list):
            return [as_tree(v, leaf) for v in t]
        return leaf(t)

    mvj.init([], devices=jax.devices()[:1])
    try:
        jm = JPyTreeParamManager(as_tree(tree, jnp.asarray), name="jt")
        want = np.asarray(jm.table.get())
    finally:
        mvj.shutdown()
    tm = PyTreeParamManager(as_tree(tree, torch.tensor), name="tt")
    assert tm.table.get().tobytes() == want.tobytes()
    back = tm.get()
    assert back["a"][1]["c"].shape == () and isinstance(back["a"], list)
    np.testing.assert_array_equal(back["a"][1]["k"].numpy(),
                                  tree["a"][1]["k"])


def test_torch_param_manager(mv_env):
    model = torch.nn.Linear(4, 2)
    mgr = TorchParamManager(model, name="torch1")
    before = model.weight.detach().numpy().copy()
    with torch.no_grad():
        model.weight += 1.0
    mgr.sync()
    np.testing.assert_allclose(model.weight.detach().numpy(), before + 1.0,
                               rtol=1e-6)


def test_sync_callback_frequency(mv_env):
    mgr = PyTreeParamManager({"w": torch.zeros(4)}, name="cb")
    cb = SyncCallback(mgr, freq=2)
    assert cb.on_batch_end({"w": torch.ones(4)}) is None
    out = cb.on_batch_end({"w": torch.ones(4)})
    np.testing.assert_array_equal(out["w"].numpy(), np.ones(4))
