"""Port parity: logistic regression (objectives, readers, ``LocalModel``,
``PSModel`` with and without the pipelined pull, FTRL's server-side
``{z, n}``, the CLI) on the CPU against the JAX package.

Mirrors the single-process cases of ``tests/test_logreg.py``. Each
training case feeds the same minibatches to a JAX ``LogReg`` and a port
``LogReg`` and holds the port's weights within rtol 1e-5 / atol 1e-6 of
JAX's after them (the matrix products sum in other orders, and the JAX
steps run under ``jax.jit``); the readers and the config parser are held
exactly.
"""

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj
from multiverso_tpu.models import logreg as jlr
from multiverso_tpu.models.logreg import reader as jreader

mvt = tlr = treader = torch = None  # set by _load_port

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tlr, treader, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.models import logreg as tlr
    from multiverso_tpu_torch.models.logreg import reader as treader


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    Dashboard.reset()


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()


def _synthetic_binary(n=400, f=10, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=f)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    return X, y


def _synthetic_multiclass(n=600, f=8, c=3, seed=1):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(f, c))
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X @ W).argmax(axis=1).astype(np.float32)
    return X, y


def _train_both(cfg_kw, X, y, bs, epochs):
    """The same config and minibatches through both packages; returns
    (jax LogReg, port LogReg, jax losses, port losses)."""
    jl = jlr.LogReg(jlr.LogRegConfig(**cfg_kw))
    tl = tlr.LogReg(tlr.LogRegConfig(**cfg_kw))
    j_losses = jl.train(jlr.ArrayBatcher(X, y, bs), epochs=epochs)
    t_losses = tl.train(tlr.ArrayBatcher(X, y, bs), epochs=epochs)
    np.testing.assert_allclose(tl.model.get_weights(),
                               np.asarray(jl.model.get_weights()),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_losses, j_losses, rtol=RTOL, atol=ATOL)
    return jl, tl, j_losses, t_losses


@pytest.mark.parametrize("objective", ["sigmoid", "softmax", "ftrl"])
@pytest.mark.parametrize("regular", ["none", "l1", "l2"])
def test_objective_loss_and_grad(objective, regular):
    rng = np.random.default_rng(2)
    c = 3 if objective == "softmax" else 1
    w = rng.normal(size=(9, c)).astype(np.float32)
    X = rng.normal(size=(32, 9)).astype(np.float32)
    y = (rng.integers(0, c, size=32) if c > 1
         else rng.integers(0, 2, size=32)).astype(np.float32)
    kw = dict(objective=objective, num_feature=8, num_class=c,
              regular=regular, regular_coef=0.3)
    jl, jg = jlr.model._make_step(jlr.LogRegConfig(**kw))(
        jax.numpy.asarray(w), jax.numpy.asarray(X), jax.numpy.asarray(y))
    tl, tg = tlr.model.make_step(tlr.LogRegConfig(**kw))(
        torch.as_tensor(w), torch.as_tensor(X), torch.as_tensor(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)
    _, jpred = jlr.objective.get_objective(objective)
    _, tpred = tlr.objective.get_objective(objective)
    np.testing.assert_allclose(tpred(torch.as_tensor(w),
                                     torch.as_tensor(X)).numpy(),
                               np.asarray(jpred(w, X)), rtol=RTOL,
                               atol=ATOL)


def test_parse_libsvm():
    for line in ("1 3:0.5 17:2.0", "0 1:1e-3 9:7"):
        assert treader.parse_libsvm_line(line) == \
            jreader.parse_libsvm_line(line)
    assert treader.parse_weight_line("1:2.0 0:1.5 2:1.0") == \
        jreader.parse_weight_line("1:2.0 0:1.5 2:1.0")


@pytest.mark.parametrize("fmt", ["libsvm", "dense", "weight", "bsparse"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_readers_match(tmp_path, fmt, prefetch):
    p = tmp_path / f"data.{fmt}"
    if fmt == "libsvm":
        p.write_text("1 0:1.0 2:3.0\n0 1:2.0\n\n1 0:0.5 7:2\n")
    elif fmt == "dense":
        p.write_text("1 0.5 1 2 3\n0 4 5 6 7 8 9\n1 1\n")
    elif fmt == "weight":
        p.write_text("1:2.0 0:1.5 2:1.0\n0:0.5 1:4.0\n1 3:1\n")
    else:
        treader.write_bsparse(str(p), [(1.0, 2.0, [0, 3]), (0.0, 1.0, [1]),
                                       (1.0, 0.5, [2, 3, 9])])
    kw = dict(num_feature=4, minibatch_size=2, input_format=fmt,
              prefetch=prefetch)
    want = list(jreader.SampleReader(str(p), **kw))
    got = list(treader.SampleReader(str(p), **kw))
    assert len(want) == len(got) == 2
    for (wx, wy), (gx, gy) in zip(want, got):
        assert np.array_equal(wx, gx) and np.array_equal(wy, gy)


def test_bsparse_binary_roundtrip(tmp_path):
    p = tmp_path / "samples.bin"
    samples = [(1.0, 2.0, [0, 3]), (0.0, 1.0, [1]), (1.0, 0.5, [2, 3])]
    assert treader.write_bsparse(str(p), samples) == 3
    with open(p, "rb") as f:
        port_bytes = f.read()
    jreader.write_bsparse(str(tmp_path / "j.bin"), samples)
    with open(tmp_path / "j.bin", "rb") as f:
        assert f.read() == port_bytes
    back = list(treader.read_bsparse(str(p)))
    assert [(l, w, list(k)) for l, w, k in back] == \
        [(l, w, list(k)) for l, w, k in samples]


def test_local_model_converges(both):
    X, y = _synthetic_binary()
    _, tl, _, _ = _train_both(dict(objective="sigmoid", num_feature=10,
                                   use_ps=False, learning_rate=1.0,
                                   minibatch_size=32), X, y, 32, 20)
    assert tl.test(tlr.ArrayBatcher(X, y, 64)) > 0.9


def test_ps_model_converges(both):
    X, y = _synthetic_binary()
    _, tl, _, losses = _train_both(dict(objective="sigmoid", num_feature=10,
                                        use_ps=True, learning_rate=1.0,
                                        minibatch_size=32, sync_frequency=1),
                                   X, y, 32, 20)
    assert losses[-1] < losses[0]
    assert tl.test(tlr.ArrayBatcher(X, y, 64)) > 0.9


def test_ps_pipeline_mode(both):
    X, y = _synthetic_binary()
    _, tl, _, _ = _train_both(dict(objective="sigmoid", num_feature=10,
                                   use_ps=True, learning_rate=1.0,
                                   minibatch_size=32, sync_frequency=2,
                                   pipeline=True), X, y, 32, 25)
    assert tl.test(tlr.ArrayBatcher(X, y, 64)) > 0.85


def test_softmax_multiclass(both):
    X, y = _synthetic_multiclass()
    _, tl, _, _ = _train_both(dict(objective="softmax", num_feature=8,
                                   num_class=3, use_ps=True,
                                   learning_rate=1.0, minibatch_size=50),
                              X, y, 50, 25)
    assert tl.test(tlr.ArrayBatcher(X, y, 100)) > 0.85


def test_ftrl_objective(both):
    X, y = _synthetic_binary(n=300)
    _, tl, _, _ = _train_both(dict(objective="ftrl", num_feature=10,
                                   use_ps=True, minibatch_size=32,
                                   ftrl_alpha=0.5, ftrl_beta=1.0,
                                   ftrl_l1=0.01, ftrl_l2=0.01), X, y, 32, 15)
    assert tl.test(tlr.ArrayBatcher(X, y, 64)) > 0.85
    state = tl.model.table.store.store_state()
    assert sorted(state) == ["data", "state/n", "state/z"]


@pytest.mark.parametrize("regular", ["l1", "l2"])
def test_regularization(both, regular):
    X, y = _synthetic_binary(n=200)
    kw = dict(objective="sigmoid", num_feature=10, use_ps=False,
              learning_rate=1.0, minibatch_size=32)
    _, reg, _, _ = _train_both(dict(kw, regular=regular, regular_coef=0.5),
                               X, y, 32, 10)
    _, plain, _, _ = _train_both(kw, X, y, 32, 10)
    assert np.abs(reg.model.get_weights()).mean() < \
        np.abs(plain.model.get_weights()).mean()


def _conf_fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def test_config_from_file(tmp_path):
    p = tmp_path / "logreg.conf"
    p.write_text("objective=softmax\nnum_feature=100\nnum_class=5\n"
                 "learning_rate=0.01\npipeline=true\n# comment\n")
    cfg = tlr.LogRegConfig.from_file(str(p))
    assert _conf_fields(cfg) == \
        _conf_fields(jlr.LogRegConfig.from_file(str(p)))
    assert cfg.objective == "softmax" and cfg.pipeline is True


def test_config_reference_key_aliases(tmp_path):
    p = tmp_path / "ref.conf"
    p.write_text("input_size=40\noutput_size=3\ntrain_epoch=7\n"
                 "objective_type=softmax\nregular_type=L2\n"
                 "train_file=a.svm\ntest_file=b.svm\noutput_file=o.txt\n"
                 "alpha=0.25\nlambda1=2.5\n")
    cfg = tlr.LogRegConfig.from_file(str(p))
    assert _conf_fields(cfg) == \
        _conf_fields(jlr.LogRegConfig.from_file(str(p)))
    assert cfg.num_feature == 40 and cfg.regular == "l2"


def test_model_save_load_roundtrip(both, tmp_path):
    X, y = _synthetic_binary()
    for use_ps in (False, True):
        kw = dict(objective="sigmoid", num_feature=10, use_ps=use_ps,
                  learning_rate=1.0, minibatch_size=32)
        if use_ps:   # one weight table per process
            mvt.shutdown()
            mvt.init(["-platform=cpu"])
        lr = tlr.LogReg(tlr.LogRegConfig(**kw))
        lr.train(tlr.ArrayBatcher(X, y, 32), epochs=5)
        path = tmp_path / f"model_{use_ps}.npy"
        lr.save_model(str(path))
        if use_ps:
            weights = lr.model.get_weights().copy()
            pred = lr.predict(np.concatenate(
                [X[:16], np.ones((16, 1), X.dtype)], axis=1))
            mvt.shutdown()
            mvt.init(["-platform=cpu"])
        else:
            weights = lr.model.get_weights()
            pred = lr.predict(np.concatenate(
                [X[:16], np.ones((16, 1), X.dtype)], axis=1))
        lr2 = tlr.LogReg(tlr.LogRegConfig(
            objective="sigmoid", num_feature=10, use_ps=use_ps,
            init_model_file=str(path)))
        np.testing.assert_array_equal(lr2.model.get_weights(), weights)
        np.testing.assert_array_equal(lr2.predict(np.concatenate(
            [X[:16], np.ones((16, 1), X.dtype)], axis=1)), pred)


def test_predictions_written(both, tmp_path):
    X, y = _synthetic_binary(n=64)
    cfg = tlr.LogRegConfig(objective="sigmoid", num_feature=10, use_ps=False)
    lr = tlr.LogReg(cfg)
    lr.train(tlr.ArrayBatcher(X, y, 32), epochs=2)
    out = tmp_path / "preds.txt"
    lr.test(tlr.ArrayBatcher(X, y, 32), output_path=str(out))
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 64
    float(lines[0])


def test_bsparse_trains_end_to_end(both, tmp_path):
    rng = np.random.default_rng(0)
    samples = [(1.0, 1.0, [0, 1]) if rng.random() < 0.5
               else (0.0, 1.0, [2, 3]) for _ in range(200)]
    p = tmp_path / "train.bin"
    treader.write_bsparse(str(p), samples)
    kw = dict(num_feature=4, objective="sigmoid", use_ps=False,
              learning_rate=0.5, minibatch_size=32, input_format="bsparse")
    jl = jlr.LogReg(jlr.LogRegConfig(**kw))
    tl = tlr.LogReg(tlr.LogRegConfig(**kw))
    rk = dict(num_feature=4, minibatch_size=32, input_format="bsparse",
              prefetch=False)
    jl.train(jlr.SampleReader(str(p), **rk), epochs=4)
    tl.train(tlr.SampleReader(str(p), **rk), epochs=4)
    np.testing.assert_allclose(tl.model.get_weights(),
                               np.asarray(jl.model.get_weights()),
                               rtol=RTOL, atol=ATOL)
    assert tl.test(tlr.SampleReader(str(p), **rk)) > 0.95


def test_comm_policies_build_their_models(both):
    from multiverso_tpu_torch.models.logreg.model import (AllreduceModel,
                                                          ModelAverageModel)
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.parallel import comm_policy as cp
    assert isinstance(tlr.make_model(tlr.LogRegConfig(
        num_feature=4, comm_policy="allreduce")), AllreduceModel)
    assert isinstance(tlr.make_model(tlr.LogRegConfig(
        num_feature=4, comm_policy="model_average")), ModelAverageModel)
    # "auto": the weight table is small and dense, so the probe decides.
    auto = tlr.make_model(tlr.LogRegConfig(num_feature=4,
                                           comm_policy="auto"))
    lat = cp.measured_policy_latency_ms(5 * 4, Zoo.get().mesh, world=1)
    assert isinstance(auto, AllreduceModel if lat[cp.ALLREDUCE] <= lat[cp.PS]
                      else tlr.PSModel)
    from multiverso_tpu_torch.utils.log import FatalError
    with pytest.raises(FatalError):
        tlr.make_model(tlr.LogRegConfig(num_feature=4, objective="ftrl",
                                        comm_policy="allreduce"))


def test_cli_trains_and_tests_on_cpu(tmp_path):
    from multiverso_tpu_torch.apps import logreg_main
    X, y = _synthetic_binary(n=300, f=6)
    lines = [f"{int(lab)} " + " ".join(f"{i}:{v:.4f}"
                                         for i, v in enumerate(row))
             for row, lab in zip(X, y)]
    (tmp_path / "train.svm").write_text("\n".join(lines) + "\n")
    (tmp_path / "lr.conf").write_text(
        "objective=sigmoid\nnum_feature=6\nlearning_rate=0.5\n"
        "train_epoch=3\n"
        f"output_model_file={tmp_path}/model.npy\n")
    rc = logreg_main.main([f"-config_file={tmp_path}/lr.conf",
                           f"-lr_train_file={tmp_path}/train.svm",
                           f"-lr_test_file={tmp_path}/train.svm",
                           f"-output_file={tmp_path}/pred.txt",
                           "-lr_device=cpu"])
    assert rc == 0
    assert len((tmp_path / "pred.txt").read_text().split()) == 300
    assert np.load(tmp_path / "model.npy").shape == (7, 1)
    from multiverso_tpu_torch.utils.configure import reset_flags
    reset_flags()
    # -world_size=2 launches two PS ranks; each exits 1 without a
    # training file.
    assert logreg_main.main(["-world_size=2", "-lr_device=cpu"]) == 1
    reset_flags()
    assert logreg_main.main(["-lr_device=cpu"]) == 1   # no train file


def test_two_rank_distributed_logreg():
    """Mirror of ``tests/test_distributed_logreg.py``: two PS-service
    ranks, each training on its half of the data against the weights
    split over both services; both ranks' models classify well and their
    tables agree (the JAX test's rtol 1e-5 / atol 1e-6)."""
    import threading
    from multiverso_tpu_torch.models.logreg import ArrayBatcher, LogReg
    from multiverso_tpu_torch.models.logreg.model import PSModel
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedArrayTable, PSService)
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=10)
    X = rng.normal(size=(600, 10)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    mvt.init(["-platform=cpu"])
    cfg = tlr.LogRegConfig(objective="sigmoid", num_feature=10, use_ps=True,
                           learning_rate=0.5, minibatch_size=32,
                           sync_frequency=1)
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    tables = []
    try:
        tables += [DistributedArrayTable(50, cfg.width, svc, peers, rank=r,
                                         updater="sgd")
                   for r, svc in enumerate((svc0, svc1))]
        regs = [LogReg(cfg, model=PSModel(cfg, table=t)) for t in tables]
        shards = [(X[0::2], y[0::2]), (X[1::2], y[1::2])]

        def train(r):
            regs[r].train(ArrayBatcher(*shards[r], 32), epochs=15)

        threads = [threading.Thread(target=train, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        for r in range(2):
            regs[r].model.sync()
            acc = regs[r].test(ArrayBatcher(X, y, 64))
            assert acc > 0.9, f"rank {r} acc {acc}"
        np.testing.assert_allclose(tables[0].get(), tables[1].get(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        for t in tables:
            t.close()
        svc0.close()
        svc1.close()


def test_cli_two_ranks_train_on_cpu(tmp_path):
    """``logreg_main -world_size=2``: the launcher spawns two PS ranks,
    each trains on its shard of the file, rank 0 tests and saves."""
    from multiverso_tpu_torch.apps import logreg_main
    X, y = _synthetic_binary(n=400, f=6)
    lines = [f"{int(lab)} " + " ".join(f"{i}:{v:.4f}"
                                         for i, v in enumerate(row))
             for row, lab in zip(X, y)]
    (tmp_path / "train.svm").write_text("\n".join(lines) + "\n")
    (tmp_path / "lr.conf").write_text(
        "objective=sigmoid\nnum_feature=6\nlearning_rate=0.5\n"
        "train_epoch=3\n"
        f"output_model_file={tmp_path}/model.npy\n")
    rc = logreg_main.main([f"-config_file={tmp_path}/lr.conf",
                           f"-lr_train_file={tmp_path}/train.svm",
                           f"-lr_test_file={tmp_path}/train.svm",
                           f"-output_file={tmp_path}/pred.txt",
                           "-world_size=2", f"-rendezvous_dir={tmp_path}",
                           "-lr_device=cpu"])
    assert rc == 0
    assert len((tmp_path / "pred.txt").read_text().split()) == 400
    w = np.load(tmp_path / "model.npy")
    assert w.shape == (7, 1) and np.isfinite(w).all()
