"""Port parity: the DLRM model, its stream and metrics, the online loop
and ``dlrm_main`` (``multiverso_tpu_torch.models.dlrm``, ``.recsys``) on
the CPU, against the JAX package.

Mirrors ``tests/test_dlrm.py``. The forward, loss and gradients are held
against JAX's ``make_forward`` and ``_make_loss`` under
``jax.value_and_grad`` within ``RTOL``/``ATOL`` (float32 matrix products
and reductions in another order). The JAX store's stateful row Add raises
on this tree's jax (ROADMAP C1), so JAX ``DLRMModel.step`` is never the
oracle for the embedding pushes: they are held BITWISE against the
reference's pure row functions (``combine_duplicate_rows``,
``Updater.rows_math``) on the port's own deltas. PS-vs-local parity is
bitwise inside the port, as the JAX contract asks. The stream and the
AUC metrics are numpy in both packages and compared exactly.
"""

import json
import math

import numpy as np
import pytest

import _torch_port
import jax
import jax.numpy as jnp

from multiverso_tpu.core import updater as jupd
from multiverso_tpu.models.dlrm import metrics as jmetrics
from multiverso_tpu.models.dlrm import model as jmodel
from multiverso_tpu.models.dlrm import stream as jstream

RTOL, ATOL = 1e-5, 1e-6

mvt = tdlrm = torch = None  # set by _load_port

_SMALL = dict(fields=3, vocab=64, embed_dim=8, dense_dim=4,
              bottom_mlp=(8,), top_mlp=(8,))


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tdlrm, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.models import dlrm as tdlrm


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    reset_telemetry()


@pytest.fixture
def port():
    mvt.init(["-platform=cpu"])
    yield mvt
    mvt.shutdown()


def _cfgs(**over):
    kw = dict(_SMALL, **over)
    return jmodel.DLRMConfig(**kw), tdlrm.DLRMConfig(**kw)


def _inputs(cfg, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(batch, cfg.fields, cfg.embed_dim)) \
        .astype(np.float32)
    dense = rng.normal(size=(batch, cfg.dense_dim)).astype(np.float32)
    y = (rng.random(batch) < 0.4).astype(np.float32)
    return emb, dense, y


def _stream_cfgs(cfg, **over):
    kw = dict(fields=cfg.fields, vocab=cfg.vocab, dense_dim=cfg.dense_dim,
              zipf=1.3, seed=1, drift_every=0)
    kw.update(over)
    return jstream.StreamConfig(**kw), tdlrm.StreamConfig(**kw)


# -- the model's math against JAX ---------------------------------------------

def test_dense_init_and_flatten_match_jax():
    jc, tc = _cfgs(bottom_mlp=(16, 8), top_mlp=(12,))
    jp, tp = jmodel.init_dense_params(jc), tdlrm.init_dense_params(tc)
    assert len(jp) == len(tp) == len(jc.layer_dims())
    vec = jmodel.flatten_dense(jp)
    assert np.array_equal(vec, tdlrm.flatten_dense(tp))
    assert vec.size == tdlrm.dense_param_count(tc)
    back = tdlrm.unflatten_dense(tc, vec)
    for (W, b), (W2, b2) in zip(tp, back):
        assert torch.equal(W, W2) and torch.equal(b, b2)
    with pytest.raises(ValueError):
        tdlrm.unflatten_dense(tc, vec[:-1])


@pytest.mark.parametrize("shape", [dict(), dict(fields=5, bottom_mlp=(16, 8),
                                                top_mlp=(12, 6))])
def test_forward_loss_and_grads_match_jax(shape):
    """Logits, loss, scores and the gradients of the dense params and the
    embedding rows within RTOL/ATOL of JAX's ``value_and_grad``."""
    jc, tc = _cfgs(**shape)
    emb, dense, y = _inputs(jc)
    jp = jmodel.init_dense_params(jc)
    jloss = jmodel._make_loss(jc)
    (jl, jsc), (jgp, jge) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(emb),
                                             jnp.asarray(dense),
                                             jnp.asarray(y))
    logits_j = jmodel.make_forward(jc)(jp, jnp.asarray(emb),
                                       jnp.asarray(dense))

    tp = tdlrm.init_dense_params(tc, torch.device("cpu"))
    leaves = [t.clone().requires_grad_(True) for W, b in tp for t in (W, b)]
    te = torch.tensor(emb, requires_grad=True)
    pairs = list(zip(leaves[0::2], leaves[1::2]))
    tl, tsc = tdlrm.model._make_loss(tc)(pairs, te, torch.tensor(dense),
                                         torch.tensor(y))
    grads = torch.autograd.grad(tl, leaves + [te])
    logits_t = tdlrm.make_forward(tc)(tp, torch.tensor(emb),
                                      torch.tensor(dense))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tsc.detach().numpy(), np.asarray(jsc),
                               rtol=RTOL, atol=ATOL)
    jflat = [np.asarray(t) for W, b in jgp for t in (W, b)]
    for g, want in zip(grads[:-1], jflat):
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jge),
                               rtol=RTOL, atol=ATOL)


def test_snapshot_scorer_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(3)
    vec = jmodel.flatten_dense(jmodel.init_dense_params(jc))
    tables = [rng.normal(size=(jc.vocab, jc.embed_dim)).astype(np.float32)
              for _ in range(jc.fields)]
    ids = rng.integers(0, jc.vocab, size=(12, jc.fields)).astype(np.int32)
    dense = rng.normal(size=(12, jc.dense_dim)).astype(np.float32)
    want = jmodel.SnapshotScorer(jc, vec, lambda f, i: tables[f][i]) \
        .scores(ids, dense)
    got = tdlrm.SnapshotScorer(tc, vec, lambda f, i: tables[f][i],
                               device=torch.device("cpu")).scores(ids, dense)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _table_rows(model):
    return [model.tables[f].get() if model.mode == "ps"
            else model.local_rows(f) for f in range(model.cfg.fields)]


def test_pushes_match_reference_row_functions(port):
    """One PS step with duplicate ids (Zipf 1.3): each field's table and
    AdaGrad state equal the reference's ``combine_duplicate_rows`` and
    ``rows_math`` applied to the port's own embedding deltas, bitwise."""
    _, cfg = _cfgs()
    model = tdlrm.DLRMModel(cfg, mode="ps")
    _, scfg = _stream_cfgs(cfg)
    b = tdlrm.ImpressionStream(scfg).batch(32)
    before = _table_rows(model)
    g2 = [model.tables[f].store.state["g2"].numpy().copy()
          for f in range(cfg.fields)]
    ids_t = torch.as_tensor(b.ids.astype(np.int64))
    emb = model._gather(ids_t)
    _, demb, _, _ = model._delta(emb, torch.tensor(b.dense),
                                 torch.tensor(b.labels))
    model.step(b.ids, b.dense, b.labels)
    j_up = jupd._REGISTRY["adagrad"]()
    opt = model._add_option.scalars()
    for f in range(cfg.fields):
        assert len(np.unique(b.ids[:, f])) < len(b.ids)   # duplicates
        data, state = before[f].copy(), g2[f].copy()
        r_eff, d_c = (np.asarray(a) for a in jupd.combine_duplicate_rows(
            jnp.asarray(b.ids[:, f]), jnp.asarray(demb[:, f].numpy()),
            cfg.vocab))
        keep = r_eff < cfg.vocab
        clip = np.minimum(r_eff, cfg.vocab - 1)
        nd, ns = j_up.rows_math(jnp.asarray(data[clip]),
                                {"g2": jnp.asarray(state[0][clip])},
                                jnp.asarray(d_c), opt)
        data[r_eff[keep]] = np.asarray(nd)[keep]
        state[0][r_eff[keep]] = np.asarray(ns["g2"])[keep]
        assert np.array_equal(model.tables[f].get(), data), f
        assert np.array_equal(model.tables[f].store.state["g2"].numpy(),
                              state), f


def _run_parity(steps=4, batch=16, device=None):
    """PS model and local twin on identical impression sequences: every
    observable bitwise equal (the JAX contract, inside the port)."""
    _, cfg = _cfgs()
    _, scfg = _stream_cfgs(cfg)
    ps = tdlrm.DLRMModel(cfg, mode="ps")
    local = tdlrm.DLRMModel(cfg, mode="local", device=device)
    s_ps, s_lo = tdlrm.ImpressionStream(scfg), tdlrm.ImpressionStream(scfg)
    for i in range(steps):
        b_ps, b_lo = s_ps.batch(batch), s_lo.batch(batch)
        loss_ps, sc_ps = ps.step(b_ps.ids, b_ps.dense, b_ps.labels)
        loss_lo, sc_lo = local.step(b_lo.ids, b_lo.dense, b_lo.labels)
        assert loss_ps == loss_lo, (i, loss_ps, loss_lo)
        assert np.array_equal(sc_ps, sc_lo), i
    all_rows = np.arange(cfg.vocab, dtype=np.int32)
    for f in range(cfg.fields):
        assert np.array_equal(ps.tables[f].get_rows(all_rows),
                              local.local_rows(f)), f
        assert torch.equal(ps.tables[f].store.state["g2"].cpu(),
                           local._emb_state[f]["g2"].cpu()), f
    for (w_ps, b_ps_), (w_lo, b_lo_) in zip(ps.dense_params,
                                            local.dense_params):
        assert torch.equal(w_ps, w_lo) and torch.equal(b_ps_, b_lo_)
    # predict and the published dense row agree too
    b = s_ps.batch(batch)
    assert np.array_equal(ps.predict(b.ids, b.dense),
                          local.predict(b.ids, b.dense))
    ps.sync()
    assert np.array_equal(ps.dense_table.get()[0],
                          tdlrm.flatten_dense(local.dense_params))


def test_ps_local_bitwise_parity(port):
    _run_parity()


def test_ps_local_parity_under_state_sharding_needs_a10():
    """The JAX test runs the parity with the AdaGrad state sharded over a
    mesh; the port keeps each table whole on one card, so
    ``-state_sharding=on`` refuses the embedding tables (ROADMAP A10)
    instead of silently not sharding."""
    mvt.init(["-platform=cpu", "-state_sharding=on"])
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tdlrm.DLRMModel(tdlrm.DLRMConfig(**_SMALL), mode="ps")


def test_dp_mesh_of_one_rank_is_the_plain_step(port):
    """The dense merge over a data-parallel rank mesh axis: at one rank
    it is the identity, so the steps are bitwise those without a mesh."""
    from multiverso_tpu_torch.core.zoo import Zoo
    _, cfg = _cfgs()
    _, scfg = _stream_cfgs(cfg)
    plain = tdlrm.DLRMModel(cfg, mode="local")
    dp = tdlrm.DLRMModel(cfg, mode="local", dp_mesh=Zoo.get().mesh,
                         dp_axis="server")
    s_a, s_b = tdlrm.ImpressionStream(scfg), tdlrm.ImpressionStream(scfg)
    for _ in range(3):
        a, b = s_a.batch(16), s_b.batch(16)
        assert plain.step(a.ids, a.dense, a.labels)[0] == \
            dp.step(b.ids, b.dense, b.labels)[0]
    for (w_a, b_a), (w_b, b_b) in zip(plain.dense_params, dp.dense_params):
        assert torch.equal(w_a, w_b) and torch.equal(b_a, b_b)


def test_ps_local_bitwise_parity_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fold kernel under the combine")
    mvt.init([])
    _run_parity(device=torch.device("cuda", 0))


def test_comm_policy_of_the_tables(port):
    from multiverso_tpu_torch.parallel import comm_policy as cp
    from multiverso_tpu_torch.telemetry import get_registry
    model = tdlrm.DLRMModel(tdlrm.DLRMConfig(**_SMALL), mode="ps")
    assert model.dense_table.comm_policy == "allreduce"
    assert all(t.comm_policy == "ps" for t in model.tables)
    reg = get_registry()
    assert reg.counter("comm.allreduce.ops").value >= 1   # the publish
    b = tdlrm.ImpressionStream(_stream_cfgs(model.cfg)[1]).batch(8)
    ops = reg.counter("comm.ps.ops").value
    model.step(b.ids, b.dense, b.labels)
    assert reg.counter("comm.ps.ops").value > ops
    x = torch.arange(4.0)
    assert torch.equal(cp.build_dense_sync(None)(x), x)
    # "auto" resolves: a sparse-shaped table stays on ps unprobed.
    assert mvt.create_table(mvt.MatrixTableOption(
        cp.SPARSE_ROWS_MIN, 4, comm_policy="auto")).comm_policy == "ps"
    with pytest.raises(ValueError):
        mvt.create_table(mvt.MatrixTableOption(4, 4, comm_policy="bogus"))


# -- stream and metrics: numpy in both packages ---------------------------------

@pytest.mark.parametrize("over", [dict(), dict(zipf=0.9, drift_every=40)])
def test_stream_batches_equal_jax(over):
    jc, _ = _cfgs()
    js, ts = _stream_cfgs(jc, **over)
    a, b = jstream.ImpressionStream(js), tdlrm.ImpressionStream(ts)
    for n in (16, 33, 64):
        x, y = a.batch(n), b.batch(n)
        for k in ("ids", "dense", "labels", "p"):
            assert np.array_equal(getattr(x, k), getattr(y, k)), k
        assert np.array_equal(a.key_batch(9), b.key_batch(9))
    assert (a.drifts, a.impressions) == (b.drifts, b.impressions)


def test_streaming_auc_tracks_exact():
    rng = np.random.default_rng(7)
    scores = rng.random(4000)
    labels = (rng.random(4000) < scores).astype(np.float32)
    want = tdlrm.exact_auc(scores, labels)
    assert want == jmetrics.exact_auc(scores, labels)
    auc, jauc = tdlrm.StreamingAUC(bins=2048), jmetrics.StreamingAUC(2048)
    for i in range(0, len(scores), 500):
        auc.update(scores[i:i + 500], labels[i:i + 500])
        jauc.update(scores[i:i + 500], labels[i:i + 500])
    assert auc.value() == jauc.value()
    assert abs(auc.value() - want) < 2e-3, (auc.value(), want)
    assert auc.positives + auc.negatives == 4000


def test_streaming_auc_edges():
    auc = tdlrm.StreamingAUC(bins=64)
    assert math.isnan(auc.value())
    auc.update(np.array([0.9, 0.8]), np.array([1.0, 1.0]))
    assert math.isnan(auc.value())
    auc = tdlrm.StreamingAUC(bins=64)
    auc.update(np.array([0.1, 0.2, 0.8, 0.9]), np.array([0.0, 0.0, 1.0, 1.0]))
    assert auc.value() == pytest.approx(1.0)
    auc = tdlrm.StreamingAUC(bins=64)
    auc.update(np.array([0.8, 0.9, 0.1, 0.2]), np.array([0.0, 0.0, 1.0, 1.0]))
    assert auc.value() == pytest.approx(0.0)
    other = tdlrm.StreamingAUC(bins=64)
    other.update(np.array([0.5]), np.array([1.0]))
    assert auc.merge(other).positives == 3
    with pytest.raises(ValueError):
        tdlrm.StreamingAUC(bins=1)


# -- serving during training, the online loop, the CLI --------------------------

def test_serve_during_train_staleness_bound():
    """BSP-clocked live serving: a staleness-1 cache may serve rows one
    training tick old, but once the clock advances past the bound the
    runner refetches, and the refetched bytes are the TRAINED rows."""
    from multiverso_tpu_torch.serving.cache import HotRowCache
    rows, cols = 32, 4
    mvt.init(["-platform=cpu", "-sync=true"], num_local_workers=2)
    table = mvt.create_table(mvt.MatrixTableOption(
        num_row=rows, num_col=cols, random_init=True, seed=5,
        updater="adagrad", name="stale_bound", comm_policy="ps"))
    cache = HotRowCache(16, staleness=1)
    runner = table.serving_runner(cache=cache)
    plain = table.serving_runner()
    keys = np.arange(8, dtype=np.int32)
    batch, lengths = keys[None, :], np.array([8])

    def serve():
        return runner.slice_result(runner.run(batch, lengths), 0, 8)

    def fresh():
        return plain.slice_result(plain.run(batch, lengths), 0, 8)

    def train_tick(value):
        delta = np.full((len(keys), cols), value, np.float32)
        for w in range(2):
            table.add_rows(keys, delta, mvt.AddOption(
                worker_id=w, learning_rate=0.1, rho=0.1))

    v0 = serve().copy()
    assert runner.try_cached(keys) is not None
    train_tick(0.5)
    hit = runner.try_cached(keys)
    assert hit is not None and np.array_equal(hit, v0)
    train_tick(0.5)
    assert runner.try_cached(keys) is None
    v2 = serve()
    assert not np.array_equal(v2, v0)
    assert np.array_equal(v2, fresh())
    assert np.array_equal(v2, table.get_rows(keys))
    hit = runner.try_cached(keys)
    assert hit is not None and np.array_equal(hit, v2)


def test_online_loop_lanes_report(port, tmp_path):
    """A short train-while-serve run: every publish checkpoints and the
    follower swaps, every lane scores the same impressions, the serve
    load answers every lookup, and staleness costs AUC under drift."""
    from multiverso_tpu_torch.recsys import (OnlineConfig, OnlineLoop,
                                             ServeLoad, make_live_runner)
    cfg = tdlrm.DLRMConfig(fields=3, vocab=256, embed_dim=8, dense_dim=4,
                           bottom_mlp=(8,), top_mlp=(8,))
    scfg = tdlrm.StreamConfig(fields=3, vocab=256, dense_dim=4, zipf=1.2,
                              drift_every=1000, drift_scale=0.3, seed=0)
    model = tdlrm.DLRMModel(cfg, mode="ps")
    loop = OnlineLoop(model, tdlrm.ImpressionStream(scfg), str(tmp_path),
                      OnlineConfig(steps=120, batch=64, publish_every=20,
                                   eval_every=2, lanes=(1, 4)))
    runner = make_live_runner(model, field=0, cache_rows=64,
                              cache_staleness=1)
    load = ServeLoad(runner, vocab=cfg.vocab, qps=400.0, keys_per_req=8,
                     max_batch=4).start()
    try:
        summary = loop.run()
    finally:
        serve = load.stop()
    assert summary["publishes"] == 1 + 120 // 20
    assert summary["examples"] == 120 * 64
    lanes = {r["lane"]: r for r in summary["freshness"]}
    assert set(lanes) == {"fresh", "s1", "s4", "frozen"}
    assert all(r["n"] == 60 * 64 for r in lanes.values())
    assert all(np.isfinite(r["auc"]) for r in lanes.values())
    assert lanes["fresh"]["auc"] > lanes["frozen"]["auc"]
    assert serve["errors"] == 0 and serve["requests"] > 0
    assert np.isfinite(summary["final_loss"])


def test_dlrm_main_on_cpu(tmp_path):
    from multiverso_tpu_torch.apps import dlrm_main
    out = tmp_path / "s.json"
    rc = dlrm_main.main([
        "-dlrm_steps=60", "-dlrm_batch=32", "-dlrm_vocab=128",
        "-dlrm_fields=2", "-dlrm_publish_every=20", "-dlrm_serve_qps=200",
        "-dlrm_cache_rows=32", "-dlrm_cache_staleness=1",
        f"-dlrm_ckpt_dir={tmp_path / 'ck'}",
        f"-dlrm_summary_file={out}", "-dlrm_device=cpu"])
    assert rc == 0
    summary = json.loads(out.read_text())
    assert summary["steps"] == 60 and summary["publishes"] == 4
    assert summary["serve"]["errors"] == 0
    assert [r["lane"] for r in summary["freshness"]] == \
        ["fresh", "s1", "s4", "frozen"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[-1] == \
        "ckpt_000000000060"
