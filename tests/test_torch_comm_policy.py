"""Per-table CommPolicy in the port, case by case against
``tests/test_comm_policy.py`` (the JAX package at one process).

Each case of the JAX file has its mirror here, in the same order: the
resolver's decision table, the probe's argmin and cache, the decision
evidence, the per-plane counters, the dense merge, the tables' policy
attribute and publish, the logreg planes (allreduce bitwise its own ps
path, model average's loss trajectory, FTRL pinned to ps), and the
word2vec planes (hybrid and model average bitwise the port's fused plane,
hybrid overrides, allreduce rejected, the ps plane). Where a case also
holds the port against the JAX package, its tolerance is stated: logreg
within rtol 1e-5 / atol 1e-6 (``tests/test_torch_logreg.py``), word2vec's
host path within rtol 1e-5 / atol 1e-6 (``tests/test_torch_word2vec_
variants.py``), model average's losses within rtol 1e-4 (the JAX test's).
The port's device pipeline draws its own random numbers, so the bitwise
cases compare it with itself, and the JAX comparisons run the host batch
path, whose batches both packages build from the same numpy seeds.
"""

import numpy as np
import pytest

import _torch_port
import jax

import multiverso_tpu as mvj

mvt = cp = None   # set by _load_port
LR_TOL = dict(rtol=1e-5, atol=1e-6)
W2V_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, cp
    _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.parallel import comm_policy as cp


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


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()


def _counters():
    from multiverso_tpu_torch.telemetry import get_registry
    return get_registry().snapshot(buckets=False)


# -- resolver units ----------------------------------------------------------
def test_resolve_sparse_and_hbm_scale_pick_ps(both):
    from multiverso_tpu.parallel import comm_policy as jcp
    for kw in (dict(shape=(50_000, 128), sparse=True),
               dict(shape=(1_000_000, 128), sparse=False, probe=False)):
        shape = kw.pop("shape")
        assert cp.resolve_comm_policy(shape, np.float32, **kw) == cp.PS
        assert jcp.resolve_comm_policy(shape, np.float32, **kw) == jcp.PS


def test_resolve_explicit_override_wins(port):
    from multiverso_tpu_torch.utils.log import FatalError
    assert cp.resolve_comm_policy((50_000, 128), np.float32, sparse=True,
                                  explicit=cp.MODEL_AVERAGE) \
        == cp.MODEL_AVERAGE
    assert cp.resolve_comm_policy((8,), np.float32,
                                  explicit=cp.PS) == cp.PS
    with pytest.raises(FatalError):
        cp.resolve_comm_policy((8,), np.float32, explicit="bogus")


def test_resolve_small_dense_follows_probe_and_caches(port):
    """AUTO's small-dense pick is the argmin of its own measurement, taken
    on this process's device, and the measurement is one-shot."""
    from multiverso_tpu_torch.core.zoo import Zoo
    mesh = Zoo.get().mesh
    lat = cp.measured_policy_latency_ms(256, mesh, world=1)
    assert lat["device"] == "cpu" and lat["world"] == 1
    assert lat[cp.PS] > 0 and lat[cp.ALLREDUCE] > 0
    want = cp.PS if lat[cp.PS] < lat[cp.ALLREDUCE] else cp.ALLREDUCE
    got = cp.resolve_comm_policy((64,), np.float32, sparse=False,
                                 mesh=mesh, world=1, table="probe_case")
    assert got == want
    assert cp.measured_policy_latency_ms(256, mesh, world=1) is lat


def test_decision_evidence_records_reasons(port):
    cp.reset_decisions()
    cp.resolve_comm_policy((9, 9), np.float32, sparse=True, table="t_sp")
    ev = cp.decision_evidence()
    mine = [d for d in ev["decisions"] if d["table"] == "t_sp"]
    assert mine and mine[0]["policy"] == cp.PS
    assert "sparse" in mine[0]["reason"]
    cp.resolve_comm_policy((5,), np.float32, table="t_probe")
    mine = [d for d in cp.decision_evidence()["decisions"]
            if d["table"] == "t_probe"]
    assert set(mine[0]["probe_ms"]) == {cp.PS, cp.ALLREDUCE}
    assert _counters()["counters"]["comm.policy.resolve.ps"]["value"] >= 1


def test_record_ticks_per_plane_counters(port):
    cp.record(cp.ALLREDUCE, 1234, 0.5)
    snap = _counters()
    assert snap["counters"]["comm.allreduce.bytes"]["value"] >= 1234
    assert snap["counters"]["comm.allreduce.ops"]["value"] >= 1
    assert "comm.allreduce.latency_ms" in snap["histograms"]


def test_dense_sync_preserves_value_on_mesh():
    """The JAX test's ``psum / 8`` of a replicated operand over its
    8-device mesh is bitwise the input; the port's merge over its
    one-rank mesh is the identity ``x + 0.0``, bitwise both."""
    import torch
    from multiverso_tpu.core.zoo import Zoo as JaxZoo
    from multiverso_tpu.parallel import comm_policy as jcp
    from multiverso_tpu_torch.core.zoo import Zoo
    x = np.asarray([3.0, 0.125, 17.5, 1e-3], np.float32)
    mvj.init([])
    try:
        want = np.asarray(jcp.build_dense_sync(JaxZoo.get().mesh)(x))
    finally:
        mvj.shutdown()
    assert np.array_equal(want, x)
    mvt.init(["-platform=cpu"])
    out = cp.build_dense_sync(Zoo.get().mesh)(torch.as_tensor(x))
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(cp.build_dense_sync(None)(torch.as_tensor(x))
                          .numpy(), x)


# -- routed tables -----------------------------------------------------------
def test_table_policy_attribute_and_publish(port):
    t = mvt.create_table(mvt.MatrixTableOption(32, 4, name="cpol_default"))
    assert t.comm_policy == cp.PS       # None -> ps, no probe
    t2 = mvt.create_table(mvt.MatrixTableOption(
        32, 4, name="cpol_explicit", comm_policy="model_average"))
    assert t2.comm_policy == cp.MODEL_AVERAGE
    t2.add_rows([0, 1], np.ones((2, 4), np.float32))
    got = t2.get_rows([0, 1])
    assert np.array_equal(got, np.ones((2, 4), np.float32))
    snap = _counters()
    assert snap["counters"]["comm.ps.bytes"]["value"] > 0
    assert snap["counters"]["comm.policy.ps_fallback"]["value"] >= 2
    vals = np.full((32, 4), 7.0, np.float32)
    t2.publish(vals)
    assert np.array_equal(t2.get(), vals)
    snap = _counters()
    assert snap["counters"]["comm.model_average.bytes"]["value"] \
        >= vals.nbytes
    # "auto" on a table resolves on its shape: sparse-shaped -> ps.
    t3 = mvt.create_table(mvt.MatrixTableOption(
        cp.SPARSE_ROWS_MIN, 4, name="cpol_auto", comm_policy="auto"))
    assert t3.comm_policy == cp.PS


# -- logreg policy parity ----------------------------------------------------
def _lr_data(F=24, B=16, N=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N * B, F + 1)).astype(np.float32)
    X[:, -1] = 1.0
    w_true = rng.normal(size=(F + 1, 1)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32).ravel()
    return [(X[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(N)], F, B


def test_logreg_allreduce_bitwise_equals_ps(both):
    """The policy moves bytes differently and never moves values: the
    allreduce model's weights are bitwise the PS model's, and the
    published replica equals them; both within rtol 1e-5 / atol 1e-6
    of the JAX package's allreduce model."""
    from multiverso_tpu.models.logreg.logreg import LogReg as JLogReg
    from multiverso_tpu.models.logreg.model import LogRegConfig as JCfg
    from multiverso_tpu.models.logreg.model import make_model as jmake
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.models.logreg.model import (AllreduceModel,
                                                          LogRegConfig,
                                                          PSModel,
                                                          make_model)
    batches, F, B = _lr_data()
    kw = dict(objective="sigmoid", num_feature=F, learning_rate=0.1,
              minibatch_size=B, epochs=3)
    cfg = LogRegConfig(**kw)
    m_ps = PSModel(cfg)
    LogReg(cfg, model=m_ps).train(batches)
    cfg_ar = LogRegConfig(**kw, comm_policy="allreduce")
    m_ar = make_model(cfg_ar)
    assert isinstance(m_ar, AllreduceModel)
    LogReg(cfg_ar, model=m_ar).train(batches)
    assert np.array_equal(m_ps.get_weights(), m_ar.get_weights())
    assert np.array_equal(
        m_ar.table.get().reshape(m_ar.get_weights().shape),
        m_ar.get_weights())
    j_cfg = JCfg(**kw, comm_policy="allreduce")
    j_ar = jmake(j_cfg)
    JLogReg(j_cfg, model=j_ar).train(batches)
    np.testing.assert_allclose(m_ar.get_weights(),
                               np.asarray(j_ar.get_weights()), **LR_TOL)


def test_logreg_allreduce_dp_psum_matches_single(port):
    """At one rank the data-parallel axis has one contributor, so the
    dp model is bitwise the single one (the two-rank mirror of the JAX
    test is ``tests/test_torch_collectives.py``)."""
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.models.logreg.model import (AllreduceModel,
                                                          LogRegConfig)
    batches, F, B = _lr_data(B=16)
    cfg = LogRegConfig(objective="sigmoid", num_feature=F,
                       learning_rate=0.1, minibatch_size=B,
                       comm_policy="allreduce")
    m_dp = AllreduceModel(cfg, dp_mesh=Zoo.get().mesh, dp_axis="server")
    m_s = AllreduceModel(cfg)
    for Xb, yb in batches:
        assert float(m_dp.update(Xb, yb)) == float(m_s.update(Xb, yb))
    assert np.array_equal(m_dp.get_weights(), m_s.get_weights())


def test_logreg_model_average_loss_trajectory_parity(both):
    """model_average changes the merge cadence, not the step: its losses
    track the PS path and the JAX package's model-average run within
    rtol 1e-4."""
    from multiverso_tpu.models.logreg.logreg import LogReg as JLogReg
    from multiverso_tpu.models.logreg.model import LogRegConfig as JCfg
    from multiverso_tpu.models.logreg.model import make_model as jmake
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.models.logreg.model import (LogRegConfig,
                                                          ModelAverageModel,
                                                          PSModel,
                                                          make_model)
    batches, F, B = _lr_data()
    kw = dict(objective="sigmoid", num_feature=F, learning_rate=0.1,
              minibatch_size=B, epochs=3)
    cfg = LogRegConfig(**kw)
    losses_ps = LogReg(cfg, model=PSModel(cfg)).train(batches)
    cfg_ma = LogRegConfig(**kw, comm_policy="model_average")
    m_ma = make_model(cfg_ma)
    assert isinstance(m_ma, ModelAverageModel)
    losses_ma = LogReg(cfg_ma, model=m_ma).train(batches)
    assert np.allclose(losses_ps, losses_ma, rtol=1e-4)
    j_cfg = JCfg(**kw, comm_policy="model_average")
    j_losses = JLogReg(j_cfg, model=jmake(j_cfg)).train(batches)
    np.testing.assert_allclose(losses_ma, j_losses, rtol=1e-4)
    assert np.array_equal(m_ma.table.get().reshape(-1),
                          m_ma.get_weights().reshape(-1))


def test_logreg_ftrl_pins_ps(both):
    from multiverso_tpu.models.logreg.model import LogRegConfig as JCfg
    from multiverso_tpu.models.logreg.model import \
        resolve_logreg_comm_policy as jresolve
    from multiverso_tpu_torch.models.logreg.model import (
        LogRegConfig, resolve_logreg_comm_policy)
    from multiverso_tpu_torch.utils.log import FatalError
    for policy in ("auto", "ps", ""):
        cfg = dict(objective="ftrl", num_feature=4, comm_policy=policy)
        assert resolve_logreg_comm_policy(LogRegConfig(**cfg)) == "ps" \
            == jresolve(JCfg(**cfg))
    with pytest.raises(FatalError):
        resolve_logreg_comm_policy(LogRegConfig(
            objective="ftrl", num_feature=4, comm_policy="allreduce"))


# -- word2vec policy parity --------------------------------------------------
V = 120


def _w2v_corpus(n_sent=24, sent_len=24, seed=0):
    from multiverso_tpu_torch.models.word2vec import Dictionary
    rng = np.random.default_rng(seed)
    d, zipf = Dictionary.synthetic_zipf(V, n_sent * sent_len)
    sents = [rng.choice(V, size=sent_len, p=zipf).astype(np.int32)
             for _ in range(n_sent)]
    return d, sents


def _w2v_kw(**kw):
    base = dict(embedding_size=8, window=3, negative=3, batch_size=64,
                sample=1e-3, sg=True, hs=False, optimizer="adagrad",
                epochs=1, pipeline=False, device_pipeline=True,
                block_sentences=8, pad_sentence_length=32, seed=0)
    base.update(kw)
    return base


def _w2v(**kw):
    from multiverso_tpu_torch.models.word2vec import Word2Vec, Word2VecConfig
    d, _ = _w2v_corpus()
    return Word2Vec(Word2VecConfig(**_w2v_kw(**kw)), d)


def _jax_w2v(**kw):
    from multiverso_tpu.models.word2vec import Dictionary as JDict
    from multiverso_tpu.models.word2vec import Word2Vec as JW2V
    from multiverso_tpu.models.word2vec import Word2VecConfig as JCfg
    d, _ = JDict.synthetic_zipf(V, 24 * 24)
    return JW2V(JCfg(**_w2v_kw(**kw)), d)


TABLES = ("input_table", "output_table", "adagrad_in", "adagrad_out")


def _tables(w):
    return {n: getattr(w, n).get() for n in TABLES}


def test_w2v_hybrid_tables_bitwise_equal_fused(both):
    """Hybrid = the fused plane + the dense merge of the word count: the
    tables are bitwise the fused run's, the merged count equals the host
    count, both planes' counters tick; on the host path the hybrid tables
    are within rtol 1e-5 / atol 1e-6 of the JAX package's hybrid run."""
    _, sents = _w2v_corpus()
    w_f = _w2v()
    assert w_f.comm_mode == "fused"
    w_f.train(sentences=sents)
    emb_f = _tables(w_f)
    w_h = _w2v(comm_policy="auto")
    assert w_h.comm_mode == "hybrid"
    assert w_h.comm_policies["w2v_input"] == "ps"
    assert w_h.input_table.comm_policy == "ps"
    stats = w_h.train(sentences=sents)
    for n, t in _tables(w_h).items():
        assert np.array_equal(emb_f[n], t), n
    assert stats["synced_words"] == stats["words"]
    snap = _counters()
    assert snap["counters"]["comm.ps.bytes"]["value"] > 0
    assert snap["counters"]["comm.allreduce.bytes"]["value"] > 0
    # The host batch path against the JAX package's.
    w_t = _w2v(comm_policy="hybrid", device_pipeline=False,
               block_words=200, scan_group=4)
    w_j = _jax_w2v(comm_policy="hybrid", device_pipeline=False,
                   block_words=200, scan_group=4)
    ts, js = w_t.train(sentences=sents), w_j.train(sentences=sents)
    assert ts["pairs"] == js["pairs"] and ts["words"] == js["words"]
    assert ts["synced_words"] == js["synced_words"] == ts["words"]
    for n, t in _tables(w_t).items():
        np.testing.assert_allclose(t, getattr(w_j, n).get(), err_msg=n,
                                   **W2V_TOL)


def test_w2v_hybrid_override_pins_wordcount_to_ps(port):
    w = _w2v(comm_policy="auto",
             comm_policy_overrides={"w2v_wordcount": "ps"})
    assert w.comm_policies["w2v_wordcount"] == "ps"
    assert w.wordcount_table.comm_policy == "ps"
    assert w._dense_sync is None        # no collective leg configured


def test_w2v_allreduce_mode_rejected(both):
    from multiverso_tpu.utils.log import FatalError as JFatal
    from multiverso_tpu_torch.utils.log import FatalError
    with pytest.raises(FatalError, match="sparse"):
        _w2v(comm_policy="allreduce")
    with pytest.raises(JFatal, match="sparse"):
        _jax_w2v(comm_policy="allreduce")


def test_w2v_ps_plane_trains_and_counts(both):
    """comm_policy=ps: pull-train-push through the table clients; the
    model learns, every parameter byte shows on the ps plane, and the
    tables are within rtol 1e-5 / atol 1e-6 of the JAX package's ps
    plane (the same host batches)."""
    _, sents = _w2v_corpus()
    w = _w2v(comm_policy="ps", device_pipeline=False)
    assert w.comm_mode == "ps"
    stats = w.train(sentences=sents)
    assert stats["comm_mode"] == "ps"
    assert stats["words"] == sum(len(s) for s in sents)
    assert np.isfinite(stats["loss"]) and stats["pairs"] > 0
    emb = w.embeddings()
    assert np.isfinite(emb).all() and np.abs(emb).sum() > 0
    snap = _counters()
    assert snap["counters"]["comm.ps.bytes"]["value"] > emb.nbytes
    assert "comm.ps.latency_ms" in snap["histograms"]
    jw = _jax_w2v(comm_policy="ps", device_pipeline=False)
    js = jw.train(sentences=sents)
    assert js["pairs"] == stats["pairs"]
    for n, t in _tables(w).items():
        np.testing.assert_allclose(t, getattr(jw, n).get(), err_msg=n,
                                   **W2V_TOL)
    np.testing.assert_allclose(stats["loss"], js["loss"], rtol=1e-5)


def test_w2v_model_average_bitwise_equal_fused_one_process(port):
    """At one rank the epoch merge is the mean of one replica: the tables
    are bitwise the fused run's, and the collective plane counts."""
    _, sents = _w2v_corpus()
    w_f = _w2v()
    w_f.train(sentences=sents)
    emb_f = _tables(w_f)
    w_m = _w2v(comm_policy="model_average")
    assert w_m.comm_mode == "model_average"
    w_m.train(sentences=sents)
    for n, t in _tables(w_m).items():
        assert np.array_equal(emb_f[n], t), n
    snap = _counters()
    assert snap["counters"]["comm.model_average.bytes"]["value"] > 0
