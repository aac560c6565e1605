"""Port mirror of ``tests/test_distributed_word2vec.py``: its cases that are
not marked slow, run against ``multiverso_tpu_torch`` with the shards and
the training steps on the CPU (``-platform=cpu``), in one process over
loopback TCP. Cross-package and CLI cases follow the mirrored ones."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import _torch_port

# Set by _load_port.
Dictionary = DistributedWord2Vec = PSService = Word2VecConfig = mv = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global Dictionary, DistributedWord2Vec, PSService, Word2VecConfig, mv
    _torch_port.load_torch()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.word2vec import Dictionary, Word2VecConfig
    from multiverso_tpu_torch.models.word2vec.distributed import (
        DistributedWord2Vec)
    from multiverso_tpu_torch.parallel.ps_service import PSService


def _reset_port():
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()


@pytest.fixture(autouse=True)
def _port_state():
    yield
    _reset_port()


@pytest.fixture
def mv_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu"])
    yield mvt
    _reset_port()


@pytest.fixture
def sync_env():
    import multiverso_tpu_torch as mvt
    mvt.init(["-platform=cpu", "-sync=true"])
    yield mvt
    _reset_port()


def _corpus(n_sentences=400, seed=0):
    rng = np.random.default_rng(seed)
    sentences = []
    for i in range(n_sentences):
        topic = "a" if i % 2 == 0 else "b"
        sentences.append([f"{topic}{rng.integers(0, 5)}" for _ in range(12)])
    return sentences


def test_two_rank_distributed_training(mv_env):
    sents = _corpus()
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    # SGD path: with a 10-word toy vocab each word recurs ~30x per batch,
    # so the summed per-batch gradient needs a small lr (adagrad
    # self-normalizes this away; see the adagrad test below).
    cfg = Word2VecConfig(embedding_size=32, batch_size=256, window=4,
                         negative=5, min_count=1, sample=0, sg=True,
                         epochs=4, learning_rate=0.005, block_words=2000,
                         pipeline=False, seed=3, optimizer="sgd")

    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)

        # Each worker trains on half the corpus, concurrently (ASGD).
        threads = [
            threading.Thread(target=w0.train, args=(ids[0::2],)),
            threading.Thread(target=w1.train, args=(ids[1::2],)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "distributed training hung"

        emb = w0.embeddings()
        assert emb.shape == (len(d), 32)
        emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        a_ids = [d.word2id[w] for w in d.words if w.startswith("a")]
        b_ids = [d.word2id[w] for w in d.words if w.startswith("b")]
        intra = np.mean([emb[i] @ emb[j]
                         for i in a_ids for j in a_ids if i != j])
        inter = np.mean([emb[i] @ emb[j] for i in a_ids for j in b_ids])
        assert intra > inter + 0.1, f"intra={intra:.3f} inter={inter:.3f}"
        # Both ranks see the same global table.
        np.testing.assert_allclose(w1.embeddings(), w0.embeddings(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        svc0.close()
        svc1.close()


def test_two_rank_distributed_adagrad(mv_env):
    """AdaGrad mode: accumulators live in their own PS tables (the
    reference's two adagrad matrices) and workers push unscaled squared
    gradients."""
    sents = _corpus(300)
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=32, batch_size=256, window=4,
                         negative=5, min_count=1, sample=0, sg=True,
                         epochs=3, learning_rate=0.1, block_words=2000,
                         pipeline=False, seed=3, optimizer="adagrad")
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)
        threads = [
            threading.Thread(target=w0.train, args=(ids[0::2],)),
            threading.Thread(target=w1.train, args=(ids[1::2],)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        emb = w0.embeddings()
        emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        a_ids = [d.word2id[w] for w in d.words if w.startswith("a")]
        b_ids = [d.word2id[w] for w in d.words if w.startswith("b")]
        intra = np.mean([emb[i] @ emb[j]
                         for i in a_ids for j in a_ids if i != j])
        inter = np.mean([emb[i] @ emb[j] for i in a_ids for j in b_ids])
        assert intra > inter + 0.1, f"intra={intra:.3f} inter={inter:.3f}"
        # accumulators actually accumulated on the PS
        g = w0.g_in.get_rows(np.arange(len(d), dtype=np.int32))
        assert g.sum() > 0
    finally:
        svc0.close()
        svc1.close()


@pytest.mark.parametrize("sg,hs", [(True, True), (False, False),
                                   (False, True)])
def test_distributed_variants_smoke(mv_env, sg, hs):
    """HS and CBOW distributed modes train without NaNs and update both
    tables (sg+ns is covered by the convergence tests above)."""
    sents = _corpus(80)
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=16, batch_size=128, window=3,
                         negative=3, min_count=1, sample=0, sg=sg, hs=hs,
                         epochs=1, learning_rate=0.05, block_words=500,
                         pipeline=False, seed=1, optimizer="adagrad")
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)
        w0.train(ids[0::2])
        w1.train(ids[1::2])
        emb = w0.embeddings()
        assert np.isfinite(emb).all()
        out_rows = (len(d) - 1) if hs else len(d)
        out = w0.w_out.get_rows(np.arange(out_rows, dtype=np.int32))
        assert np.abs(out).sum() > 0      # output table actually trained
        np.testing.assert_allclose(w1.embeddings(), emb, rtol=1e-5,
                                   atol=1e-6)
    finally:
        svc0.close()
        svc1.close()


def test_global_lr_schedule_matches_single_rank(mv_env):
    """SGD lr decays on the GLOBAL word count pulled from
    the word-count table (distributed_wordembedding.cpp:92-134). Two ranks
    each training half the corpus must drive the schedule to its END — the
    rank-local bug left lr at (1 - 1/N) of the schedule."""
    sents = _corpus(200)
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=8, batch_size=128, window=3,
                         negative=3, min_count=1, sample=0, sg=True,
                         epochs=1, learning_rate=0.05, block_words=300,
                         pipeline=False, seed=1, optimizer="sgd")

    # single-rank run over the FULL corpus: the trajectory to match
    svc = PSService()
    w_single = DistributedWord2Vec(cfg, d, svc, [svc.address], rank=0)
    w_single.train(ids)
    lr_single_final = w_single._current_lr()
    svc.close()

    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)
        threads = [threading.Thread(target=w0.train, args=(ids[0::2],)),
                   threading.Thread(target=w1.train, args=(ids[1::2],))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        # both ranks pulled the drained global count
        w0._sync_word_count(); w1._sync_word_count()
        total = sum(len(s) for s in ids)
        assert w0.global_trained_words == pytest.approx(total)
        assert w1.global_trained_words == pytest.approx(total)
        # each rank's final lr matches the single-rank schedule end,
        # NOT the (1 - 1/2) point the rank-local count produced
        lr_half = cfg.learning_rate * 0.5
        for w in (w0, w1):
            assert w._current_lr() == pytest.approx(lr_single_final,
                                                    rel=0.05)
            assert w._current_lr() < lr_half * 0.5
    finally:
        svc0.close()
        svc1.close()


def test_two_rank_sparse_tables_train_and_save_wire(mv_env):
    """sparse_tables=True: pulls become incremental (keyed
    UpdateGetState) — training still separates topics, both ranks agree,
    and the wire ships fewer rows than the request volume (frequent words
    serve from the worker cache when unwritten since the last pull)."""
    sents = _corpus()
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=32, batch_size=256, window=4,
                         negative=5, min_count=1, sample=0, sg=True,
                         epochs=4, learning_rate=0.005, block_words=500,
                         pipeline=False, seed=3, optimizer="sgd")

    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0,
                                 sparse_tables=True)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1,
                                 sparse_tables=True)
        requested = [0]
        shipped = [0]
        orig = w0.w_in.get_rows

        def spy(rows, option=None):
            out = orig(rows, option)
            if option is not None:
                requested[0] += len(np.unique(np.asarray(rows)))
                shipped[0] += w0.w_in.last_incremental_rows
            return out

        w0.w_in.get_rows = spy
        threads = [
            threading.Thread(target=w0.train, args=(ids[0::2],)),
            threading.Thread(target=w1.train, args=(ids[1::2],)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "sparse distributed training hung"

        assert requested[0] > 0
        # Incremental pulls must beat re-shipping every requested row.
        assert shipped[0] < requested[0], (shipped, requested)

        emb = w0.embeddings()
        emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        a_ids = [d.word2id[w] for w in d.words if w.startswith("a")]
        b_ids = [d.word2id[w] for w in d.words if w.startswith("b")]
        intra = np.mean([emb[i] @ emb[j]
                         for i in a_ids for j in a_ids if i != j])
        inter = np.mean([emb[i] @ emb[j] for i in a_ids for j in b_ids])
        assert intra > inter + 0.1, f"intra={intra:.3f} inter={inter:.3f}"
        np.testing.assert_allclose(w1.embeddings(), w0.embeddings(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        svc0.close()
        svc1.close()


# ---------------------------------------------------------------------------
# App-level fault drills: kill a worker PROCESS mid-epoch.
# The reference's only straggler handling is Server_Finish_Train clock
# retirement (src/server.cpp:190-213); these drills prove the end-to-end
# story — re-admission in async mode, finish_train drain in BSP — at the
# application level, not just the table level (tests/test_ps_robustness.py).
# ---------------------------------------------------------------------------


def test_two_rank_param_prefetch_pipeline(mv_env):
    """param_prefetch=True: block N+1's pulls are in flight while block N
    computes (the reference's is_pipeline double buffer). Views are one
    block stale by design — training must still separate topics and both
    ranks converge to the same table."""
    sents = _corpus(300)
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=32, batch_size=256, window=4,
                         negative=5, min_count=1, sample=0, sg=True,
                         epochs=3, learning_rate=0.1, block_words=500,
                         pipeline=False, seed=3, optimizer="adagrad",
                         param_prefetch=True)
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)
        threads = [
            threading.Thread(target=w0.train, args=(ids[0::2],)),
            threading.Thread(target=w1.train, args=(ids[1::2],)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "prefetch training hung"
        # small blocks -> the double buffer actually cycled many times
        assert w0.trained_words == sum(len(s) for s in ids[0::2]) * 3
        emb = w0.embeddings()
        emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        a_ids = [d.word2id[w] for w in d.words if w.startswith("a")]
        b_ids = [d.word2id[w] for w in d.words if w.startswith("b")]
        intra = np.mean([emb[i] @ emb[j]
                         for i in a_ids for j in a_ids if i != j])
        inter = np.mean([emb[i] @ emb[j] for i in a_ids for j in b_ids])
        assert intra > inter + 0.1, f"intra={intra:.3f} inter={inter:.3f}"
        np.testing.assert_allclose(w1.embeddings(), w0.embeddings(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        svc0.close()
        svc1.close()


def test_two_rank_distributed_bf16_wire(mv_env):
    """-wire_compression=bf16: every pull/push crosses the wire as bf16
    halves (half the DCN bytes of f32) and training still separates
    topics — the distributed leg of the bf16 data-path story."""
    from multiverso_tpu_torch.utils.configure import set_flag

    sents = _corpus(300)
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=32, batch_size=256, window=4,
                         negative=5, min_count=1, sample=0, sg=True,
                         epochs=3, learning_rate=0.1, block_words=2000,
                         pipeline=False, seed=3, optimizer="adagrad")
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    set_flag("wire_compression", "bf16")
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)
        threads = [
            threading.Thread(target=w0.train, args=(ids[0::2],)),
            threading.Thread(target=w1.train, args=(ids[1::2],)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        emb = w0.embeddings()
        assert np.isfinite(emb).all()
        emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        a_ids = [d.word2id[w] for w in d.words if w.startswith("a")]
        b_ids = [d.word2id[w] for w in d.words if w.startswith("b")]
        intra = np.mean([emb[i] @ emb[j]
                         for i in a_ids for j in a_ids if i != j])
        inter = np.mean([emb[i] @ emb[j] for i in a_ids for j in b_ids])
        assert intra > inter + 0.1, f"intra={intra:.3f} inter={inter:.3f}"
    finally:
        set_flag("wire_compression", "sparse")
        svc0.close()
        svc1.close()


# -- against the JAX package --------------------------------------------------
# One rank, the same corpus, config and seed through the JAX
# DistributedWord2Vec (its jitted lax.scan over the group) and the port's
# (the plain steps in order, in place): the pairs, negatives and pulled
# row sets are the same numpy arrays; the sigmoid, log and the dot
# products' sums round differently in XLA and torch, and each block's
# pushed delta carries that difference into the next block's pull, so the
# embeddings are held within W2V_RTOL of the largest value.
W2V_RTOL = 1e-5


@pytest.mark.parametrize("sg,hs,opt", [(True, False, "adagrad"),
                                       (True, False, "sgd"),
                                       (False, True, "adagrad")])
def test_one_rank_matches_jax(sg, hs, opt):
    import jax
    import multiverso_tpu as mvj
    from multiverso_tpu.models.word2vec import (Dictionary as JDictionary,
                                                Word2VecConfig as JConfig)
    from multiverso_tpu.models.word2vec.distributed import \
        DistributedWord2Vec as JDistributed
    from multiverso_tpu.parallel.ps_service import PSService as JPSService

    sents = _corpus(160, seed=5)
    kw = dict(embedding_size=16, batch_size=128, window=3, negative=3,
              min_count=1, sample=0, sg=sg, hs=hs, epochs=2,
              learning_rate=0.05, block_words=400, pipeline=False, seed=4,
              optimizer=opt)
    mvj.init([], devices=jax.devices()[:1])
    jd = JDictionary.build(sents, min_count=1)
    jsvc = JPSService()
    try:
        jw = JDistributed(JConfig(**kw), jd, jsvc, [jsvc.address], rank=0)
        jw.train([jd.encode(s) for s in sents])
        want = jw.embeddings()
        want_out = jw.w_out.get_rows(np.arange(jw.w_out.num_row))
    finally:
        jsvc.close()
        mvj.shutdown()
    mv.init(["-platform=cpu"])
    d = Dictionary.build(sents, min_count=1)
    assert d.words == jd.words
    svc = PSService()
    try:
        tw = DistributedWord2Vec(Word2VecConfig(**kw), d, svc,
                                 [svc.address], rank=0)
        stats = tw.train([d.encode(s) for s in sents])
        got = tw.embeddings()
        got_out = tw.w_out.get_rows(np.arange(tw.w_out.num_row))
    finally:
        svc.close()
    assert stats["words"] == jw.trained_words
    for a, b in ((got, want), (got_out, want_out)):
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=W2V_RTOL * scale)


def test_cli_two_ranks_on_the_cpu(tmp_path):
    """``word2vec_main -world_size=2 -w2v_device=cpu``: the launcher
    spawns two rank processes that rendezvous, train through each
    other's shards and export rank 0's vectors."""
    import subprocess
    import sys
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(" ".join(s) for s in _corpus(400)) + "\n")
    out = tmp_path / "v.txt"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.apps.word2vec_main",
         f"-train_file={corpus}", f"-output_file={out}", "-size=16",
         "-min_count=1", "-sample=0", "-epoch=3", "-alpha=0.1",
         "-batch_size=256", "-data_block_size=2000", "-world_size=2",
         "-w2v_device=cpu", f"-rendezvous_dir={tmp_path}"],
        cwd=repo, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = out.read_text().splitlines()
    assert lines[0] == "10 16"
    vecs = {l.split()[0]: np.array(l.split()[1:], np.float32)
            for l in lines[1:]}
    unit = {w: v / np.linalg.norm(v) for w, v in vecs.items()}
    a = [w for w in unit if w.startswith("a")]
    b = [w for w in unit if w.startswith("b")]
    intra = np.mean([unit[x] @ unit[y] for x in a for y in a if x != y])
    inter = np.mean([unit[x] @ unit[y] for x in a for y in b])
    assert intra > inter + 0.1, (intra, inter)
    assert (proc.stdout + proc.stderr).count("words/sec") >= 2


def test_two_rank_train_then_serve_bitwise_parity(mv_env):
    """Mirror of ``tests/test_serving_e2e.py::
    test_two_rank_train_then_serve_bitwise_parity``: word2vec trained
    across two ranks, then lookups served from each rank's LIVE input
    shard through the routed client, every reply bitwise the table's
    ``get_rows``. (The JAX test also counts its compiled executables per
    bucket; the port compiles none.)"""
    from multiverso_tpu_torch.serving import (RoutedLookupClient,
                                              ServingService,
                                              SparseLookupRunner)
    rng0 = np.random.default_rng(0)
    sents = [[f"{'a' if i % 2 == 0 else 'b'}{rng0.integers(0, 5)}"
              for _ in range(12)] for i in range(200)]
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    cfg = Word2VecConfig(embedding_size=16, batch_size=128, window=3,
                         negative=3, min_count=1, sample=0, sg=True,
                         epochs=1, learning_rate=0.01, block_words=1000,
                         pipeline=False, seed=3, optimizer="sgd")
    svc0, svc1 = PSService(), PSService()
    peers = [svc0.address, svc1.address]
    serves, client = [], None
    try:
        w0 = DistributedWord2Vec(cfg, d, svc0, peers, rank=0)
        w1 = DistributedWord2Vec(cfg, d, svc1, peers, rank=1)
        threads = [threading.Thread(target=w0.train, args=(ids[0::2],)),
                   threading.Thread(target=w1.train, args=(ids[1::2],))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "training hung"
        w0.w_in.flush(wait=True)
        w1.w_in.flush(wait=True)
        for w in (w0, w1):
            runner = SparseLookupRunner(
                w.w_in.local_store,
                row_offset=int(w.w_in.row_offsets[w.rank]))
            svc = ServingService()
            svc.register_runner(runner, buckets=(4, 8), max_batch=4,
                                max_wait_ms=1.0)
            serves.append(svc)
        client = RoutedLookupClient([s.address for s in serves],
                                    offsets=w0.w_in.row_offsets)
        V = len(d)
        rng = np.random.default_rng(7)
        for n in (3, 4, 2, 7, 8, 1):
            q = rng.integers(0, V, n).astype(np.int64)
            served = client.lookup(q, deadline_ms=10_000)
            direct = w0.w_in.get_rows(q.astype(np.int32))
            assert served.dtype == direct.dtype
            np.testing.assert_array_equal(served, direct)
        empty = client.lookup(np.empty(0, np.int64), deadline_ms=10_000)
        assert empty.shape == (0, 16)
    finally:
        if client is not None:
            client.close()
        for s in serves:
            s.close()
        svc0.close()
        svc1.close()
