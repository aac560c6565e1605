"""Port parity for the rest of the word2vec flagship on the CPU:
hierarchical softmax and CBOW on the device pipeline, the host batch path
(``device_pipeline=False``) and bfloat16 embedding tables.

* **Device block** (sg-hs, cbow-ns, cbow-hs; compacted and not): the JAX
  package's block draws are recomputed from ``jax.random.split`` and
  handed to the port; the example streams (CBOW's contexts and masks
  too) must be EQUAL, and after one block the four tables must be within
  ``rtol=1e-5, atol=1e-6`` of JAX's ``in_graph`` block step and the loss
  within ``rtol=1e-5`` (the sg-ns tolerance, ``tests/test_torch_sgns.py``:
  the port sums its dot products in another order than XLA).
* **Compaction**: compacted and uncompacted streams train bitwise alike in
  the port, for all four variants (the JAX package's own test,
  ``test_device_compaction_bitwise_all_variants``).
* **Host path**: JAX's ``device_pipeline=False`` and the port's get the same
  batches (``data.py`` is numpy on the same seeds); tables and loss within
  the same tolerance.
* **bfloat16**: ``_apply_update`` on a bfloat16 table is BITWISE JAX's
  (uint16 view) on the same float32 gradients with duplicate rows (the
  sg-ns block on bfloat16 tables: ``tests/test_torch_sgns.py``); and the
  bfloat16 loss stays within 3% of float32's (the
  bound of the JAX package's ``test_bfloat16_loss_delta_bounded``, held
  within the port only: that JAX test flickers).
* **CLI**: ``-cbow``, ``-hs`` and ``-use_device_pipeline=false`` train the
  port's CLI to topic separation.
* **Lane-order duplicate adds** (ROADMAP C4): ``_apply_update`` on a
  float32 table is BITWISE JAX's too, and the block step of every variant
  trains to the same bits as before the repair (``index_add_`` over every
  lane, masked ones and dropped ones adding zero), kept here as
  ``_apply_update_before``: on the CPU both add a row's duplicates in
  lane order; on the card only the repaired one does.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
import multiverso_tpu as mvj
from multiverso_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from multiverso_tpu.models.word2vec import Word2VecConfig as JaxConfig
from multiverso_tpu.models.word2vec import model as jmodel
from multiverso_tpu.models.word2vec.dictionary import \
    Dictionary as JaxDictionary

# Bound by _load_port: collection loads no torch.
torch = mvt = tmodel = None
Dictionary = Word2Vec = Word2VecConfig = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, mvt, tmodel, Dictionary, Word2Vec, Word2VecConfig
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.models.word2vec import (Dictionary, Word2Vec,
                                                      Word2VecConfig)
    from multiverso_tpu_torch.models.word2vec import model as tmodel


V, D, W, K, CHUNK, S, L = 200, 16, 3, 3, 16, 6, 20
VARIANTS = {"sg-ns": (True, False), "sg-hs": (True, True),
            "cbow-ns": (False, False), "cbow-hs": (False, True)}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.telemetry import reset_telemetry
    from multiverso_tpu_torch.utils.configure import reset_flags
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()
    Dashboard.reset()
    reset_telemetry()


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()


def _cfg_kwargs(**over):
    kw = dict(embedding_size=D, window=W, negative=K, batch_size=CHUNK,
              sample=1e-3, optimizer="adagrad", epochs=1, pipeline=False,
              device_pipeline=True, block_sentences=S,
              pad_sentence_length=L, dispatch_mode="in_graph", seed=0)
    kw.update(over)
    return kw


def _zipf_corpus():
    d, zipf = Dictionary.synthetic_zipf(V, 20_000)
    rng = np.random.default_rng(4)
    sents = [rng.choice(V, size=int(rng.integers(8, L + 1)), p=zipf)
             .astype(np.int32) for _ in range(S)]
    return d, sents


def _topic_corpus(n_sentences=300, seed=0):
    """Two word 'topics' that never co-occur: a0..a4 vs b0..b4."""
    rng = np.random.default_rng(seed)
    return [[f"{'a' if i % 2 == 0 else 'b'}{rng.integers(0, 5)}"
             for _ in range(12)] for i in range(n_sentences)]


def _topic_margin(w2v, d) -> float:
    emb = w2v.embeddings().astype(np.float32)
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    a = [d.word2id[w] for w in d.words if w.startswith("a")]
    b = [d.word2id[w] for w in d.words if w.startswith("b")]
    intra = np.mean([emb[i] @ emb[j] for i in a for j in a if i != j])
    inter = np.mean([emb[i] @ emb[j] for i in a for j in b])
    return intra - inter


def _jax_streams(jw, mat, lens, sub, sg, hs, compact):
    """The JAX block step's streams for key ``sub`` (its
    ``_make_block_fn`` body, model.py:440-482)."""
    k_keep, k_win, k_neg = jax.random.split(sub, 3)
    sents, lengths = jnp.asarray(mat), jnp.asarray(lens)
    if sg:
        c, o, pmask = jmodel._pair_arrays(sents, lengths, jw._keep_prob,
                                          k_keep, k_win, W)
        a1, a2 = [c, o], []
    else:
        c, ctx, cm, pmask = jmodel._cbow_arrays(sents, lengths,
                                                jw._keep_prob, k_keep,
                                                k_win, W)
        a1, a2 = [c], [ctx, cm]
    P = pmask.shape[0]
    pad = (-P) % CHUNK
    n = (P + pad) // CHUNK
    if compact:
        o1, o2, n_ex, n = jmodel._compact_examples(pmask, CHUNK, a1, a2)
        streams, mask = o1 + o2, None
    else:
        n_ex = pmask.sum()
        streams = [jnp.pad(a, (0, pad)).reshape(n, CHUNK) for a in a1]
        streams += [jnp.pad(a, ((0, pad), (0, 0))).reshape(n, CHUNK, -1)
                    for a in a2]
        mask = jnp.pad(pmask, (0, pad)).reshape(n, CHUNK) \
            .astype(jnp.float32)
    negs = None if hs else jmodel._row_gather_negatives(
        jw._neg_table, k_neg, (n, CHUNK, K))
    return streams, negs, mask, n_ex


def _jax_draws(sub, rows_needed, rows_tbl):
    """The port's drawn tensors from the JAX block key (the shapes of
    ``_pair_arrays``/``_cbow_arrays`` and ``_row_gather_negatives``)."""
    k_keep, k_win, k_neg = jax.random.split(sub, 3)
    return (torch.as_tensor(np.array(jax.random.uniform(k_keep, (S, L)))),
            torch.as_tensor(np.array(jax.random.randint(k_win, (S, L), 1,
                                                        W + 1))),
            torch.as_tensor(np.array(jax.random.randint(
                k_neg, (rows_needed,), 0, rows_tbl))))


def _assert_tables_close(jw, tw):
    for tj, tt in ((jw.input_table, tw.input_table),
                   (jw.output_table, tw.output_table),
                   (jw.adagrad_in, tw.adagrad_in),
                   (jw.adagrad_out, tw.adagrad_out)):
        np.testing.assert_allclose(tt.get(), np.asarray(tj.get(), np.float32),
                                   **TOL, err_msg=tt.name)


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "uncompacted"])
@pytest.mark.parametrize("variant", ["sg-hs", "cbow-ns", "cbow-hs"])
def test_device_block_matches_jax(both, variant, compact):
    sg, hs = VARIANTS[variant]
    d, sents = _zipf_corpus()
    jd = JaxDictionary.synthetic_zipf(V, 20_000)[0]
    kw = _cfg_kwargs(sg=sg, hs=hs, compact_pairs=compact)
    jw = JaxWord2Vec(JaxConfig(**kw), jd)
    tw = Word2Vec(Word2VecConfig(**kw), d)
    assert tw.dispatch_mode == jw._dispatch_mode == "in_graph"
    out_rows = V - 1 if hs else V
    assert tw.output_table.store.logical_shape == (out_rows, D)
    assert np.array_equal(jw.input_table.get(), tw.input_table.get())

    n, rows_needed, rows_tbl = tmodel.pair_stream_shape(
        S, L, W, CHUNK, 0 if hs else K, tw._neg_table.shape[0], sg=sg)
    sub = jax.random.split(jax.random.PRNGKey(0))[1]   # JAX's first block
    draws = _jax_draws(sub, rows_needed, rows_tbl)
    mat, lens, _ = next(tw._sentence_blocks(iter(sents)))
    want = _jax_streams(jw, mat, lens, sub, sg, hs, compact)
    got = tmodel.block_streams(tw._neg_table, tw._keep_prob,
                               torch.as_tensor(mat), torch.as_tensor(lens),
                               draws[0], draws[1].to(torch.int32), draws[2],
                               W, CHUNK, 0 if hs else K, sg=sg, hs=hs,
                               compact=compact)
    assert len(got[0]) == len(want[0]) == (2 if sg else 3)
    assert got[0][0].shape[0] == n
    for a, b in zip(want[0], got[0]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (got[1] is None) == hs
    if not hs:
        assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert (got[2] is None) == compact
    if not compact:
        assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    assert int(want[3]) == int(got[3]) > CHUNK

    tw.draw_randoms = lambda S_, L_, rn, rt: draws
    js = jw.train(sentences=sents)
    ts = tw.train(sentences=sents)
    assert js["pairs"] == ts["pairs"] == int(got[3])
    _assert_tables_close(jw, tw)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
    assert not np.array_equal(tw.output_table.get(),
                              np.zeros((out_rows, D), np.float32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_device_compaction_bitwise_all_variants(variant):
    """Compacted and uncompacted streams train bitwise alike when every
    example slot is valid (window 1, no subsampling, full sentences)."""
    from multiverso_tpu_torch.models.word2vec.dictionary import \
        HuffmanEncoder
    sg, hs = VARIANTS[variant]
    rng = np.random.default_rng(0)
    V_, D_, S_, L_ = 50, 16, 4, 8
    counts = rng.integers(1, 100, size=V_)
    huff = tmodel.HuffmanRows(HuffmanEncoder(counts, 16),
                              torch.device("cpu")) if hs else None
    neg_table = torch.as_tensor(rng.integers(0, V_, 997).astype(np.int32))
    keep_prob = torch.ones(V_)
    sents = torch.as_tensor(rng.integers(0, V_, (S_, L_)).astype(np.int32))
    lengths = torch.full((S_,), L_, dtype=torch.int32)
    chunk = 16 if sg else 8
    out_rows = V_ - 1 if hs else V_
    n, rows_needed, rows_tbl = tmodel.pair_stream_shape(
        S_, L_, 1, chunk, 0 if hs else 3, 997, sg=sg)
    gen = torch.Generator().manual_seed(7)
    drawn = tmodel.draw_pair_randoms(gen, S_, L_, 1, rows_needed, rows_tbl,
                                     torch.device("cpu"))
    raw = tmodel.raw_step(sg, hs, True)
    outs = []
    for compact in (False, True):
        streams, negs, mask, n_ex = tmodel.block_streams(
            neg_table, keep_prob, sents, lengths, *drawn, 1, chunk,
            0 if hs else 3, sg=sg, hs=hs, compact=compact)
        tables = (torch.as_tensor(np.random.default_rng(1).normal(
            size=(V_, D_)).astype(np.float32)), torch.zeros(out_rows, D_),
            torch.zeros(V_, D_), torch.zeros(out_rows, D_))
        loss = tmodel.chunk_loop(raw, tables, streams, negs, mask, n_ex,
                                 np.float32(0.05), sg=sg, hs=hs,
                                 huffman=huff)
        outs.append((tables, loss, int(n_ex)))
    assert outs[0][2] == outs[1][2] > 0
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])


def test_device_cbow_example_mask_semantics():
    """CBOW device examples: pad positions and subsampled tokens drop out
    of both roles; the port's arrays equal JAX's on the same draws."""
    sents = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=np.int32)
    lengths = np.asarray([3, 2], dtype=np.int32)
    keep = np.ones(6, dtype=np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    want = jmodel._cbow_arrays(jnp.asarray(sents), jnp.asarray(lengths),
                               jnp.asarray(keep), k1, k2, window=2)
    keep_u = torch.as_tensor(np.array(jax.random.uniform(k1, (2, 4))))
    wpos = torch.as_tensor(np.array(jax.random.randint(k2, (2, 4), 1, 3)))
    centers, contexts, cmask, ex_mask = tmodel._cbow_arrays(
        torch.as_tensor(sents), torch.as_tensor(lengths),
        torch.as_tensor(keep), keep_u, wpos, 2)
    for a, b in zip(want, (centers, contexts, cmask, ex_mask)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert centers.shape == (8,) and contexts.shape == (8, 4)
    ex = ex_mask.numpy()
    assert not ex[3] and not ex[6] and not ex[7]        # pads
    assert ex[[0, 1, 2, 4, 5]].all()
    cm = cmask.numpy()
    offs = [o for dd in (1, 2) for o in (dd, -dd)]
    for p in range(cm.shape[0]):
        row, col = divmod(p, 4)
        for j, dd in enumerate(offs):
            if cm[p, j]:
                assert 0 <= col + dd < lengths[row], (p, j)
    assert cm[ex].sum() > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_host_path_matches_jax(both, variant):
    """device_pipeline=False: the same numpy batches (BatchGenerator on the
    same seeds), the raw step over each group's batches in order."""
    sg, hs = VARIANTS[variant]
    d, sents = _zipf_corpus()
    jd = JaxDictionary.synthetic_zipf(V, 20_000)[0]
    kw = _cfg_kwargs(sg=sg, hs=hs, device_pipeline=False, block_words=40,
                     scan_group=3)
    jw = JaxWord2Vec(JaxConfig(**kw), jd)
    tw = Word2Vec(Word2VecConfig(**kw), d)
    assert tw.dispatch_mode is None
    js = jw.train(sentences=sents)
    ts = tw.train(sentences=sents)
    assert js["pairs"] == ts["pairs"] > 0 and js["words"] == ts["words"]
    assert ts["groups"] >= 2                  # a full and a padded group
    _assert_tables_close(jw, tw)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
    assert np.array_equal(jw.wordcount_table.get([0]),
                          tw.wordcount_table.get([0]))


@pytest.mark.parametrize("adagrad", [True, False], ids=["adagrad", "sgd"])
def test_bfloat16_apply_update_bitwise(adagrad):
    rng = np.random.default_rng(3)
    rows_n, d, n = 30, 8, 500
    w = rng.normal(size=(rows_n, d)).astype(np.float32)
    g2 = rng.random((rows_n, d)).astype(np.float32)
    rows = rng.integers(0, rows_n + 2, n).astype(np.int32)  # some dropped
    rows[:80] = 4                                           # a long run
    grad = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    lr = np.float32(0.025)
    jw, jg = jmodel._apply_update(jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(g2), jnp.asarray(rows),
                                  jnp.asarray(grad), lr, adagrad)
    # Copies: jnp.asarray may alias w and g2 on the CPU, and JAX may not
    # have read them yet when the port's in-place update writes.
    tw = torch.tensor(w).bfloat16()
    tg = torch.tensor(g2)
    tmodel._apply_update(tw, tg, torch.as_tensor(rows),
                         torch.as_tensor(grad), torch.tensor(lr), adagrad)
    assert tw.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jw).view(np.uint16),
                          tw.view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(np.asarray(jg), tg.numpy())


@pytest.mark.parametrize("adagrad", [True, False], ids=["adagrad", "sgd"])
def test_float32_apply_update_bitwise(adagrad):
    rng = np.random.default_rng(4)
    rows_n, d, n = 30, 8, 500
    w = rng.normal(size=(rows_n, d)).astype(np.float32)
    g2 = rng.random((rows_n, d)).astype(np.float32)
    rows = rng.integers(0, rows_n + 2, n).astype(np.int32)  # some dropped
    rows[:80] = 4                                           # a long run
    grad = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    lr = np.float32(0.025)
    jw, jg = jmodel._apply_update(jnp.asarray(w), jnp.asarray(g2),
                                  jnp.asarray(rows), jnp.asarray(grad), lr,
                                  adagrad)
    tw, tg = torch.tensor(w), torch.tensor(g2)     # copies, as above
    tmodel._apply_update(tw, tg, torch.as_tensor(rows),
                         torch.as_tensor(grad), torch.tensor(lr), adagrad)
    assert np.array_equal(np.asarray(jw).view(np.uint32),
                          tw.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(jg).view(np.uint32),
                          tg.numpy().view(np.uint32))


def _apply_update_before(w, g2, rows, grad, lr, adagrad: bool,
                         live=None) -> None:
    """``models/word2vec/model.py::_apply_update`` before the lane-order
    repair: ``index_add_`` over every lane (float atomics on a card), the
    lanes the masks exclude (``live``) too, the dropped lanes adding zero
    to row 0."""
    del live
    from multiverso_tpu_torch.core.updater import _sqrt
    from multiverso_tpu_torch.ops.rows import add_rows_lane_order
    num_rows = w.shape[0]
    rows = rows.to(torch.int64)
    keep = ((rows >= 0) & (rows < num_rows))[:, None]
    safe = torch.where(keep[:, 0], rows, torch.zeros_like(rows))
    zero = torch.zeros_like(grad)
    if adagrad:
        g2.index_add_(0, safe, torch.where(keep, torch.square(grad), zero))
        denom = _sqrt(g2.index_select(0, rows.clamp(0, num_rows - 1))
                      + 1e-6)
        step = -lr * grad / denom
    else:
        step = -lr * grad
    if w.dtype == torch.float32:
        w.index_add_(0, safe, torch.where(keep, step, zero))
    else:
        add_rows_lane_order(w, rows, step)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adagrad", [True, False], ids=["adagrad", "sgd"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_update_repair_keeps_the_cpu_bits(variant, adagrad,
                                                param_dtype, monkeypatch):
    """One block of each variant through the chunk loop: the repaired
    ``_apply_update``, which also skips the lanes the masks exclude (the
    Huffman paths' pad lanes, masked contexts and examples), trains the
    tables and the loss to the bits of the one before the repair, on the
    CPU."""
    from multiverso_tpu_torch.models.word2vec.dictionary import \
        HuffmanEncoder
    sg, hs = VARIANTS[variant]
    rng = np.random.default_rng(12)
    V_, D_, S_, L_ = 50, 16, 4, 12
    counts = rng.integers(1, 100, size=V_)
    huff = tmodel.HuffmanRows(HuffmanEncoder(counts, 16),
                              torch.device("cpu")) if hs else None
    neg_table = torch.as_tensor(rng.integers(0, V_, 997).astype(np.int32))
    sents = torch.as_tensor(rng.integers(0, V_, (S_, L_)).astype(np.int32))
    lengths = torch.as_tensor(rng.integers(4, L_ + 1, S_).astype(np.int32))
    chunk = 16 if sg else 8
    out_rows = V_ - 1 if hs else V_
    n, rows_needed, rows_tbl = tmodel.pair_stream_shape(
        S_, L_, 2, chunk, 0 if hs else 3, 997, sg=sg)
    drawn = tmodel.draw_pair_randoms(torch.Generator().manual_seed(7), S_,
                                     L_, 2, rows_needed, rows_tbl,
                                     torch.device("cpu"))
    streams, negs, mask, n_ex = tmodel.block_streams(
        neg_table, torch.ones(V_), sents, lengths, *drawn, 2, chunk,
        0 if hs else 3, sg=sg, hs=hs, compact=True)
    dtype = getattr(torch, param_dtype)
    init = np.random.default_rng(1).normal(size=(V_, D_)).astype(np.float32)
    raw = tmodel.raw_step(sg, hs, adagrad)
    outs = []
    for update in (tmodel._apply_update, _apply_update_before):
        monkeypatch.setattr(tmodel, "_apply_update", update)
        tables = (torch.tensor(init).to(dtype),
                  (0.1 * torch.tensor(init[:out_rows])).to(dtype),
                  torch.zeros(V_, D_), torch.zeros(out_rows, D_))
        loss = tmodel.chunk_loop(raw, tables, streams, negs, mask, n_ex,
                                 np.float32(0.05), sg=sg, hs=hs,
                                 huffman=huff)
        outs.append((tables, loss))
    assert int(n_ex) > 0
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))
    assert torch.equal(outs[0][1], outs[1][1])


def test_bfloat16_loss_close_to_float32():
    """bfloat16 embeddings (float32 math) track the float32 loss within
    3% on the same config and seed, and still separate topics (the JAX
    package's bounds, held within the port)."""
    mvt.init(["-platform=cpu"])
    sents = _topic_corpus()
    d = Dictionary.build(sents, min_count=1)
    ids = [d.encode(s) for s in sents]
    losses = {}
    for dt in ("float32", "bfloat16"):
        cfg = Word2VecConfig(embedding_size=32, batch_size=256, window=4,
                             negative=5, min_count=1, sample=0, sg=True,
                             epochs=3, learning_rate=0.1, block_words=5000,
                             param_dtype=dt, seed=3, device_pipeline=True,
                             block_sentences=128, pad_sentence_length=16)
        w2v = Word2Vec(cfg, d)
        assert w2v.input_table.store.data.dtype == \
            (torch.bfloat16 if dt == "bfloat16" else torch.float32)
        losses[dt] = w2v.train(sentences=ids)["loss"]
        assert _topic_margin(w2v, d) > 0.1, dt
    rel = abs(losses["bfloat16"] - losses["float32"]) / abs(
        losses["float32"])
    assert rel < 0.03, losses


@pytest.mark.parametrize("variant", ["sg-hs", "cbow-ns", "cbow-hs"])
@pytest.mark.parametrize("device_pipeline", [True, False],
                         ids=["device", "host"])
def test_variants_separate_topics(variant, device_pipeline):
    """Every variant on either path trains to topic separation (the JAX
    package's ``test_device_pipeline_all_variants_train``), and the
    defaults of ``Word2VecConfig()`` train."""
    sg, hs = VARIANTS[variant]
    mvt.init(["-platform=cpu"])
    sents = _topic_corpus()
    d = Dictionary.build(sents, min_count=1)
    cfg = Word2VecConfig(embedding_size=32, batch_size=512, window=4,
                         negative=5, min_count=1, sample=0, sg=sg, hs=hs,
                         epochs=3, learning_rate=0.1, seed=3,
                         device_pipeline=device_pipeline, block_words=5000,
                         block_sentences=128, pad_sentence_length=16,
                         pipeline=False)
    w2v = Word2Vec(cfg, d)
    stats = w2v.train(sentences=[d.encode(s) for s in sents])
    assert stats["pairs"] > 0 and np.isfinite(stats["loss"])
    assert _topic_margin(w2v, d) > 0.1
    if variant == "sg-hs" and not device_pipeline:
        plain = Word2Vec(Word2VecConfig(), d)
        assert plain.dispatch_mode is None
        assert np.isfinite(plain.train(sentences=[d.encode(s)
                                                  for s in sents])["loss"])


def test_dispatch_for_hs_and_cbow():
    """AUTO sends hs and CBOW to in_graph on any device (the JAX
    decision's rule 1); an explicit kernel or host-dispatch mode raises."""
    from multiverso_tpu_torch.utils.log import FatalError
    for sg, hs in (VARIANTS["sg-hs"], VARIANTS["cbow-ns"],
                   VARIANTS["cbow-hs"]):
        for dev in (torch.device("cpu"), torch.device("cuda", 0)):
            for mode in (None, "auto", "in_graph"):
                cfg = Word2VecConfig(**_cfg_kwargs(sg=sg, hs=hs,
                                                   dispatch_mode=mode))
                assert tmodel.resolve_dispatch_mode(cfg, V, V, dev) == \
                    "in_graph"
            for mode in ("pallas_grid", "pipelined_host"):
                cfg = Word2VecConfig(**_cfg_kwargs(sg=sg, hs=hs,
                                                   dispatch_mode=mode))
                with pytest.raises(FatalError, match="sg-ns"):
                    tmodel.resolve_dispatch_mode(cfg, V, V, dev)


def test_bfloat16_dispatch_on_a_card(monkeypatch):
    """On a card AUTO picks the kernel for bfloat16 sg-ns (no card is
    touched); the working set reckons 2 bytes a parameter."""
    from multiverso_tpu_torch.ops import sgns

    class Card:
        total_memory = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Card)
    card = torch.device("cuda", 0)
    cfg = Word2VecConfig(**_cfg_kwargs(dispatch_mode=None,
                                       param_dtype="bfloat16"))
    assert tmodel.resolve_dispatch_mode(cfg, V, V, card) == "pallas_grid"
    f32 = sgns.sgns_grid_bytes(4096, 4096, 128, 8192, 5, "float32")
    bf16 = sgns.sgns_grid_bytes(4096, 4096, 128, 8192, 5, "bfloat16")
    assert f32 - bf16 == 2 * 4096 * 128 * 2
    assert bf16 == sgns.sgns_grid_bytes(4096, 4096, 128, 8192, 5,
                                        np.dtype(jnp.bfloat16))


@pytest.mark.parametrize("flags", [["-cbow=true"], ["-hs=true"],
                                   ["-cbow=true", "-hs=true"],
                                   ["-use_device_pipeline=false"]],
                         ids=["cbow", "hs", "cbow-hs", "host"])
def test_cli_variants_separate_topics(tmp_path, flags):
    from multiverso_tpu_torch.apps import word2vec_main
    corpus, out = tmp_path / "c.txt", tmp_path / "v.txt"
    with open(corpus, "w") as f:
        for s in _topic_corpus():
            f.write(" ".join(s) + "\n")
    rc = word2vec_main.main([f"-train_file={corpus}", f"-output_file={out}",
                             "-size=16", "-sample=0", "-min_count=1",
                             "-epoch=3", "-batch_size=512", "-alpha=0.1",
                             "-block_sentences=64", "-data_block_size=5000",
                             "-pad_sentence_length=16", "-w2v_device=cpu",
                             *flags])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "10 16" and len(lines) == 11
    emb = {}
    for line in lines[1:]:
        word, *vals = line.split()
        v = np.asarray(vals, np.float32)
        emb[word] = v / (np.linalg.norm(v) + 1e-12)
    a = [w for w in emb if w.startswith("a")]
    b = [w for w in emb if w.startswith("b")]
    intra = np.mean([emb[x] @ emb[y] for x in a for y in a if x != y])
    inter = np.mean([emb[x] @ emb[y] for x in a for y in b])
    assert intra > inter + 0.1, (flags, intra, inter)


def test_interop_loads_bfloat16_tables_bitwise(both):
    """The JAX package's bfloat16 tables load into a bfloat16 port model
    bit for bit, as float32 values, as uint16 bit patterns and as its own
    bfloat16 arrays; a float32 value that is not bfloat16 is refused."""
    from multiverso_tpu_torch import interop
    from multiverso_tpu_torch.utils.log import FatalError
    d, sents = _zipf_corpus()
    jd = JaxDictionary.synthetic_zipf(V, 20_000)[0]
    kw = _cfg_kwargs(param_dtype="bfloat16")
    jw = JaxWord2Vec(JaxConfig(**kw), jd)
    jw.train(sentences=sents)
    tw = Word2Vec(Word2VecConfig(**kw), d)
    raw = [np.asarray(t.get()) for t in (jw.input_table, jw.output_table,
                                         jw.adagrad_in, jw.adagrad_out)]
    assert raw[0].dtype.name == "bfloat16" and raw[2].dtype == np.float32
    for form in (lambda a: a.astype(np.float32), lambda a: a.view(np.uint16),
                 lambda a: a):
        tw.input_table.store.data.zero_()
        interop.load_word2vec_tables(tw, form(raw[0]), form(raw[1]),
                                     raw[2], raw[3])
        for t, want in zip((tw.input_table, tw.output_table), raw[:2]):
            assert np.array_equal(
                t.store.data.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        assert np.array_equal(tw.adagrad_out.get(), raw[3])
    off = raw[0].astype(np.float32)
    off[0, 0] += 1e-6
    with pytest.raises(FatalError, match="not bfloat16"):
        interop.load_word2vec_tables(tw, off, raw[1], raw[2], raw[3])
