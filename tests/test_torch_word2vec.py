"""Port parity for the word2vec flagship slice, end to end on the CPU.

* The JAX and port ``Word2Vec`` start from the same seed (same numpy
  random init, sampler table and keep probabilities).
* The JAX package's per-block random numbers are recomputed here from
  ``jax.random.split`` exactly as its ``_train_device`` and ``pair_gen``
  draw them, and handed to the port's pure ``pair_gen``: the pair streams
  must be EQUAL.
* After one block the four tables agree within the sg-ns tolerance
  (``rtol=1e-5, atol=1e-6``, see ``tests/test_torch_sgns.py``). The JAX
  side runs ``dispatch_mode="in_graph"``, which its own tests hold bitwise
  to ``pallas_grid`` (``tests/test_word2vec.py``).
* The CLI trains on a two-topic corpus on the CPU and exports vectors
  whose intra-topic cosine beats the cross-topic cosine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_port
import multiverso_tpu as mvj
from multiverso_tpu.models.word2vec import Word2Vec as JaxWord2Vec
from multiverso_tpu.models.word2vec import Word2VecConfig as JaxConfig
from multiverso_tpu.models.word2vec.dictionary import \
    Dictionary as JaxDictionary
from multiverso_tpu.models.word2vec.dictionary import \
    HuffmanEncoder as JaxHuffman
from multiverso_tpu.models.word2vec.dictionary import Sampler as JaxSampler
from multiverso_tpu.models.word2vec.model import build_chunked_pipeline

# Bound by _load_port: collection loads no torch.
torch = mvt = interop = tmodel = None
Dictionary = HuffmanEncoder = Sampler = Word2Vec = Word2VecConfig = None


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global torch, mvt, interop, tmodel
    global Dictionary, HuffmanEncoder, Sampler, Word2Vec, Word2VecConfig
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch import interop
    from multiverso_tpu_torch.models.word2vec import (Dictionary,
                                                      HuffmanEncoder, Sampler,
                                                      Word2Vec,
                                                      Word2VecConfig)
    from multiverso_tpu_torch.models.word2vec import model as tmodel

V, D, W, K, CHUNK, S, L = 200, 16, 3, 3, 16, 6, 20


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


def _cfg_kwargs(**over):
    kw = dict(embedding_size=D, window=W, negative=K, batch_size=CHUNK,
              sample=1e-3, optimizer="adagrad", epochs=1, pipeline=False,
              device_pipeline=True, block_sentences=S,
              pad_sentence_length=L, dispatch_mode="in_graph", seed=0)
    kw.update(over)
    return kw


def _corpus():
    d, zipf = Dictionary.synthetic_zipf(V, 20_000)
    rng = np.random.default_rng(4)
    sents = [rng.choice(V, size=int(rng.integers(8, L + 1)), p=zipf)
             .astype(np.int32) for _ in range(S)]
    return d, sents


def _jax_block_draws(seed, n_blocks, rows_needed, rows_tbl):
    """The JAX package's draws for its first blocks (model.py:1285 and
    790-796, with _pair_arrays / _row_gather_negatives' shapes)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        k_keep, k_win, k_neg = jax.random.split(sub, 3)
        out.append((sub, (
            np.array(jax.random.uniform(k_keep, (S, L))),
            np.array(jax.random.randint(k_win, (S, L), 1, W + 1)),
            np.array(jax.random.randint(k_neg, (rows_needed,), 0,
                                        rows_tbl)))))
    return out


def test_one_block_matches_jax():
    d, sents = _corpus()
    jd = JaxDictionary.synthetic_zipf(V, 20_000)[0]
    assert jd.counts == d.counts
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    try:
        jw = JaxWord2Vec(JaxConfig(**_cfg_kwargs()), jd)
        tw = Word2Vec(Word2VecConfig(**_cfg_kwargs()), d)
        # Same start: numpy-seeded init, sampler table, keep probabilities.
        init = tw.input_table.get()
        assert np.array_equal(jw.input_table.get(), init)
        assert np.array_equal(np.asarray(jw._neg_table),
                              tw._neg_table.numpy())
        assert np.array_equal(np.asarray(jw._keep_prob),
                              tw._keep_prob.numpy())

        n, rows_needed, rows_tbl = tmodel.pair_stream_shape(
            S, L, W, CHUNK, K, tw._neg_table.shape[0])
        (sub, draws), (_, draws2) = _jax_block_draws(0, 2, rows_needed,
                                                     rows_tbl)
        mat, lens, _ = next(tw._sentence_blocks(iter(sents)))

        # Pair streams: the JAX pair_gen on its key vs the port's pure
        # pair building on the same random numbers.
        pair_gen = build_chunked_pipeline(W, K, CHUNK, True)[0]
        want = pair_gen(jw._neg_table, jw._keep_prob, jnp.asarray(mat),
                        jnp.asarray(lens), sub)
        got = tmodel.pair_gen(tw._neg_table, tw._keep_prob,
                              torch.as_tensor(mat), torch.as_tensor(lens),
                              *[torch.as_tensor(x) for x in draws],
                              W, CHUNK, K)
        assert got[0].shape == (n, CHUNK)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy())
        n_pairs = int(got[3])
        assert n_pairs > 3 * CHUNK and n_pairs % CHUNK      # masked tail

        tw.draw_randoms = lambda S_, L_, rn, rt: tuple(
            torch.as_tensor(x) for x in draws)
        js = jw.train(sentences=sents)
        ts = tw.train(sentences=sents)
        assert js["pairs"] == ts["pairs"] == n_pairs
        assert js["words"] == ts["words"]
        for tj, tt in ((jw.input_table, tw.input_table),
                       (jw.output_table, tw.output_table),
                       (jw.adagrad_in, tw.adagrad_in),
                       (jw.adagrad_out, tw.adagrad_out)):
            np.testing.assert_allclose(tt.get(), tj.get(), rtol=1e-5,
                                       atol=1e-6, err_msg=tt.name)
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
        assert np.array_equal(jw.wordcount_table.get([0]),
                              tw.wordcount_table.get([0]))
        assert not np.array_equal(tw.input_table.get(), init)

        # Carry the JAX tables into the port (interop) and train a second
        # block on JAX's second draws: the tables stay within tolerance.
        interop.load_word2vec_tables(
            tw, jw.input_table.get(), jw.output_table.get(),
            jw.adagrad_in.get(), jw.adagrad_out.get())
        assert np.array_equal(tw.output_table.get(), jw.output_table.get())
        tw.draw_randoms = lambda S_, L_, rn, rt: tuple(
            torch.as_tensor(x) for x in draws2)
        js, ts = jw.train(sentences=sents), tw.train(sentences=sents)
        assert js["pairs"] == ts["pairs"]
        for tj, tt in ((jw.input_table, tw.input_table),
                       (jw.adagrad_out, tw.adagrad_out)):
            np.testing.assert_allclose(tt.get(), tj.get(), rtol=1e-5,
                                       atol=1e-6, err_msg=tt.name)
    finally:
        mvt.shutdown()
        mvj.shutdown()


def test_host_helpers_match_jax():
    counts = [50, 30, 10, 5, 3, 2]
    jh, th = JaxHuffman(counts), HuffmanEncoder(counts)
    for attr in ("points", "codes", "lengths"):
        assert np.array_equal(getattr(jh, attr), getattr(th, attr))
    d = Dictionary.build([["x", "y", "x"], ["x", "z"]], min_count=1)
    assert d.words[0] == "x" and d.encode(["x", "q", "z"]) == [0, 2]
    assert np.array_equal(Sampler(counts).table, JaxSampler(counts).table)
    assert np.array_equal(Sampler.keep_probability(counts, 1e-3),
                          JaxSampler.keep_probability(counts, 1e-3))


def test_dispatch_and_waits():
    mvt.init(["-platform=cpu"])
    d, sents = _corpus()
    cpu = torch.device("cpu")
    assert tmodel.resolve_dispatch_mode(
        Word2VecConfig(**_cfg_kwargs(dispatch_mode=None)), V, V, cpu) == \
        "in_graph"
    w = Word2Vec(Word2VecConfig(**_cfg_kwargs(dispatch_mode="pallas_grid")),
                 d)
    stats = w.train(sentences=sents)        # CPU: the plain chunk loop
    assert w.dispatch_mode == "pallas_grid" and np.isfinite(stats["loss"])
    assert stats["blocks"] == 1 and stats["pairs"] > 0
    assert len(w.most_similar("w0", topk=3)) == 3
    assert len(w.analogy("w0", "w1", "w2", topk=2)) == 2
    from multiverso_tpu_torch.utils.log import FatalError
    with pytest.raises(FatalError):
        tmodel.resolve_dispatch_mode(
            Word2VecConfig(**_cfg_kwargs(dispatch_mode="bogus")), V, V, cpu)
    for over in (dict(mesh_data=2), dict(comm_policy="ps")):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            Word2Vec(Word2VecConfig(**_cfg_kwargs(**over)), d)
    # hs, CBOW, the host batch path and bfloat16 tables train.
    for over in (dict(hs=True), dict(sg=False), dict(device_pipeline=False),
                 dict(param_dtype="bfloat16")):
        w = Word2Vec(Word2VecConfig(**_cfg_kwargs(**over)), d)
        stats = w.train(sentences=sents)
        assert np.isfinite(stats["loss"]) and stats["pairs"] > 0, over


def test_dispatch_on_a_card_never_falls_back_to_the_plain_loop(monkeypatch):
    """On a CUDA device AUTO and pallas_grid go to the B5 kernel, and a
    configuration it does not take raises; only an explicit in_graph or
    pipelined_host runs the plain loop there (no card is touched)."""
    class Card:
        total_memory = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Card)
    card = torch.device("cuda", 0)
    from multiverso_tpu_torch.utils.log import FatalError
    for mode in (None, "auto", "pallas_grid"):
        cfg = Word2VecConfig(**_cfg_kwargs(dispatch_mode=mode))
        assert tmodel.resolve_dispatch_mode(cfg, V, V, card) == "pallas_grid"
        cfg = Word2VecConfig(**_cfg_kwargs(dispatch_mode=mode, negative=17))
        with pytest.raises(FatalError, match="ROADMAP B5"):
            tmodel.resolve_dispatch_mode(cfg, V, V, card)
    for mode in ("in_graph", "pipelined_host"):
        cfg = Word2VecConfig(**_cfg_kwargs(dispatch_mode=mode, negative=17))
        assert tmodel.resolve_dispatch_mode(cfg, V, V, card) == mode


def _topic_corpus(path, n=300, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            topic = "a" if i % 2 == 0 else "b"
            f.write(" ".join(f"{topic}{rng.integers(0, 5)}"
                             for _ in range(12)) + "\n")


def test_cli_trains_topics_on_cpu(tmp_path):
    from multiverso_tpu_torch.apps import word2vec_main
    corpus, out = tmp_path / "c.txt", tmp_path / "v.txt"
    _topic_corpus(corpus)
    rc = word2vec_main.main([f"-train_file={corpus}", f"-output_file={out}",
                             "-size=16", "-sample=0", "-min_count=1",
                             "-epoch=3", "-batch_size=512",
                             "-block_sentences=64",
                             "-pad_sentence_length=16", "-w2v_device=cpu"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "10 16" and len(lines) == 11
    emb = {}
    for line in lines[1:]:
        word, *vals = line.split()
        assert len(vals) == 16
        v = np.asarray(vals, np.float32)
        emb[word] = v / (np.linalg.norm(v) + 1e-12)
    a = [w for w in emb if w.startswith("a")]
    b = [w for w in emb if w.startswith("b")]
    intra = np.mean([emb[x] @ emb[y] for x in a for y in a if x != y])
    inter = np.mean([emb[x] @ emb[y] for x in a for y in b])
    assert intra > inter + 0.1, (intra, inter)


def test_cli_user_errors(tmp_path):
    from multiverso_tpu_torch.apps import word2vec_main
    assert word2vec_main.main(["-w2v_device=cpu"]) == 1      # no -train_file
    assert word2vec_main.main(["-w2v_device=cpu", "-size=abc"]) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        word2vec_main.main(["-world_size=2", "-w2v_device=cpu"])
