"""Port parity: LDA (blocked collapsed Gibbs sampling on a MatrixTable and
an ArrayTable) on the CPU against the JAX package.

Mirrors ``tests/test_lda.py``. ``jax.random.categorical(key, logits)`` is
``argmax(gumbel(key, logits.shape) + logits)``, so the port samples by
Gumbel-max and takes its noise from a callable: here the JAX package's own
``gumbel`` for the same subkeys (``PRNGKey(seed)`` split once a block, as
``LDA.train`` splits it). With that noise a small ``LDA.train`` must give
JAX's topics token for token, and its tables and doc-topic counts BITWISE
(the counts are integers in float32, exact in any order). No tolerance is
needed on these corpora: no near-tie of two topics' scores (which a one-
ulp difference of ``log`` between XLA and torch could flip) occurs in
them.
"""

import numpy as np
import pytest

import _torch_port
import jax
import jax.numpy as jnp

import multiverso_tpu as mvj
from multiverso_tpu.models.lda import LDA as JLDA
from multiverso_tpu.models.lda import LDAConfig as JConfig

mvt = tlda = torch = None  # set by _load_port


@pytest.fixture(scope="module", autouse=True)
def _load_port():
    global mvt, tlda, torch
    torch = _torch_port.load_torch()
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.models import lda as tlda


@pytest.fixture(autouse=True)
def _port_state():
    yield
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.utils.configure import reset_flags
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        zoo.stop()
    Zoo._reset_for_tests()
    reset_flags()


@pytest.fixture
def both():
    mvj.init([], devices=jax.devices()[:1])
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()
    mvj.shutdown()


@pytest.fixture
def port():
    mvt.init(["-platform=cpu"])
    yield
    mvt.shutdown()


def _planted_corpus(n_docs=60, doc_len=50, seed=0):
    """Two planted topics: words 0-9 vs words 10-19; each doc draws from
    one topic only."""
    rng = np.random.default_rng(seed)
    words, docs = [], []
    for d in range(n_docs):
        lo = 0 if d % 2 == 0 else 10
        words.extend(rng.integers(lo, lo + 10, size=doc_len).tolist())
        docs.extend([d] * doc_len)
    return np.asarray(words), np.asarray(docs), n_docs, 20


def jax_gumbel(seed):
    """The noise the JAX package's ``LDA.train`` draws: one subkey a block
    from ``PRNGKey(seed)``, ``categorical``'s ``gumbel`` of the logits'
    shape."""
    state = {"key": jax.random.PRNGKey(seed), "next": 0}

    def noise(block, shape):
        assert block == state["next"]
        state["key"], sub = jax.random.split(state["key"])
        state["next"] += 1
        return np.asarray(jax.random.gumbel(sub, shape, jnp.float32))

    return noise


def _train_both(cfg_kw, words, docs, D, V, iterations=None):
    jl = JLDA(JConfig(**cfg_kw), num_docs=D, vocab_size=V)
    tl = tlda.LDA(tlda.LDAConfig(**cfg_kw), num_docs=D, vocab_size=V,
                  gumbel=jax_gumbel(cfg_kw["seed"]))
    jt = jl.train(words, docs, iterations)["topics"]
    tt = tl.train(words, docs, iterations)["topics"]
    assert np.array_equal(np.asarray(jt), tt)
    assert np.array_equal(jl.word_topic.get(), tl.word_topic.get())
    assert np.array_equal(jl.topic.get(), tl.topic.get())
    assert np.array_equal(jl.doc_topic, tl.doc_topic.numpy())
    assert np.array_equal(jl.topic_word(), tl.topic_word())
    return jl, tl


def test_categorical_is_gumbel_max():
    """The premise: JAX's categorical is the argmax of its gumbel noise
    plus the logits, and the port's step samples that argmax."""
    key = jax.random.PRNGKey(3)
    logits = jax.random.normal(jax.random.PRNGKey(4), (512, 37))
    want = np.asarray(jax.random.categorical(key, logits, axis=-1))
    g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    assert np.array_equal(want, np.argmax(g + np.asarray(logits), axis=-1))


def test_gibbs_step_matches_jax_step():
    from multiverso_tpu.models.lda import _build_gibbs_step
    rng = np.random.default_rng(6)
    N, K, V = 300, 12, 50
    n_wk = rng.integers(0, 30, size=(N, K)).astype(np.float32) + 1
    n_dk = rng.integers(0, 9, size=(N, K)).astype(np.float32) + 1
    n_k = n_wk.sum(axis=0) + 100
    t = rng.integers(0, K, size=N).astype(np.int32)
    key = jax.random.PRNGKey(8)
    want = np.asarray(_build_gibbs_step(K, V, 0.1, 0.01)(
        jnp.asarray(n_wk), jnp.asarray(n_k), jnp.asarray(n_dk),
        jnp.asarray(t), key))
    g = np.array(jax.random.gumbel(key, (N, K), jnp.float32))
    got = tlda.gibbs_step(torch.as_tensor(n_wk), torch.as_tensor(n_k),
                          torch.as_tensor(n_dk),
                          torch.tensor(t).long(), torch.as_tensor(g),
                          V, 0.1, 0.01)
    assert np.array_equal(want, got.numpy())


def test_lda_recovers_planted_topics(both):
    words, docs, D, V = _planted_corpus()
    _, tl = _train_both(dict(num_topics=2, iterations=30, alpha=0.5,
                             beta=0.1, block_tokens=1 << 12, seed=1),
                        words, docs, D, V)
    dist = tl.topic_word()
    mass_low = dist[:, :10].sum(axis=1)
    lo_topic = int(np.argmax(mass_low))
    assert mass_low[lo_topic] > 0.85 and mass_low[1 - lo_topic] < 0.15
    assert len(set(tl.top_words(lo_topic, 10)) & set(range(10))) >= 8


def test_lda_count_conservation(both):
    words, docs, D, V = _planted_corpus(n_docs=20, doc_len=30)
    _, tl = _train_both(dict(num_topics=4, iterations=5, block_tokens=256,
                             seed=2), words, docs, D, V)
    n_tokens = len(words)
    assert tl.word_topic.get().sum() == n_tokens
    assert tl.topic.get().sum() == n_tokens
    assert float(tl.doc_topic.sum()) == n_tokens


def test_lda_zipf_corpus_ragged_blocks(both):
    """A Zipf corpus over a wider vocabulary, blocks that do not divide
    it, several sweeps: topics and tables still JAX's."""
    rng = np.random.default_rng(12)
    V, D, n = 300, 40, 3000
    words = np.minimum(rng.zipf(1.3, size=n) - 1, V - 1)
    docs = np.sort(rng.integers(0, D, size=n))
    _train_both(dict(num_topics=7, iterations=3, block_tokens=700, seed=5),
                words, docs, D, V)


def test_lda_pushes_scale_with_touched_rows_not_vocab(port):
    V, K = 100_000, 8
    rng = np.random.default_rng(0)
    active = rng.choice(V, size=50, replace=False)
    words = rng.choice(active, size=512)
    docs = rng.integers(0, 4, size=512)
    lda = tlda.LDA(tlda.LDAConfig(num_topics=K, iterations=2,
                                  block_tokens=256, seed=0),
                   num_docs=4, vocab_size=V)
    pushed = []
    orig = lda.word_topic.add_rows

    def spy(rows, deltas, *a, **k):
        pushed.append(tuple(deltas.shape))
        return orig(rows, deltas, *a, **k)

    lda.word_topic.add_rows = spy
    stats = lda.train(words, docs)
    assert pushed and stats["tokens_per_sec"] > 0
    for shape in pushed:
        assert shape[0] <= 50 and shape[1] == K


def test_default_noise_is_seeded(port):
    """Without a noise callable the draws come from a generator seeded
    with cfg.seed: two runs with one seed sample alike."""
    words, docs, D, V = _planted_corpus(n_docs=10, doc_len=20)
    out = []
    for _ in range(2):
        lda = tlda.LDA(tlda.LDAConfig(num_topics=3, iterations=2,
                                      block_tokens=64, seed=9),
                       num_docs=D, vocab_size=V)
        out.append(lda.train(words, docs)["topics"])
        mvt.shutdown()
        mvt.init(["-platform=cpu"])
    assert np.array_equal(out[0], out[1])


def test_cli_prints_topics_on_cpu(tmp_path, capsys):
    from multiverso_tpu_torch.apps import lda_main
    rng = np.random.default_rng(0)
    lines = []
    for d in range(30):
        group = ["apple", "pear", "plum", "fig"] if d % 2 else \
            ["bolt", "nut", "gear", "screw"]
        lines.append(" ".join(rng.choice(group, size=12)))
    (tmp_path / "docs.txt").write_text("\n".join(lines) + "\n")
    rc = lda_main.main([f"-docs_file={tmp_path}/docs.txt", "-num_topics=2",
                        "-lda_iterations=20", "-topn=4", "-lda_alpha=0.5",
                        "-lda_beta=0.1", "-lda_device=cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    topics = [line.split(":", 1)[1] for line in out.splitlines()
              if line.startswith("topic ")]
    assert len(topics) == 2
    fruit = {"apple", "pear", "plum", "fig"}
    for top in topics:
        words = {w.strip() for w in top.split(",")}
        assert words == fruit or not (words & fruit)
