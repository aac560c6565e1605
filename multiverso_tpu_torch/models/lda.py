"""Latent Dirichlet Allocation via blocked collapsed Gibbs sampling on the
parameter-server tables — the lightLDA-style workload.

Port of ``multiverso_tpu/models/lda.py``. The reference README lists
lightLDA as a Multiverso-based system (``README.md:29-34``): topic-count
tables live in the parameter server, workers sample locally and push count
deltas.

* ``word_topic`` counts: a :class:`MatrixTable` [V, K] — the analog of
  lightLDA's word-topic table.
* ``topic`` totals: an :class:`ArrayTable` [K].
* Workers hold doc-topic counts locally (as lightLDA does), here as a
  tensor beside the tables on the device, and run a **blocked** Gibbs step
  per token block: pull the block's unique word rows, form the collapsed
  posterior p(k | w, d) ∝ (n_wk + β)(n_dk + α)/(n_k + Vβ), sample, and push
  count deltas for exactly the rows the block touched. Counts refresh per
  block, not per token — the staleness model a distributed PS LDA runs
  with. Everything stays on the device: the pulls are ``raw_rows``/``raw``
  and the pushes are row and dense Adds of device tensors (the word-topic
  table's row Add is ``ops/rows.add_rows_sorted``, B4's kernel on a card).

Sampling is Gumbel-max: ``argmax(logits + g)`` with ``g`` standard Gumbel
noise, which is what the JAX package's ``jax.random.categorical`` computes
(``argmax(gumbel(key, shape) + logits)``). By default the noise comes from
a ``torch.Generator`` seeded with ``cfg.seed``; a ``gumbel`` callable
``(block_index, (n, K)) -> array`` replaces it, so a caller can feed the
JAX package's own noise for the same subkeys. The counts are integers in
float32 (below 2^24), so every add of them is exact in any order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.core.options import (ArrayTableOption,
                                               MatrixTableOption)
from multiverso_tpu_torch.utils.log import check

Gumbel = Callable[[int, Tuple[int, int]], object]


@dataclasses.dataclass
class LDAConfig:
    num_topics: int = 16
    alpha: float = 0.1        # doc-topic prior
    beta: float = 0.01        # topic-word prior
    iterations: int = 50
    block_tokens: int = 1 << 14
    seed: int = 0


def gibbs_step(n_wk_rows: torch.Tensor, n_k: torch.Tensor,
               n_dk_rows: torch.Tensor, topics: torch.Tensor,
               noise: torch.Tensor, vocab_size: int, alpha: float,
               beta: float) -> torch.Tensor:
    """One blocked Gibbs sweep over a token block (the JAX package's
    ``_build_gibbs_step``, op for op).

    n_wk_rows: [N, K] word rows per token; n_k: [K]; n_dk_rows: [N, K] doc
    rows per token; topics: [N] current assignments; noise: [N, K]
    standard Gumbel draws. Returns the new topics [N] (int64)."""
    K = n_k.shape[0]
    onehot_old = torch.nn.functional.one_hot(topics, K).to(torch.float32)
    # Exclude the current token's own count (collapsed sampler).
    nw = n_wk_rows - onehot_old
    nd = n_dk_rows - onehot_old
    nk = n_k[None, :] - onehot_old
    logits = (torch.log(torch.clamp(nw + beta, min=1e-10))
              + torch.log(torch.clamp(nd + alpha, min=1e-10))
              - torch.log(torch.clamp(nk + vocab_size * beta, min=1e-10)))
    return torch.argmax(noise + logits, dim=-1)


def _counts(index: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[rows, cols] int64 counts of the flat ``index`` (row * cols + col):
    integer atomics, so the result does not depend on launch order."""
    return torch.bincount(index, minlength=rows * cols).view(rows, cols)


class LDA:
    def __init__(self, cfg: LDAConfig, num_docs: int, vocab_size: int,
                 gumbel: Optional[Gumbel] = None):
        check(vocab_size >= 2 and cfg.num_topics >= 2, "degenerate LDA")
        self.cfg = cfg
        self.V = vocab_size
        self.D = num_docs
        K = cfg.num_topics
        self.word_topic = mv.create_table(MatrixTableOption(
            vocab_size, K, name="lda_word_topic"))
        self.topic = mv.create_table(ArrayTableOption(K, name="lda_topic"))
        self.device = self.word_topic.store.device
        # doc-topic counts are worker-local (lightLDA keeps them local too)
        self.doc_topic = torch.zeros((num_docs, K), dtype=torch.float32,
                                     device=self.device)
        self._gumbel = gumbel
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self.blocks = 0         # blocks sampled so far (the noise index)

    def _tokens(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    def _noise(self, n: int) -> torch.Tensor:
        shape = (n, self.cfg.num_topics)
        if self._gumbel is not None:
            g = self._gumbel(self.blocks, shape)
            g = g if torch.is_tensor(g) else torch.as_tensor(
                np.array(g, dtype=np.float32))
            return g.to(device=self.device, dtype=torch.float32)
        u = torch.rand(shape, generator=self._gen, device=self.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    # -- data layout -------------------------------------------------------
    def init_assignments(self, words, docs) -> torch.Tensor:
        """Random initial topics (numpy, seeded as in the JAX package) and
        the tables seeded with their counts — touched rows only: at
        lightLDA scale (V=1M, K=1000) a dense [V, K] push is 4 GB; the
        corpus vocabulary is what actually has counts."""
        words, docs = self._tokens(words), self._tokens(docs)
        K = self.cfg.num_topics
        topics = torch.as_tensor(
            self._rng.integers(0, K, size=len(words)).astype(np.int32),
            device=self.device).to(torch.int64)
        uw, inv = torch.unique(words, return_inverse=True)
        self.word_topic.add_rows(
            uw, _counts(inv * K + topics, len(uw), K).to(torch.float32))
        self.topic.add(torch.bincount(topics, minlength=K)
                       .to(torch.float32))
        self.doc_topic += _counts(docs * K + topics, self.D, K).to(
            torch.float32)
        return topics

    def block_counts(self, w: torch.Tensor, d: torch.Tensor):
        """The pull of one block: fresh global counts for the block's
        UNIQUE words (per-block traffic O(unique x K), the lightLDA scale
        contract) fanned out to its tokens, the topic totals and the
        tokens' doc rows. Returns (uw, inv, n_wk, n_k, n_dk)."""
        uw, inv = torch.unique(w, return_inverse=True)
        n_wk = self.word_topic.raw_rows(uw)[inv]
        return uw, inv, n_wk, self.topic.raw(), self.doc_topic[d]

    def _push(self, uw, inv, d, t, new_t) -> None:
        """Count deltas (new - old) for EXACTLY the words and docs this
        block touched (lightLDA's push shape)."""
        K = self.cfg.num_topics
        U = len(uw)
        self.word_topic.add_rows(
            uw, (_counts(inv * K + new_t, U, K) - _counts(inv * K + t, U, K))
            .to(torch.float32))
        self.topic.add((torch.bincount(new_t, minlength=K)
                        - torch.bincount(t, minlength=K)).to(torch.float32))
        ud, dinv = torch.unique(d, return_inverse=True)
        self.doc_topic[ud] += (_counts(dinv * K + new_t, len(ud), K)
                               - _counts(dinv * K + t, len(ud), K)).to(
            torch.float32)

    # -- training ----------------------------------------------------------
    def train(self, words, docs, iterations: Optional[int] = None,
              topics: Optional[torch.Tensor] = None) -> dict:
        """words/docs: flat int arrays, one entry per token occurrence.
        ``topics``: assignments from :meth:`init_assignments` (the tables
        already hold their counts); by default the tables are seeded here.
        Returns the final topics (int32 numpy) and tokens/sec."""
        words, docs = self._tokens(words), self._tokens(docs)
        check(len(words) == len(docs), "words/docs length mismatch")
        iterations = iterations or self.cfg.iterations
        if topics is None:
            topics = self.init_assignments(words, docs)
        B = self.cfg.block_tokens
        t0 = time.perf_counter()
        for _ in range(iterations):
            for start in range(0, len(words), B):
                w = words[start:start + B]
                d = docs[start:start + B]
                t = topics[start:start + B]
                uw, inv, n_wk, n_k, n_dk = self.block_counts(w, d)
                new_t = gibbs_step(n_wk, n_k, n_dk, t, self._noise(len(t)),
                                   self.V, self.cfg.alpha, self.cfg.beta)
                self.blocks += 1
                self._push(uw, inv, d, t, new_t)
                topics[start:start + B] = new_t
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return {"topics": topics.to(torch.int32).cpu().numpy(),
                "tokens_per_sec": len(words) * iterations / max(elapsed,
                                                                1e-9),
                "seconds": elapsed}

    # -- inspection --------------------------------------------------------
    def topic_word(self) -> np.ndarray:
        """[K, V] topic-word distribution (normalized counts + beta)."""
        counts = self.word_topic.get().T + self.cfg.beta
        return counts / counts.sum(axis=1, keepdims=True)

    def top_words(self, topic_id: int, topn: int = 10) -> List[int]:
        dist = self.topic_word()[topic_id]
        return list(np.argsort(-dist)[:topn])
