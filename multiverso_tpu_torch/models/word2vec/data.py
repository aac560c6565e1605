"""Word2vec data pipeline: sentence streaming, pair/batch generation.

Parity with the reference's data-block pipeline
(``Applications/WordEmbedding/src/distributed_wordembedding.cpp:33-56``:
loader thread fills a bounded ``BlockQueue`` of sentence blocks;
``data_block.cpp``): blocks of sentences stream through a background
prefetcher; each block becomes fixed-shape int32 batches for the jitted step
(static shapes — XLA requirement; the reference's variable-length loops
become padded/masked tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Sequence

import numpy as np

from multiverso_tpu_torch.models.word2vec.dictionary import Dictionary, Sampler
from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer


def read_corpus(path: str, max_sentence_length: int = 1000
                ) -> Iterator[List[str]]:
    """Lines -> token lists, long lines split at max_sentence_length."""
    with open(path) as f:
        for line in f:
            tokens = line.split()
            for i in range(0, len(tokens), max_sentence_length):
                chunk = tokens[i:i + max_sentence_length]
                if chunk:
                    yield chunk


@dataclasses.dataclass
class SkipGramBatch:
    centers: np.ndarray     # [B] int32
    contexts: np.ndarray    # [B] int32
    negatives: np.ndarray   # [B, K] int32
    mask: np.ndarray        # [B] float32 (0 = padding)
    n_words: int            # real (unpadded) training pairs


@dataclasses.dataclass
class CbowBatch:
    centers: np.ndarray        # [B] int32 (the predicted word)
    contexts: np.ndarray       # [B, 2W] int32
    context_mask: np.ndarray   # [B, 2W] float32
    negatives: np.ndarray      # [B, K] int32
    mask: np.ndarray           # [B] float32
    n_words: int


class BatchGenerator:
    """Turns sentences of word-ids into fixed-shape training batches."""

    def __init__(self, dictionary: Dictionary, batch_size: int = 1024,
                 window: int = 5, negative: int = 5, sample: float = 1e-3,
                 sg: bool = True, seed: int = 0):
        self.dict = dictionary
        self.batch_size = batch_size
        self.window = window
        self.negative = negative
        self.sg = sg
        self._rng = np.random.default_rng(seed)
        self.sampler = Sampler(dictionary.counts, seed=seed + 1)
        self.keep_prob = Sampler.keep_probability(dictionary.counts, sample)

    # -- pair extraction ---------------------------------------------------
    def _subsample(self, ids: np.ndarray) -> np.ndarray:
        if len(ids) == 0:
            return ids
        keep = self._rng.random(len(ids)) < self.keep_prob[ids]
        return ids[keep]

    def _sentence_pairs(self, ids: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """All (center, context) pairs with the reference's per-center shrunk
        dynamic window — vectorized: one mask per offset distance instead of
        a per-position Python loop (the reference's scalar loop shape,
        wordembedding.cpp:120-135, would bottleneck the device feed)."""
        n = len(ids)
        if n < 2:
            empty = np.empty(0, dtype=np.int32)
            return empty, empty
        windows = self._rng.integers(1, self.window + 1, size=n)
        centers: List[np.ndarray] = []
        contexts: List[np.ndarray] = []
        for d in range(1, self.window + 1):
            if d >= n:
                break
            keep = windows[:-d] >= d      # center i, context i+d
            centers.append(ids[:-d][keep])
            contexts.append(ids[d:][keep])
            keep = windows[d:] >= d       # center i+d, context i
            centers.append(ids[d:][keep])
            contexts.append(ids[:-d][keep])
        return (np.concatenate(centers).astype(np.int32),
                np.concatenate(contexts).astype(np.int32))

    # -- batches -----------------------------------------------------------
    def batches(self, sentences: Iterable[Sequence[int]]
                ) -> Iterator[SkipGramBatch | CbowBatch]:
        if self.sg:
            yield from self._skipgram_batches(sentences)
        else:
            yield from self._cbow_batches(sentences)

    def _skipgram_batches(self, sentences):
        B = self.batch_size
        pending: List[np.ndarray] = []   # interleaved [centers, contexts]
        buffered = 0
        for sentence in sentences:
            ids = self._subsample(np.asarray(sentence, dtype=np.int32))
            c, o = self._sentence_pairs(ids)
            if len(c) == 0:
                continue
            pending.append(np.stack([c, o]))
            buffered += len(c)
            while buffered >= B:
                stacked = np.concatenate(pending, axis=1)
                yield self._emit_sg(stacked[0, :B], stacked[1, :B])
                rest = stacked[:, B:]
                pending = [rest] if rest.shape[1] else []
                buffered = rest.shape[1]
        if buffered:
            stacked = np.concatenate(pending, axis=1)
            yield self._emit_sg(stacked[0], stacked[1])

    def _emit_sg(self, centers, contexts) -> SkipGramBatch:
        B, K = self.batch_size, self.negative
        n = len(centers)
        c = np.zeros(B, dtype=np.int32)
        o = np.zeros(B, dtype=np.int32)
        m = np.zeros(B, dtype=np.float32)
        c[:n] = centers
        o[:n] = contexts
        m[:n] = 1.0
        neg = self.sampler.sample((B, K)).astype(np.int32)
        return SkipGramBatch(c, o, neg, m, n)

    def _cbow_batches(self, sentences):
        B, K, W = self.batch_size, self.negative, self.window
        rows: List[tuple] = []
        for sentence in sentences:
            ids = self._subsample(np.asarray(sentence, dtype=np.int32))
            n = len(ids)
            if n < 2:
                continue
            windows = self._rng.integers(1, W + 1, size=n)
            for pos in range(n):
                w = windows[pos]
                ctx = [ids[j] for j in range(max(0, pos - w),
                                             min(n, pos + w + 1)) if j != pos]
                if ctx:
                    rows.append((ids[pos], ctx))
                if len(rows) == B:
                    yield self._emit_cbow(rows)
                    rows = []
        if rows:
            yield self._emit_cbow(rows)

    def _emit_cbow(self, rows) -> CbowBatch:
        B, K, W = self.batch_size, self.negative, self.window
        n = len(rows)
        centers = np.zeros(B, dtype=np.int32)
        contexts = np.zeros((B, 2 * W), dtype=np.int32)
        cmask = np.zeros((B, 2 * W), dtype=np.float32)
        mask = np.zeros(B, dtype=np.float32)
        for i, (center, ctx) in enumerate(rows):
            centers[i] = center
            L = min(len(ctx), 2 * W)
            contexts[i, :L] = ctx[:L]
            cmask[i, :L] = 1.0
            mask[i] = 1.0
        neg = self.sampler.sample((B, K)).astype(np.int32)
        return CbowBatch(centers, contexts, cmask, neg, mask, n)


class BlockStream:
    """Sentence blocks of ~block_words words with background prefetch —
    the BlockQueue analog (bounded by one block in flight)."""

    def __init__(self, sentences: Iterable[Sequence[int]],
                 block_words: int = 100_000, prefetch: bool = True):
        self._sentences = sentences
        self.block_words = block_words
        self.prefetch = prefetch

    def _blocks(self) -> Iterator[List[Sequence[int]]]:
        block: List[Sequence[int]] = []
        count = 0
        for s in self._sentences:
            block.append(s)
            count += len(s)
            if count >= self.block_words:
                yield block
                block, count = [], 0
        if block:
            yield block

    def __iter__(self) -> Iterator[List[Sequence[int]]]:
        if not self.prefetch:
            yield from self._blocks()
            return
        it = self._blocks()
        buf: ASyncBuffer = ASyncBuffer(lambda: next(it, None))
        try:
            while True:
                item = buf.get()
                if item is None:
                    return
                yield item
        finally:
            buf.close()
