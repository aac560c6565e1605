"""Vocabulary, Huffman coding, and negative-sampling tables for word2vec.

Parity with the reference WordEmbedding helpers
(``Applications/WordEmbedding/src/``): ``Dictionary`` (word->id with
min_count filtering, ``dictionary.cpp``), ``HuffmanEncoder`` (codes/points
for hierarchical softmax, ``huffman_encoder.cpp``), ``Sampler`` (unigram^0.75
negative-sampling table, ``sampler.cpp``), and the frequent-word subsampling
probability (``distributed_wordembedding``'s ``sample`` option).

Port note: all of this is host-side numpy preprocessing, copied unchanged
from the JAX package; outputs are int32 arrays the device step consumes.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class Dictionary:
    def __init__(self, min_count: int = 5):
        self.min_count = min_count
        self.word2id: Dict[str, int] = {}
        self.words: List[str] = []
        self.counts: List[int] = []

    @classmethod
    def build(cls, corpus: Iterable[Sequence[str]],
              min_count: int = 5) -> "Dictionary":
        counter: Counter = Counter()
        for sentence in corpus:
            counter.update(sentence)
        d = cls(min_count)
        # Most-frequent-first ids (reference sorts by count).
        for word, count in counter.most_common():
            if count < min_count:
                break
            d.word2id[word] = len(d.words)
            d.words.append(word)
            d.counts.append(count)
        return d

    @classmethod
    def synthetic_zipf(cls, vocab_size: int, n_words: int):
        """A fabricated Zipf-ranked vocabulary for benchmarks (the
        zero-egress image has no text8; natural text is Zipf-shaped).
        Returns ``(dictionary, probs)`` with ``probs`` the rank-frequency
        distribution to sample synthetic sentences from."""
        zipf = 1.0 / np.arange(1, vocab_size + 1)
        zipf /= zipf.sum()
        d = cls(min_count=1)
        d.words = [f"w{i}" for i in range(vocab_size)]
        d.word2id = {w: i for i, w in enumerate(d.words)}
        d.counts = np.maximum((zipf * n_words).astype(int), 1).tolist()
        return d, zipf

    def __len__(self) -> int:
        return len(self.words)

    def encode(self, sentence: Sequence[str]) -> List[int]:
        w2i = self.word2id
        return [w2i[w] for w in sentence if w in w2i]

    @property
    def total_count(self) -> int:
        return sum(self.counts)


class HuffmanEncoder:
    """Binary Huffman codes over word frequencies.

    For word w: ``points[w]`` are the inner-node ids on the root path,
    ``codes[w]`` the binary branch labels. Padded to ``max_code_length`` with
    mask. Inner node count = vocab - 1 (ref huffman_encoder.cpp).
    """

    def __init__(self, counts: Sequence[int], max_code_length: int = 40):
        vocab = len(counts)
        assert vocab >= 2, "huffman needs at least 2 words"
        # Heap of (count, tie, node_id); leaves 0..V-1, inner V..2V-2.
        heap: List[Tuple[int, int, int]] = [
            (c, i, i) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        parent = {}
        branch = {}
        next_id = vocab
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1], branch[n1] = next_id, 0
            parent[n2], branch[n2] = next_id, 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        self.num_inner = next_id - vocab   # == vocab - 1

        self.max_code_length = max_code_length
        self.points = np.zeros((vocab, max_code_length), dtype=np.int32)
        self.codes = np.zeros((vocab, max_code_length), dtype=np.float32)
        self.lengths = np.zeros(vocab, dtype=np.int32)
        for w in range(vocab):
            path: List[int] = []
            bits: List[int] = []
            node = w
            while node != root:
                bits.append(branch[node])
                node = parent[node]
                path.append(node - vocab)  # inner-node index
            # Root-to-leaf order.
            path.reverse()
            bits.reverse()
            L = min(len(path), max_code_length)
            self.lengths[w] = L
            self.points[w, :L] = path[:L]
            self.codes[w, :L] = bits[:L]


class Sampler:
    """Unigram^0.75 negative-sampling table (ref sampler.cpp) plus the
    frequent-word subsampling keep-probability."""

    def __init__(self, counts: Sequence[int], table_size: int = 1 << 20,
                 power: float = 0.75, seed: int = 0):
        counts = np.asarray(counts, dtype=np.float64)
        probs = counts ** power
        probs /= probs.sum()
        # Alias-free CDF table (the classic word2vec int table).
        self.table = np.searchsorted(
            np.cumsum(probs), np.linspace(0, 1, table_size,
                                          endpoint=False)).astype(np.int32)
        np.clip(self.table, 0, len(counts) - 1, out=self.table)
        self._rng = np.random.default_rng(seed)
        self.vocab = len(counts)

    def sample(self, shape) -> np.ndarray:
        idx = self._rng.integers(0, len(self.table), size=shape)
        return self.table[idx]

    @staticmethod
    def keep_probability(counts: Sequence[int], sample: float = 1e-3
                         ) -> np.ndarray:
        """P(keep word) for subsampling (word2vec formula)."""
        counts = np.asarray(counts, dtype=np.float64)
        freq = counts / counts.sum()
        if sample <= 0:
            return np.ones_like(freq)
        ratio = sample / np.maximum(freq, 1e-12)
        return np.minimum(1.0, np.sqrt(ratio) + ratio)
