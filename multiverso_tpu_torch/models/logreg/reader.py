"""Sample readers: libsvm / dense / weight / bsparse formats, async prefetch.

Port of ``multiverso_tpu/models/logreg/reader.py`` (numpy only).

Parity with ``Applications/LogisticRegression/src/reader.cpp`` (async
``SampleReader`` buffers consumed by the epoch loop, ``logreg.cpp:46-60``)
and ALL its input formats (``configure.h:57-69``):

* ``libsvm`` — ``label key:value ...``
* ``dense``  — ``label value value ...``
* ``weight`` — ``label:weight key:value ...`` (values scaled by the
  sample weight, WeightedSampleReader, ``reader.cpp:243-281``)
* ``bsparse`` — BINARY sparse samples, each
  ``count(u64) label(i32) weight(f64) key(u64)*count`` with implicit
  feature value 1 x weight (BSparseSampleReader, ``configure.h:67-69``).

Minibatches are materialized as **dense [B, F] float32 arrays** (sparse
indices scattered on the host) so each step is one matrix product on the
device; the background thread is the ``ASyncBuffer`` analog.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer
from multiverso_tpu_torch.utils.log import check

_BSPARSE_HEAD = struct.Struct("<Qid")   # count, label, weight


def parse_libsvm_line(line: str) -> Tuple[float, List[int], List[float]]:
    parts = line.split()
    label = float(parts[0])
    idx, val = [], []
    for tok in parts[1:]:
        i, _, v = tok.partition(":")
        idx.append(int(i))
        val.append(float(v))
    return label, idx, val


def parse_weight_line(line: str) -> Tuple[float, float,
                                          List[int], List[float]]:
    """``label:weight key:value ...`` (ref WeightedSampleReader) — the
    libsvm tokenizer with the sample weight scaled into the values."""
    parts = line.split()    # any whitespace, like every other text format
    label_s, _, weight_s = parts[0].partition(":")
    weight = float(weight_s) if weight_s else 1.0
    _, idx, val = parse_libsvm_line(" ".join(["0"] + parts[1:]))
    return float(label_s), weight, idx, [v * weight for v in val]


def write_bsparse(path: str,
                  samples: Iterable[Tuple[float, float, Iterable[int]]]
                  ) -> int:
    """Serialize ``(label, weight, keys)`` samples in the reference's
    bsparse layout; returns the sample count (round-trip tested)."""
    n = 0
    with open(path, "wb") as f:
        for label, weight, keys in samples:
            keys = np.asarray(list(keys), dtype="<u8")
            f.write(_BSPARSE_HEAD.pack(len(keys), int(label),
                                       float(weight)))
            f.write(keys.tobytes())
            n += 1
    return n


def read_bsparse(path: str) -> Iterator[Tuple[float, float, np.ndarray]]:
    """Stream ``(label, weight, keys)`` from a bsparse file."""
    import os
    remaining = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            head = f.read(_BSPARSE_HEAD.size)
            if not head:
                return
            check(len(head) == _BSPARSE_HEAD.size,
                  "truncated bsparse sample header")
            remaining -= _BSPARSE_HEAD.size
            count, label, weight = _BSPARSE_HEAD.unpack(head)
            # Sanity-bound the untrusted count BEFORE reading: a corrupt
            # or non-bsparse file must fail the check, not attempt a
            # multi-gigabyte read.
            check(8 * count <= remaining,
                  f"corrupt bsparse sample: count {count} exceeds "
                  "remaining file size")
            raw = f.read(8 * count)
            check(len(raw) == 8 * count, "truncated bsparse key block")
            remaining -= 8 * count
            yield float(label), weight, np.frombuffer(raw, dtype="<u8")


def parse_dense_line(line: str) -> Tuple[float, np.ndarray]:
    parts = line.split()
    return float(parts[0]), np.asarray(parts[1:], dtype=np.float32)


class SampleReader:
    """Streams (X, y) minibatches from a file; prefetches in background."""

    def __init__(self, path: str, num_feature: int, minibatch_size: int,
                 input_format: str = "libsvm", bias: bool = True,
                 prefetch: bool = True,
                 shard: Optional[Tuple[int, int]] = None):
        check(input_format in ("libsvm", "dense", "weight", "bsparse"),
              f"unknown input format '{input_format}'")
        self.path = path
        self.num_feature = num_feature
        self.minibatch_size = minibatch_size
        self.format = input_format
        self.bias = bias
        self.prefetch = prefetch
        self.width = num_feature + (1 if bias else 0)
        # (rank, world): stream only every world-th sample — the
        # distributed ranks' data split
        self.shard = shard

    def _mine(self, sampleno: int) -> bool:
        return self.shard is None or \
            sampleno % self.shard[1] == self.shard[0]

    def _samples(self) -> Iterator[Tuple[float, np.ndarray]]:
        """(label, dense row) for THIS RANK's samples. The shard filter
        runs before any text parse or densify so a world-of-N rank pays
        ~1/N of the input-pipeline cost, not all of it."""
        if self.format == "bsparse":
            for n, (label, weight, keys) in enumerate(
                    read_bsparse(self.path)):
                if not self._mine(n):
                    continue    # framing read only; densify skipped
                dense = np.zeros(self.width, dtype=np.float32)
                valid = keys[keys < self.num_feature].astype(np.int64)
                dense[valid] = np.float32(weight)   # implicit value 1 x w
                yield label, dense
            return
        with open(self.path) as f:
            n = -1      # sample counter over non-empty lines
            for line in f:
                line = line.strip()
                if not line:
                    continue
                n += 1
                if not self._mine(n):
                    continue
                if self.format == "libsvm":
                    label, idx, val = parse_libsvm_line(line)
                elif self.format == "weight":
                    label, _, idx, val = parse_weight_line(line)
                else:
                    label, vals = parse_dense_line(line)
                    dense = np.zeros(self.width, dtype=np.float32)
                    dense[:min(len(vals), self.num_feature)] = \
                        vals[:self.num_feature]
                    yield label, dense
                    continue
                dense = np.zeros(self.width, dtype=np.float32)
                for i, v in zip(idx, val):
                    if i < self.num_feature:
                        dense[i] = v
                yield label, dense

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rows_x: List = []
        rows_y: List[float] = []
        for label, dense in self._samples():
            if self.bias:
                dense[-1] = 1.0
            rows_x.append(dense)
            rows_y.append(label)
            if len(rows_x) == self.minibatch_size:
                yield np.stack(rows_x), np.asarray(rows_y,
                                                   dtype=np.float32)
                rows_x, rows_y = [], []
        if rows_x:
            yield np.stack(rows_x), np.asarray(rows_y, dtype=np.float32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if not self.prefetch:
            yield from self._batches()
            return
        it = self._batches()
        buf: ASyncBuffer = ASyncBuffer(lambda: next(it, None))
        try:
            while True:
                item = buf.get()
                if item is None:
                    return
                yield item
        finally:
            buf.close()


class ArrayBatcher:
    """In-memory (X, y) minibatch iterator — for tests and synthetic data."""

    def __init__(self, X: np.ndarray, y: np.ndarray, minibatch_size: int,
                 bias: bool = True):
        if bias:
            X = np.concatenate(
                [X, np.ones((len(X), 1), dtype=X.dtype)], axis=1)
        self.X = np.asarray(X, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.float32)
        self.bs = minibatch_size

    def __iter__(self):
        for i in range(0, len(self.X), self.bs):
            yield self.X[i:i + self.bs], self.y[i:i + self.bs]
