"""Word2vec communication planes: the shared touched-row machinery and
the pure-PS (pull-train-push) client plane.

Port of ``multiverso_tpu/models/word2vec/commplane.py``. The helpers
(numpy, the JAX module's arrays bit for bit) give the touched-row sets of
the input and output tables and the remapped per-batch step arguments;
``models/word2vec/distributed.py::DistributedWord2Vec`` (the
cross-process deployment of the same plane) uses them too, so the two
paths cannot drift. :class:`PSPlaneTrainer` is ``comm_policy=ps``: the
reference communicator loop
(``Applications/WordEmbedding/src/communicator.cpp:117-202``) in-process
against the worker-table client API. The ``hybrid`` and
``model_average`` planes live in ``model.py``.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.telemetry import span
from multiverso_tpu_torch.utils.log import log

_WORDCOUNT_KEY = 0


def bucketed_unique(values: np.ndarray) -> np.ndarray:
    """Unique ids padded to a power of two (repeat-last padding) so the
    pulled sub-matrices keep a few shapes, not one per block."""
    ids = np.unique(values)
    bucket = 1 << int(np.ceil(np.log2(max(len(ids), 1))))
    return np.concatenate(
        [ids, np.full(bucket - len(ids), ids[-1], ids.dtype)])


def hs_codes(huffman, max_code_length: int, words: np.ndarray,
             mask: np.ndarray):
    """Huffman (points, codes, length-mask) streams for a batch of target
    word ids — the HS step's table-side inputs."""
    points = huffman.points[words]
    codes = huffman.codes[words]
    lmask = ((np.arange(max_code_length)[None, :] <
              huffman.lengths[words][:, None])
             .astype(np.float32) * mask[:, None])
    return points, codes, lmask


def collect_and_remap(batches: Sequence, sg: bool, hs: bool, huffman,
                      max_code_length: int
                      ) -> Tuple[np.ndarray, np.ndarray, List[tuple]]:
    """Per-variant touched-row sets for the input/output tables and the
    remapped per-batch step args (ids_in, ids_out, group). Input and
    output tables have separate id spaces (HS output rows are Huffman
    inner nodes), so each gets its own set."""
    if sg:
        ids_in = bucketed_unique(
            np.concatenate([b.centers for b in batches]))
    else:
        ids_in = bucketed_unique(
            np.concatenate([b.contexts.reshape(-1) for b in batches]))
    if hs:
        targets = [b.contexts if sg else b.centers for b in batches]
        points_all = np.concatenate(
            [huffman.points[t].reshape(-1) for t in targets])
        ids_out = bucketed_unique(points_all)
    else:
        if sg:
            ids_out = bucketed_unique(np.concatenate(
                [np.concatenate([b.contexts, b.negatives.reshape(-1)])
                 for b in batches]))
        else:
            ids_out = bucketed_unique(np.concatenate(
                [np.concatenate([b.centers, b.negatives.reshape(-1)])
                 for b in batches]))

    def rm_in(x):
        return np.searchsorted(ids_in, x).astype(np.int32)

    def rm_out(x):
        return np.searchsorted(ids_out, x).astype(np.int32)

    group = []
    for b in batches:
        if sg and not hs:
            group.append((rm_in(b.centers), rm_out(b.contexts),
                          rm_out(b.negatives), b.mask))
        elif sg and hs:
            points, codes, lmask = hs_codes(huffman, max_code_length,
                                            b.contexts, b.mask)
            group.append((rm_in(b.centers), rm_out(points), codes, lmask))
        elif not sg and not hs:
            group.append((rm_out(b.centers), rm_in(b.contexts),
                          b.context_mask, rm_out(b.negatives), b.mask))
        else:
            points, codes, lmask = hs_codes(huffman, max_code_length,
                                            b.centers, b.mask)
            # centers are unused by the cbow-hs step (tables are indexed
            # via contexts and points only)
            group.append((b.centers, rm_in(b.contexts), b.context_mask,
                          rm_out(points), codes, lmask))
    return ids_in, ids_out, group


class PSPlaneTrainer:
    """``comm_policy=ps``: the reference's worker loop against the
    in-process tables — every parameter byte crosses the client push/pull
    plane (host round trips, counted in ``comm.ps.*``). A block pulls
    exactly its touched rows (``get_rows``), trains on the pulled
    sub-matrices on the Zoo's device with the variant's plain step over
    the block's batches in order (the JAX package's jitted ``lax.scan``;
    it pads the group to a power of two with masked-out batches, which
    change no table, so the port runs the real batches only), and pushes
    the deltas back (``add_rows``)."""

    def __init__(self, w2v):
        self.w2v = w2v
        self.cfg = w2v.cfg
        self._adagrad = w2v._adagrad

    def _train_block(self, block) -> Tuple[int, int, object]:
        """Pull touched rows -> train on the sub-matrices -> push deltas.
        Returns (words, pairs, device loss or None)."""
        w2v, cfg = self.w2v, self.cfg
        batches = list(w2v.generator.batches(block))
        words = sum(len(s) for s in block)
        if not batches:
            return words, 0, None
        ids_in, ids_out, group = collect_and_remap(
            batches, cfg.sg, cfg.hs, w2v.huffman, cfg.max_code_length)
        pairs = sum(b.n_words for b in batches)

        # Pull exactly the touched rows through the client plane
        # (RequestParameter, communicator.cpp:117-155).
        pulled = [w2v.input_table.get_rows(ids_in),
                  w2v.output_table.get_rows(ids_out)]
        if self._adagrad:
            pulled += [w2v.adagrad_in.get_rows(ids_in),
                       w2v.adagrad_out.get_rows(ids_out)]
        else:
            pulled += [np.zeros_like(pulled[0]), np.zeros_like(pulled[1])]

        dev = w2v.device
        local = [torch.tensor(t, dtype=torch.float32, device=dev)
                 for t in pulled]
        args = [torch.as_tensor(np.stack([b[i] for b in group]), device=dev)
                for i in range(len(group[0]))]
        lr = torch.tensor(np.float32(w2v._current_lr() * w2v._push_scale),
                          device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(len(group)):
            loss = loss + w2v._raw(*local, *[a[k] for a in args], lr)
        new = [t.cpu().numpy() for t in local]

        # Push the deltas back (AddDeltaParameter, communicator.cpp:
        # 157-202). The lr already carries the push scale, so the deltas
        # ship raw.
        w2v.input_table.add_rows(ids_in, new[0] - pulled[0])
        w2v.output_table.add_rows(ids_out, new[1] - pulled[1])
        if self._adagrad:
            w2v.adagrad_in.add_rows(ids_in, new[2] - pulled[2])
            w2v.adagrad_out.add_rows(ids_out, new[3] - pulled[3])
        return words, pairs, loss

    def train(self, sentences, corpus_path, epochs) -> dict:
        from multiverso_tpu_torch.models.word2vec.data import BlockStream

        w2v, cfg = self.w2v, self.cfg
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        total_pairs = 0
        for _ in range(epochs):
            for block in BlockStream(w2v._sentences(sentences, corpus_path),
                                     cfg.block_words,
                                     prefetch=cfg.pipeline):
                with span("w2v.ps_block"):
                    words, pairs, loss = self._train_block(block)
                if loss is not None:
                    losses.append(loss)
                total_pairs += pairs
                w2v.trained_words += words
                if words:
                    w2v.wordcount_table.add([_WORDCOUNT_KEY], [words])
        elapsed = time.perf_counter() - t0
        w2v.words_per_sec = w2v.trained_words / max(elapsed, 1e-9)
        mean_loss = (float(torch.stack(losses[-50:]).mean())
                     if losses else 0.0)
        log.info("word2vec[ps plane]: %d words, %d pairs, %.0f words/sec,"
                 " loss=%.4f", w2v.trained_words, total_pairs,
                 w2v.words_per_sec, mean_loss)
        return {"words": w2v.trained_words, "pairs": total_pairs,
                "words_per_sec": w2v.words_per_sec, "loss": mean_loss,
                "seconds": elapsed, "comm_mode": "ps"}
