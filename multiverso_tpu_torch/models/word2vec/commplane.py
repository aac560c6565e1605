"""Word2vec's touched-row machinery, shared by the pull-train-push planes.

Port of the helpers of ``multiverso_tpu/models/word2vec/commplane.py``
(numpy, the JAX module's arrays bit for bit): the touched-row sets of the
input and output tables, and the remapped per-batch step arguments.
``models/word2vec/distributed.py::DistributedWord2Vec`` (the
cross-process deployment) uses them; the
in-process ``ps`` plane trainer of the JAX module (``PSPlaneTrainer``) and
the comm policies wait for the collective plane (ROADMAP A7).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


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
