"""Word2vec (distributed WordEmbedding) — the flagship workload.

Port of ``multiverso_tpu/models/word2vec/model.py`` for one process:
skip-gram and CBOW, negative sampling and hierarchical softmax, over the
five reference tables (input/output embedding matrices, two AdaGrad
accumulator matrices, the word-count KV table), a words/sec metric,
linear lr decay for SGD and batched embedding export. The embeddings may
be stored in bfloat16 (``param_dtype``); the math and the AdaGrad
accumulators stay float32, and each step is rounded to the table's dtype
before it is added (duplicate rows fold in lane order, rounding after
every add, as XLA's scatter does: ``ops/rows.add_rows_sorted``).

Two training paths, as in the JAX package:

* the **device pipeline** (``device_pipeline=True``): each block of
  sentences becomes examples on the device (subsampling, the per-center
  shrunk window, for CBOW the context rows and masks, optional compaction
  of the valid examples to the front, row-gathered unigram negatives or
  the Huffman point/code/length gathers), then a chunk loop trains it:

  - ``pallas_grid`` (AUTO on a card for sg-ns) — the hand-written
    whole-block CUDA kernel (``ops/sgns.py``, B5), one launch per block,
    float32 or bfloat16 tables;
  - ``in_graph`` / ``pipelined_host`` — the plain torch chunk loop. In
    the JAX package the three sg-ns modes are bitwise-equal executions of
    one step; in the port the two plain modes are the same loop. hs and
    CBOW have no kernel in the JAX package (AUTO sends them to its XLA
    block step), so the plain loop is their counterpart, on a card too.

* the **host batch path** (``device_pipeline=False``, the config's
  default): ``BatchGenerator`` builds fixed-shape batches on the host,
  groups of ``scan_group`` batches go to the device stacked, and a loop of
  the raw step trains each group (the JAX package's ``lax.scan``).

Pair generation is split so a test can hand the JAX package's random
numbers to the port: :func:`draw_pair_randoms` draws from a
``torch.Generator``, and :func:`block_streams` / :func:`pair_gen` build
the streams from the drawn tensors.

Communication planes (``comm_policy``, :func:`resolve_w2v_comm`): None
keeps the fused in-store plane; ``auto``/``hybrid`` keeps it for the four
sparse tables and merges the dense word count through one collective a
block (``comm_policy.build_dense_sync`` over the Zoo's rank mesh);
``model_average`` trains each rank's replicas fused and averages them over
the world's ranks at every epoch's end; ``ps`` pulls, trains and pushes
each block through the table clients (``commplane.PSPlaneTrainer``).

Not ported yet: a dp x tp mesh (``mesh_data x mesh_model > 1``), which
raises ``NotImplementedError`` (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.core.options import KVTableOption, MatrixTableOption
from multiverso_tpu_torch.core.table import torch_dtype
from multiverso_tpu_torch.core.updater import _sqrt
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.models.word2vec.data import (BatchGenerator,
                                                       BlockStream,
                                                       SkipGramBatch,
                                                       read_corpus)
from multiverso_tpu_torch.models.word2vec.dictionary import (Dictionary,
                                                             HuffmanEncoder,
                                                             Sampler)
from multiverso_tpu_torch.ops.rows import (add_rows_sorted, sort_rows,
                                          wrap_row_ids)
from multiverso_tpu_torch.ops.sgns import (build_sgns_grid_step,
                                           sgns_grid_eligible)
from multiverso_tpu_torch.telemetry import span
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.utils.log import check, log

_EPS = 1e-7
_WORDCOUNT_KEY = 0


@dataclasses.dataclass
class Word2VecConfig:
    embedding_size: int = 100
    window: int = 5
    negative: int = 5
    min_count: int = 5
    sample: float = 1e-3
    batch_size: int = 1024
    learning_rate: float = 0.05
    epochs: int = 1
    sg: bool = True                 # skip-gram vs CBOW
    hs: bool = False                # hierarchical softmax vs negative sampling
    optimizer: str = "adagrad"      # adagrad | sgd
    block_words: int = 100_000      # host batch path: words per block
    pipeline: bool = True
    param_prefetch: bool = False
    scan_group: int = 32            # host batch path: batches per group
    # Embedding storage dtype, "float32" or "bfloat16" (read by name: the
    # math and the AdaGrad accumulators stay float32).
    param_dtype: str = "float32"
    # Device pipeline: example generation on the device; the host uploads
    # raw token ids only. False: the host batch path.
    device_pipeline: bool = False
    # The in_graph block step compacts the valid examples to the front
    # and runs only the chunks that hold them (pallas_grid and
    # pipelined_host always compact, as in the JAX package).
    compact_pairs: bool = True
    # Chunk-loop execution of the device pipeline: "pallas_grid" (the B5
    # kernel, sg-ns), "in_graph" / "pipelined_host" (the plain torch
    # chunk loop), None/"auto" -> resolve_dispatch_mode.
    dispatch_mode: Optional[str] = None
    dispatch_depth: int = 8
    chunk_dispatch: Optional[bool] = None
    block_sentences: int = 512
    pad_sentence_length: int = 512
    mesh_data: int = 1
    mesh_model: int = 1
    max_code_length: int = 40
    seed: int = 0
    delta_scale: Optional[float] = None
    comm_policy: Optional[str] = None
    comm_policy_overrides: Optional[dict] = None


# ---------------------------------------------------------------------------
# Example pipeline (device)
# ---------------------------------------------------------------------------
def pair_stream_shape(S: int, L: int, window: int, chunk: int,
                      negative: int, neg_table_len: int, sg: bool = True
                      ) -> Tuple[int, int, int]:
    """``(n_chunks, rows_needed, rows_tbl)`` of a block: the static chunk
    count of the example stream (skip-gram: the pairs of every shift;
    CBOW: every token position), and the negative draw's row count out
    of a sampler table viewed as ``rows_tbl`` rows of width ``min(128,
    len)`` (0 rows for ``negative=0``, hierarchical softmax)."""
    P = (2 * sum(S * max(L - d, 0) for d in range(1, window + 1)) if sg
         else S * L)
    total = P + (-P) % chunk
    n = total // chunk
    width = min(128, neg_table_len)
    rows_tbl = neg_table_len // width
    rows_needed = -(-(n * chunk * negative) // width)
    return n, rows_needed, rows_tbl


def draw_pair_randoms(gen: torch.Generator, S: int, L: int, window: int,
                      rows_needed: int, rows_tbl: int,
                      device: torch.device):
    """The block's random numbers: keep uniforms ``[S, L]`` (subsampling),
    window draws ``[S, L]`` in ``[1, window]`` and the negative-row
    indices ``[rows_needed]`` in ``[0, rows_tbl)``."""
    keep_u = torch.rand((S, L), generator=gen, device=device)
    wpos = torch.randint(1, window + 1, (S, L), generator=gen,
                         device=device, dtype=torch.int32)
    ridx = torch.randint(0, rows_tbl, (rows_needed,), generator=gen,
                         device=device, dtype=torch.int64)
    return keep_u, wpos, ridx


def _row_gather_negatives(neg_table: torch.Tensor, ridx: torch.Tensor,
                          shape) -> torch.Tensor:
    """Unigram negatives as ROW gathers of the shuffled sampler table
    (any 128 consecutive entries are an iid unigram^0.75 sample)."""
    total = int(np.prod(shape))
    width = min(128, neg_table.shape[0])
    rows_tbl = neg_table.shape[0] // width
    table2d = neg_table[:rows_tbl * width].reshape(rows_tbl, width)
    flat = table2d.index_select(0, ridx).reshape(-1)
    return flat[:total].reshape(shape)


def _token_valid(sents, lengths, keep_prob, keep_u):
    """Positions inside the sentence and kept by subsampling."""
    pos = torch.arange(sents.shape[1], device=sents.device)[None, :]
    return (pos < lengths[:, None]) & \
        (keep_u < keep_prob[sents.to(torch.int64)])


def _pair_arrays(sents, lengths, keep_prob, keep_u, wpos, window):
    """Masked offset-shift pairing: for each distance d, (center, context)
    both ways where the center's window reaches d and both words are
    valid (in the sentence and kept by subsampling)."""
    valid = _token_valid(sents, lengths, keep_prob, keep_u)
    centers, contexts, pmask = [], [], []
    for d in range(1, window + 1):
        c = sents[:, :-d].reshape(-1)
        o = sents[:, d:].reshape(-1)
        m = ((wpos[:, :-d] >= d) & valid[:, :-d] & valid[:, d:]).reshape(-1)
        centers += [c, o]
        contexts += [o, c]
        pmask += [m, m]
    return torch.cat(centers), torch.cat(contexts), torch.cat(pmask)


def _cbow_arrays(sents, lengths, keep_prob, keep_u, wpos, window):
    """CBOW examples: every kept token position is an example whose
    context is its (randomly shrunk) window; subsampled and pad tokens
    drop out of both roles. Returns centers [S*L], contexts [S*L, 2W],
    the context mask (float32) and the example mask."""
    S = sents.shape[0]
    tok_valid = _token_valid(sents, lengths, keep_prob, keep_u)
    ctx_cols, m_cols = [], []
    for d in range(1, window + 1):
        pad_i = torch.zeros((S, d), dtype=sents.dtype, device=sents.device)
        pad_b = torch.zeros((S, d), dtype=torch.bool, device=sents.device)
        right = torch.cat([sents[:, d:], pad_i], 1)
        rmask = torch.cat([tok_valid[:, d:], pad_b], 1) & (wpos >= d)
        left = torch.cat([pad_i, sents[:, :-d]], 1)
        lmask = torch.cat([pad_b, tok_valid[:, :-d]], 1) & (wpos >= d)
        ctx_cols += [right.reshape(-1), left.reshape(-1)]
        m_cols += [rmask.reshape(-1), lmask.reshape(-1)]
    contexts = torch.stack(ctx_cols, 1)
    cmask = torch.stack(m_cols, 1)
    ex_mask = tok_valid.reshape(-1) & cmask.any(1)
    return sents.reshape(-1), contexts, cmask.to(torch.float32), ex_mask


def _compact_examples(pmask, chunk, arrays1d, arrays2d=()):
    """Stable-partition valid examples to the front across parallel
    streams, 1-D ([P] -> [n, chunk]) and 2-D ([P, C] -> [n, chunk, C]),
    by one cumsum destination map (no host sync); returns ``(out1d,
    out2d, n_examples, n)``."""
    P = pmask.shape[0]
    total = P + (-P) % chunk
    n = total // chunk
    n_ex = pmask.sum().to(torch.int32)
    dest = torch.cumsum(pmask.to(torch.int64), 0) - 1
    dest = torch.where(pmask, dest, torch.full_like(dest, total))
    out = []
    for a in (*arrays1d, *arrays2d):
        buf = torch.zeros((total + 1, *a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        buf[dest] = a                   # slot ``total`` takes the dropped
        out.append(buf[:total].reshape(n, chunk, *a.shape[1:]))
    return out[:len(arrays1d)], out[len(arrays1d):], n_ex, n


def pair_gen(neg_table, keep_prob, sents, lengths, keep_u, wpos, ridx,
             window: int, chunk: int, negative: int):
    """Pure sg-ns pair building from drawn random tensors (the B5 path):
    returns ``(centers2d [n, chunk], contexts2d [n, chunk], negatives3d
    [n, chunk, negative], n_pairs)`` with the valid pairs compacted to the
    front and ``n_pairs`` their count (a device scalar)."""
    (centers, contexts), negatives, _, n_pairs = block_streams(
        neg_table, keep_prob, sents, lengths, keep_u, wpos, ridx, window,
        chunk, negative)
    return centers, contexts, negatives, n_pairs


def block_streams(neg_table, keep_prob, sents, lengths, keep_u, wpos, ridx,
                  window: int, chunk: int, negative: int, sg: bool = True,
                  hs: bool = False, compact: bool = True):
    """Pure example building of any variant from drawn random tensors:
    returns ``(streams, negatives, mask, n_examples)``. ``streams`` are
    ``[centers, contexts]`` (skip-gram) or ``[centers, contexts, cmask]``
    (CBOW: [n, chunk, 2W] contexts and masks), ``[n, chunk(, 2W)]``;
    ``negatives`` [n, chunk, K] (None for hs); ``mask`` [n, chunk] float32
    when not compacted (None when compacted: then the first
    ``n_examples`` slots are the valid ones)."""
    if sg:
        centers, contexts, pmask = _pair_arrays(sents, lengths, keep_prob,
                                                keep_u, wpos, window)
        arrays1d, arrays2d = [centers, contexts], []
    else:
        centers, contexts, cmask, pmask = _cbow_arrays(
            sents, lengths, keep_prob, keep_u, wpos, window)
        arrays1d, arrays2d = [centers], [contexts, cmask]
    P = pmask.shape[0]
    pad = (-P) % chunk
    n = (P + pad) // chunk
    mask = None
    if compact:
        out1, out2, n_ex, n = _compact_examples(pmask, chunk, arrays1d,
                                                arrays2d)
        streams = out1 + out2
    else:
        n_ex = pmask.sum().to(torch.int32)
        streams = [torch.nn.functional.pad(a, (0, pad)).reshape(n, chunk)
                   for a in arrays1d]
        streams += [torch.nn.functional.pad(a, (0, 0, 0, pad))
                    .reshape(n, chunk, a.shape[1]) for a in arrays2d]
        mask = torch.nn.functional.pad(pmask, (0, pad)).reshape(
            n, chunk).to(torch.float32)
    negatives = (None if hs else
                 _row_gather_negatives(neg_table, ridx, (n, chunk, negative)))
    return streams, negatives, mask, n_ex


# ---------------------------------------------------------------------------
# The steps (plain torch; the chunk loop's body and B5's oracle)
# ---------------------------------------------------------------------------
def _apply_update(w, g2, rows, grad, lr, adagrad: bool, live=None) -> None:
    """In place: scatter an embedding update (+AdaGrad) for possibly
    duplicated rows — ``g2[rows] += grad^2`` over all duplicates (float32),
    then ``w[rows] += -lr*grad/sqrt(g2[rows] + 1e-6)`` with the summed g2
    (``-lr*grad`` for SGD). The step is rounded to ``w``'s dtype before
    it is added. Each row takes its duplicates one at a time in lane
    order, as XLA's scatter does, on any device (``add_rows_sorted``: on
    the card a stable sort, made once for both tables, and B4's kernel; a
    bfloat16 table rounds after every add). The adds wrap rows in
    ``[-rows, 0)`` to the table's end and drop rows still out of range,
    as ``.at[].add(mode="drop")`` does, while the AdaGrad sums are read
    with rows clamped into range, as ``take(mode="clip")`` does (ROADMAP
    C5). The lanes outside ``live`` are dropped too (the masks of the
    caller's examples, nodes or contexts, where the gradient is +-0):
    adding +-0 leaves every element as it was, since none of these tables
    holds -0.0 (the AdaGrad sums and ``w_out`` start at +0.0, ``w_in`` at
    random values, and a sum is -0.0 only if both terms are), so the
    tables keep their bits, and the pad lanes of a padded layout (every
    Huffman path padded to the longest with node 0) make no long run of
    one row on the card."""
    num_rows = w.shape[0]
    rows = rows.to(torch.int64)
    if live is not None:
        rows = torch.where(live.reshape(rows.shape) > 0, rows,
                           torch.full_like(rows, num_rows))
    sort = (sort_rows(wrap_row_ids(rows, num_rows), num_rows) if w.is_cuda
            and (adagrad or w.dtype == torch.float32) else None)
    if adagrad:
        add_rows_sorted(g2, rows, torch.square(grad), sort=sort)
        denom = _sqrt(g2.index_select(0, rows.clamp(0, num_rows - 1))
                      + 1e-6)
        step = -lr * grad / denom
    else:
        step = -lr * grad
    add_rows_sorted(w, rows, step, sort=sort)


def _ns_grads(u, v_pos, v_neg, mask):
    """Negative-sampling math (f32). u:[B,D] v_pos:[B,D] v_neg:[B,K,D]."""
    u, v_pos, v_neg = u.float(), v_pos.float(), v_neg.float()
    s_pos = torch.sigmoid((u * v_pos).sum(-1))                    # [B]
    s_neg = torch.sigmoid((u[:, None, :] * v_neg).sum(-1))        # [B,K]
    loss = -(mask * torch.log(s_pos + _EPS)).sum() \
        - (mask[:, None] * torch.log(1.0 - s_neg + _EPS)).sum()
    g_pos = (s_pos - 1.0) * mask                                  # [B]
    g_neg = s_neg * mask[:, None]                                 # [B,K]
    grad_u = g_pos[:, None] * v_pos + (g_neg[..., None] * v_neg).sum(1)
    grad_vpos = g_pos[:, None] * u                                # [B,D]
    grad_vneg = g_neg[..., None] * u[:, None, :]                  # [B,K,D]
    return loss, grad_u, grad_vpos, grad_vneg


def _hs_grads(u, v_nodes, codes, lmask):
    """Hierarchical-softmax math (f32). u:[B,D] v_nodes:[B,L,D]
    codes:[B,L]."""
    u, v_nodes = u.float(), v_nodes.float()
    score = (u[:, None, :] * v_nodes).sum(-1)                     # [B,L]
    target = 1.0 - codes
    sign = 2.0 * target - 1.0
    loss = -(lmask * torch.log(torch.sigmoid(sign * score) + _EPS)).sum()
    g = (torch.sigmoid(score) - target) * lmask                   # [B,L]
    grad_u = (g[..., None] * v_nodes).sum(1)                      # [B,D]
    grad_v = g[..., None] * u[:, None, :]                         # [B,L,D]
    return loss, grad_u, grad_v


def _take(w, ids):
    """Rows of ``w`` by id, ids clipped into range (``mode="clip"``)."""
    ids = ids.to(torch.int64)
    return w.index_select(0, ids.reshape(-1).clamp(0, w.shape[0] - 1)
                          ).reshape(*ids.shape, w.shape[1])


def _cbow_u(w_in, contexts, cmask):
    """CBOW's hidden vector (the mean of the masked context rows, f32)
    and each context's share of a gradient row (``cmask / counts``)."""
    ctx = _take(w_in, contexts).float()                          # [B,C,D]
    counts = torch.clamp(cmask.sum(-1, keepdim=True), min=1.0)
    return (ctx * cmask[..., None]).sum(1) / counts, counts


def _cbow_spread(w_in, g_in, contexts, cmask, counts, grad_u, lr, adagrad):
    """Distribute ``grad_u`` to each contributing context row of w_in."""
    B, C = contexts.shape
    gctx = grad_u[:, None, :] * cmask[..., None] / counts[..., None]
    _apply_update(w_in, g_in, contexts.reshape(B * C),
                  gctx.reshape(B * C, -1), lr, adagrad, live=cmask)


def _ns_live(mask, k: int):
    """The live lanes of an ns output update: each example's positive row,
    then its ``k`` negatives (the rows' order in the steps)."""
    return torch.cat([mask, mask[:, None].expand(-1, k).reshape(-1)])


def raw_sg_ns_step(adagrad: bool):
    """One sg-ns chunk: gather (ids clipped), loss and gradients, then the
    in-place updates of w_in by centers and of w_out by contexts followed
    by negatives. Returns the chunk's loss."""
    def step(w_in, w_out, g_in, g_out, centers, contexts, negatives, mask,
             lr):
        u = _take(w_in, centers)
        v_pos = _take(w_out, contexts)
        v_neg = _take(w_out, negatives)
        loss, grad_u, grad_vpos, grad_vneg = _ns_grads(u, v_pos, v_neg, mask)
        _apply_update(w_in, g_in, centers, grad_u, lr, adagrad, live=mask)
        B, K, D = grad_vneg.shape
        rows = torch.cat([contexts.to(torch.int64),
                          negatives.to(torch.int64).reshape(B * K)])
        grads = torch.cat([grad_vpos, grad_vneg.reshape(B * K, D)])
        _apply_update(w_out, g_out, rows, grads, lr, adagrad,
                      live=_ns_live(mask, K))
        return loss

    return step


def raw_sg_hs_step(adagrad: bool):
    def step(w_in, w_out, g_in, g_out, centers, points, codes, lmask, lr):
        u = _take(w_in, centers)
        v = _take(w_out, points)
        loss, grad_u, grad_v = _hs_grads(u, v, codes, lmask)
        _apply_update(w_in, g_in, centers, grad_u, lr, adagrad,
                      live=lmask[:, 0])
        B, L, D = grad_v.shape
        _apply_update(w_out, g_out, points.reshape(B * L),
                      grad_v.reshape(B * L, D), lr, adagrad, live=lmask)
        return loss

    return step


def raw_cbow_ns_step(adagrad: bool):
    def step(w_in, w_out, g_in, g_out, centers, contexts, cmask, negatives,
             mask, lr):
        u, counts = _cbow_u(w_in, contexts, cmask)
        v_pos = _take(w_out, centers)
        v_neg = _take(w_out, negatives)
        loss, grad_u, grad_vpos, grad_vneg = _ns_grads(u, v_pos, v_neg, mask)
        _cbow_spread(w_in, g_in, contexts, cmask, counts, grad_u, lr,
                     adagrad)
        B, K, D = grad_vneg.shape
        rows = torch.cat([centers.to(torch.int64),
                          negatives.to(torch.int64).reshape(B * K)])
        grads = torch.cat([grad_vpos, grad_vneg.reshape(B * K, D)])
        _apply_update(w_out, g_out, rows, grads, lr, adagrad,
                      live=_ns_live(mask, K))
        return loss

    return step


def raw_cbow_hs_step(adagrad: bool):
    def step(w_in, w_out, g_in, g_out, centers, contexts, cmask, points,
             codes, lmask, lr):
        u, counts = _cbow_u(w_in, contexts, cmask)
        v = _take(w_out, points)
        loss, grad_u, grad_v = _hs_grads(u, v, codes, lmask)
        _cbow_spread(w_in, g_in, contexts, cmask, counts, grad_u, lr,
                     adagrad)
        B, L, D = grad_v.shape
        _apply_update(w_out, g_out, points.reshape(B * L),
                      grad_v.reshape(B * L, D), lr, adagrad, live=lmask)
        return loss

    return step


def raw_step(sg: bool, hs: bool, adagrad: bool):
    """The variant's raw step (the argument order of each is the JAX
    package's)."""
    if sg:
        return raw_sg_hs_step(adagrad) if hs else raw_sg_ns_step(adagrad)
    return raw_cbow_hs_step(adagrad) if hs else raw_cbow_ns_step(adagrad)


class HuffmanRows:
    """The Huffman points, codes and path lengths of every word, on the
    device, and their gathers for a chunk of target words."""

    def __init__(self, huffman: HuffmanEncoder, device: torch.device):
        self.points = torch.as_tensor(huffman.points.astype(np.int32),
                                      device=device)
        self.codes = torch.as_tensor(huffman.codes.astype(np.float32),
                                     device=device)
        self.lengths = torch.as_tensor(huffman.lengths.astype(np.int32),
                                       device=device)
        self._lane = torch.arange(self.points.shape[1], device=device)

    def args(self, target: torch.Tensor, m: torch.Tensor):
        """points / codes / length mask (times the example mask ``m``)."""
        t = target.to(torch.int64).clamp(0, self.points.shape[0] - 1)
        lm = (self._lane[None, :] < self.lengths.index_select(0, t)[:, None]
              ).to(torch.float32) * m[:, None]
        return (self.points.index_select(0, t),
                self.codes.index_select(0, t), lm)


def chunk_loop(raw, tables, streams, negatives, mask, n_examples, lr,
               sg: bool = True, hs: bool = False,
               huffman: Optional[HuffmanRows] = None) -> torch.Tensor:
    """The plain block step's chunk loop, in place on ``tables``: with
    ``mask`` None (compacted streams) the live chunks ``ceil(n_examples /
    chunk)`` (one host read), each masked by ``n_examples``; else every
    chunk under its mask. The loss is summed in chunk order from 0."""
    n, chunk = streams[0].shape[:2]
    dev = streams[0].device
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    if mask is None:
        n_examples = torch.as_tensor(n_examples, device=dev)
        n_run = min((int(n_examples) + chunk - 1) // chunk, n)
        lane = torch.arange(chunk, device=dev)
    else:
        n_run = n
    for i in range(n_run):
        m = (((i * chunk + lane) < n_examples).to(torch.float32)
             if mask is None else mask[i])
        neg = None if negatives is None else negatives[i]
        if sg:
            c, o = streams[0][i], streams[1][i]
            args = ((c, *huffman.args(o, m)) if hs else (c, o, neg, m))
        else:
            c, ctx, cm = (s[i] for s in streams)
            args = ((c, ctx, cm, *huffman.args(c, m)) if hs
                    else (c, ctx, cm, neg, m))
        loss = loss + raw(*tables, *args, lr)
    return loss


DISPATCH_MODES = ("in_graph", "pipelined_host", "pallas_grid")


def resolve_dispatch_mode(cfg: "Word2VecConfig", in_rows: int,
                          out_rows: int, device: torch.device) -> str:
    """The port's dispatch-mode decision for the device pipeline (the JAX
    table is TPU-derived).

    Explicit ``dispatch_mode`` wins (the deprecated ``chunk_dispatch`` maps
    onto it). hs and CBOW (the JAX decision's rule 1) -> in_graph, the
    only implementation of those variants; an explicit ``pallas_grid`` or
    ``pipelined_host`` with them raises. sg-ns: AUTO on the CPU ->
    in_graph (the plain torch chunk loop); on a CUDA device, both AUTO and
    an explicit ``pallas_grid`` -> the B5 kernel, one launch per block,
    float32 or bfloat16 tables; a configuration the kernel does not take
    raises there instead of training through the plain loop. Only an
    explicit ``in_graph``/``pipelined_host`` runs the plain loop on a
    card."""
    mode = cfg.dispatch_mode
    if mode is None and cfg.chunk_dispatch is not None:
        mode = "pipelined_host" if cfg.chunk_dispatch else "in_graph"
    explicit = mode not in (None, "auto")
    if explicit:
        check(mode in DISPATCH_MODES,
              f"dispatch_mode must be one of {DISPATCH_MODES} or 'auto'; "
              f"got {mode!r}")
    if not cfg.sg or cfg.hs:
        check(mode in (None, "auto", "in_graph"),
              f"dispatch_mode={mode} (per-chunk host dispatch / the sg-ns "
              "kernel) is the sg-ns path; the plain block step covers all "
              "four variants")
        return "in_graph"
    if not explicit and device.type != "cuda":
        log.info("w2v dispatch auto: %s -> in_graph", device.type)
        return "in_graph"
    if device.type == "cuda" and mode in (None, "auto", "pallas_grid"):
        check(sgns_grid_eligible(in_rows, out_rows, cfg.embedding_size,
                                 cfg.batch_size, cfg.negative,
                                 cfg.param_dtype, device),
              f"dispatch_mode={mode or 'auto'} on {device}: the sg-ns kernel "
              f"takes float32 or bfloat16 tables, at least one negative and "
              f"a working set within the device's memory; vocab "
              f"{in_rows}/{out_rows} x D={cfg.embedding_size} "
              f"K={cfg.negative} {cfg.param_dtype} is not taken (an explicit "
              f"dispatch_mode=in_graph runs the plain chunk loop)")
        if not explicit:
            log.info("w2v dispatch auto: CUDA device -> pallas_grid")
        return "pallas_grid"
    return mode


def _waits(cfg: Word2VecConfig) -> None:
    """Raise for the configurations this port does not run yet."""
    if cfg.mesh_data * cfg.mesh_model > 1:
        raise NotImplementedError(
            "a word2vec dp x tp mesh (mesh_data x mesh_model > 1) is not "
            "ported yet: ROADMAP A10")


def resolve_w2v_comm(cfg: "Word2VecConfig", V: int, D: int,
                     out_rows: int, mesh=None):
    """Per-table CommPolicy resolution for the five word2vec tables.
    Returns ``(mode, policies)``: ``mode`` is the training loop's plane,
    ``policies`` maps table name -> policy (passed into the table options,
    so each table's ``comm_policy`` attribute carries the decision).

    * ``None`` -> ("fused", {}): the fused in-store plane, no probe.
    * ``auto``/``hybrid`` -> per table: the four embedding/accumulator
      tables are sparse row-granular -> ps (served by the fused in-store
      plane); the word-count table is small dense -> whatever the probe
      picks. ``comm_policy_overrides`` entries win per table.
    * ``ps`` / ``model_average`` -> every table pinned to that plane.
    * ``allreduce`` is rejected: word2vec's tables are sparse
      row-granular, and densifying a [V, D] gradient a step is what the
      decision table exists to prevent."""
    from multiverso_tpu_torch.parallel import comm_policy as cp

    mode = (cfg.comm_policy or "").strip().lower()
    check(mode in ("", "auto", "hybrid", "ps", "model_average"),
          "word2vec comm_policy must be auto|hybrid|ps|model_average; "
          f"got {cfg.comm_policy!r}"
          + (" (allreduce applies per-TABLE to small dense tables — "
             "word2vec's embedding tables are sparse; use auto/hybrid)"
             if mode == "allreduce" else ""))
    if not mode:
        return "fused", {}
    overrides = dict(cfg.comm_policy_overrides or {})
    names_sparse = ["w2v_input", "w2v_output", "w2v_adagrad_in",
                    "w2v_adagrad_out"]
    shapes = {"w2v_input": (V, D), "w2v_output": (out_rows, D),
              "w2v_adagrad_in": (V, D), "w2v_adagrad_out": (out_rows, D),
              "w2v_wordcount": (1,)}
    policies = {}
    if mode in ("ps", "model_average"):
        want = cp.PS if mode == "ps" else cp.MODEL_AVERAGE
        for name in names_sparse + ["w2v_wordcount"]:
            policies[name] = cp.resolve_comm_policy(
                shapes[name], np.float32, sparse=name in names_sparse,
                explicit=overrides.get(name, want), mesh=mesh, table=name)
        return mode, policies
    for name in names_sparse:
        policies[name] = cp.resolve_comm_policy(
            shapes[name], cfg.param_dtype, sparse=True,
            explicit=overrides.get(name), mesh=mesh, table=name)
    policies["w2v_wordcount"] = cp.resolve_comm_policy(
        (1,), np.int64, sparse=False,
        explicit=overrides.get("w2v_wordcount"), mesh=mesh,
        table="w2v_wordcount")
    return "hybrid", policies


class Word2Vec:
    def __init__(self, cfg: Word2VecConfig, dictionary: Dictionary):
        check(len(dictionary) >= 2, "vocabulary too small")
        check(cfg.optimizer in ("adagrad", "sgd"),
              f"optimizer must be adagrad|sgd; got {cfg.optimizer!r}")
        check(torch_dtype(cfg.param_dtype) in (torch.float32,
                                               torch.bfloat16),
              f"param_dtype must be float32 or bfloat16; got "
              f"{cfg.param_dtype!r}")
        _waits(cfg)
        self.cfg = cfg
        self.dict = dictionary
        V, D = len(dictionary), cfg.embedding_size
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() first")
        self.device = zoo.device

        # The five reference tables (communicator.cpp:17-32). Embeddings
        # may store bfloat16; the accumulators stay float32. HS's output
        # rows are the Huffman tree's V - 1 inner nodes. Each table's
        # policy is resolved before it is created.
        out_rows = max((V - 1) if cfg.hs else V, 1)
        self.comm_mode, comm = resolve_w2v_comm(cfg, V, D, out_rows,
                                                mesh=zoo.mesh)
        self.comm_policies = comm
        self.input_table = mv.create_table(MatrixTableOption(
            V, D, dtype=cfg.param_dtype, random_init=True,
            init_low=-0.5 / D, init_high=0.5 / D, seed=cfg.seed,
            name="w2v_input", updater="default",
            comm_policy=comm.get("w2v_input")))
        self.output_table = mv.create_table(MatrixTableOption(
            out_rows, D, dtype=cfg.param_dtype, name="w2v_output",
            updater="default", comm_policy=comm.get("w2v_output")))
        self.adagrad_in = mv.create_table(MatrixTableOption(
            V, D, name="w2v_adagrad_in", updater="default",
            comm_policy=comm.get("w2v_adagrad_in")))
        self.adagrad_out = mv.create_table(MatrixTableOption(
            out_rows, D, name="w2v_adagrad_out", updater="default",
            comm_policy=comm.get("w2v_adagrad_out")))
        self.wordcount_table = mv.create_table(
            KVTableOption(value_dtype=np.int64, name="w2v_wordcount",
                          comm_policy=comm.get("w2v_wordcount")))
        # Hybrid mode: one collective a block merges the dense quantity
        # (the word count the lr schedule agrees on across ranks) while
        # the sparse tables stay on the fused plane; accumulated on the
        # device and read once a train().
        self._dense_sync = None
        self._comm_synced: Optional[torch.Tensor] = None
        if (self.comm_mode == "hybrid" and
                comm.get("w2v_wordcount") == "allreduce"):
            from multiverso_tpu_torch.parallel import comm_policy as cp
            self._dense_sync = cp.build_dense_sync(zoo.mesh)

        self.huffman = (HuffmanEncoder(dictionary.counts,
                                       cfg.max_code_length)
                        if cfg.hs else None)
        self.generator = BatchGenerator(
            dictionary, batch_size=cfg.batch_size, window=cfg.window,
            negative=cfg.negative, sample=cfg.sample, sg=cfg.sg,
            seed=cfg.seed)
        self._adagrad = cfg.optimizer == "adagrad"
        self._raw = raw_step(cfg.sg, cfg.hs, self._adagrad)
        self._huff = (HuffmanRows(self.huffman, self.device)
                      if cfg.hs else None)
        self._dispatch_mode: Optional[str] = None

        if cfg.device_pipeline:
            sampler = self.generator.sampler
            # Shuffled so 128-wide rows are iid draws (row-gather
            # sampling); the same numpy seed as the JAX package.
            perm = np.random.default_rng(cfg.seed + 17).permutation(
                len(sampler.table))
            self._neg_table = torch.as_tensor(sampler.table[perm],
                                              device=self.device)
            keep_host = Sampler.keep_probability(
                dictionary.counts, cfg.sample).astype(np.float32)
            self._keep_prob = torch.as_tensor(keep_host, device=self.device)
            self._dispatch_mode = resolve_dispatch_mode(cfg, V, out_rows,
                                                        self.device)
            self._grid_step = build_sgns_grid_step(
                cfg.batch_size, cfg.negative, self._adagrad)
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(cfg.seed)
            #: The draw of a block's random numbers, ``(S, L, rows_needed,
            #: rows_tbl) -> (keep_u, wpos, ridx)``; a test may substitute
            #: one that hands in another source's numbers.
            self.draw_randoms = lambda S, L, rows_needed, rows_tbl: \
                draw_pair_randoms(self._gen, S, L, cfg.window, rows_needed,
                                  rows_tbl, self.device)

        self.total_words = dictionary.total_count * max(cfg.epochs, 1)
        self.trained_words = 0
        self.words_per_sec = 0.0
        self._push_scale = 1.0 if cfg.delta_scale is None \
            else cfg.delta_scale

    @property
    def dispatch_mode(self) -> Optional[str]:
        """The device pipeline's chunk-loop mode (None on the host batch
        path)."""
        return self._dispatch_mode

    @property
    def _tables(self):
        return (self.input_table.store.data, self.output_table.store.data,
                self.adagrad_in.store.data, self.adagrad_out.store.data)

    # -- comm-policy hooks --------------------------------------------------
    def _hybrid_sync(self, words: int) -> None:
        """Hybrid mode's dense-plane merge: one collective a block carries
        the block's word count, accumulated on the device into
        ``_comm_synced`` and read once a train()
        (``stats["synced_words"]``). At one rank it is the identity."""
        if self._dense_sync is None:
            return
        from multiverso_tpu_torch.parallel import comm_policy as cp
        synced = self._dense_sync(torch.tensor([float(words)],
                                               dtype=torch.float32,
                                               device=self.device))
        self._comm_synced = (synced if self._comm_synced is None
                             else self._comm_synced + synced)
        cp.record(cp.ALLREDUCE, 4)

    def _synced_words(self) -> Optional[float]:
        """The merged word count (None outside hybrid mode)."""
        if self._comm_synced is None:
            return None
        return float(self._comm_synced[0])

    def _model_average_epoch(self) -> None:
        """The reference "ma" epoch merge: every table replica averaged
        over the world's ranks on the collective plane, then written back
        into the store (the identity at one rank, bitwise)."""
        from multiverso_tpu_torch.parallel import comm_policy as cp
        tables = [self.input_table, self.output_table]
        if self._adagrad:
            tables += [self.adagrad_in, self.adagrad_out]
        merged = cp.model_average_arrays([t.store.read() for t in tables])
        for t, m in zip(tables, merged):
            t.store.write_dense(m)

    # -- lr schedule (ref distributed_wordembedding.cpp:92-134) ------------
    def _current_lr(self) -> float:
        if self._adagrad:
            return self.cfg.learning_rate
        frac = min(self.trained_words / max(self.total_words, 1), 1.0)
        return max(self.cfg.learning_rate * (1.0 - frac),
                   self.cfg.learning_rate * 1e-4)

    def _sentences(self, sentences, corpus_path) -> Iterable:
        if corpus_path is not None:
            return (self.dict.encode(s) for s in read_corpus(corpus_path))
        return iter(sentences)

    @staticmethod
    def _prefetched(items, pipeline: bool):
        """``items`` as is, or produced on a background thread (the
        reference's prefetch pipeline, distributed_wordembedding.cpp:
        203-212); returns ``(source, buffer or None)``."""
        from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer
        if not pipeline:
            return items, None
        buf = ASyncBuffer(lambda: next(items, None))

        def drain():
            while True:
                item = buf.get()
                if item is None:
                    return
                yield item
        return drain(), buf

    # -- training loop (ref TrainNeuralNetwork :147-237) -------------------
    def train(self, sentences: Optional[Iterable[Sequence[int]]] = None,
              corpus_path: Optional[str] = None,
              epochs: Optional[int] = None) -> dict:
        epochs = epochs if epochs is not None else self.cfg.epochs
        check(sentences is not None or corpus_path is not None,
              "need sentences or corpus_path")
        if self.comm_mode == "ps":
            # Pure client plane: pull-train-push a block through the
            # table API (the baseline the hybrid mode exists to beat).
            from multiverso_tpu_torch.models.word2vec.commplane import \
                PSPlaneTrainer
            return PSPlaneTrainer(self).train(sentences, corpus_path,
                                              epochs)
        if self.cfg.device_pipeline:
            return self._train_device(sentences, corpus_path, epochs)
        return self._train_host(sentences, corpus_path, epochs)

    # -- host batch path ---------------------------------------------------
    def _batch_args(self, batch) -> Tuple[np.ndarray, ...]:
        """A batch as the raw step's arguments (before ``lr``)."""
        hs = self.cfg.hs
        if hs:
            target = (batch.contexts if isinstance(batch, SkipGramBatch)
                      else batch.centers)
            points = self.huffman.points[target]
            codes = self.huffman.codes[target]
            lmask = ((np.arange(self.cfg.max_code_length)[None, :] <
                      self.huffman.lengths[target][:, None])
                     .astype(np.float32) * batch.mask[:, None])
        if isinstance(batch, SkipGramBatch):
            if hs:
                return (batch.centers, points, codes, lmask)
            return (batch.centers, batch.contexts, batch.negatives,
                    batch.mask)
        if hs:
            return (batch.centers, batch.contexts, batch.context_mask,
                    points, codes, lmask)
        return (batch.centers, batch.contexts, batch.context_mask,
                batch.negatives, batch.mask)

    def _group_iter(self, sentences):
        """Yields ``(stacked_args, words, pairs)``: ``scan_group`` batches
        stacked on a leading axis (a short group padded with zero, masked
        batches), one device step each."""
        N = max(1, self.cfg.scan_group)
        pending: List[Tuple[np.ndarray, ...]] = []
        words = pairs = 0

        def emit():
            args = pending
            if len(args) < N:
                zero = tuple(np.zeros_like(a) for a in args[0])
                args = args + [zero] * (N - len(args))
            return tuple(np.stack([a[i] for a in args])
                         for i in range(len(args[0])))

        for block in BlockStream(sentences, self.cfg.block_words,
                                 prefetch=False):
            words += sum(len(s) for s in block)
            for batch in self.generator.batches(block):
                pending.append(self._batch_args(batch))
                pairs += batch.n_words
                if len(pending) == N:
                    yield emit(), words, pairs
                    pending, words, pairs = [], 0, 0
        if pending:
            yield emit(), words, pairs

    def _run_group(self, stacked) -> torch.Tensor:
        """The raw step over a group's batches in order (the JAX package's
        ``lax.scan``), in place; returns the loss summed in group order."""
        args = [torch.as_tensor(a, device=self.device) for a in stacked]
        lr = torch.tensor(np.float32(self._current_lr() * self._push_scale),
                          device=self.device)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(args[0].shape[0]):
            loss = loss + self._raw(*self._tables, *[a[i] for a in args],
                                    lr)
        return loss

    def _train_host(self, sentences, corpus_path, epochs) -> dict:
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        total_pairs = 0
        for _ in range(epochs):
            groups = self._group_iter(self._sentences(sentences,
                                                      corpus_path))
            source, buf = self._prefetched(groups, self.cfg.pipeline)
            try:
                for stacked, words, pairs in source:
                    with span("w2v.group"), monitor("W2V_GROUP"):
                        losses.append(self._run_group(stacked))
                    total_pairs += pairs
                    self.trained_words += words
                    if words:
                        self.wordcount_table.add([_WORDCOUNT_KEY], [words])
                        self._hybrid_sync(words)
            finally:
                if buf is not None:
                    buf.close()
            if self.comm_mode == "model_average":
                self._model_average_epoch()
        return self._finish(t0, losses, total_pairs, "word2vec",
                            groups=len(losses))

    # -- device pipeline ---------------------------------------------------
    def _sentence_blocks(self, sentences):
        """[S, L] int32 sentence matrix + lengths per block; long sentences
        split at the pad length, short blocks zero-padded."""
        S, L = self.cfg.block_sentences, self.cfg.pad_sentence_length
        mat = np.zeros((S, L), dtype=np.int32)
        lens = np.zeros(S, dtype=np.int32)
        row = 0
        words = 0
        for sent in sentences:
            sent = np.asarray(sent, dtype=np.int32)
            for i in range(0, max(len(sent), 1), L):
                piece = sent[i:i + L]
                if len(piece) == 0:
                    continue
                mat[row, :len(piece)] = piece
                lens[row] = len(piece)
                words += len(piece)
                row += 1
                if row == S:
                    yield mat, lens, words
                    mat = np.zeros((S, L), dtype=np.int32)
                    lens = np.zeros(S, dtype=np.int32)
                    row, words = 0, 0
        if row:
            yield mat, lens, words

    def _train_block(self, mat: np.ndarray, lens: np.ndarray, mode: str):
        """Example generation + the chunk loop for one block, in place on
        the tables. Returns ``(loss, n_examples)`` as device scalars."""
        cfg = self.cfg
        S, L = mat.shape
        K = 0 if cfg.hs else cfg.negative
        n, rows_needed, rows_tbl = pair_stream_shape(
            S, L, cfg.window, cfg.batch_size, K, self._neg_table.shape[0],
            sg=cfg.sg)
        keep_u, wpos, ridx = self.draw_randoms(S, L, rows_needed, rows_tbl)
        drawn = (torch.as_tensor(mat, device=self.device),
                 torch.as_tensor(lens, device=self.device), keep_u,
                 wpos.to(torch.int32), ridx)
        lr = np.float32(self._current_lr() * self._push_scale)
        if mode == "pallas_grid":
            streams = pair_gen(self._neg_table, self._keep_prob, *drawn,
                               cfg.window, cfg.batch_size, cfg.negative)
            return self._grid_step(*self._tables, *streams, lr)[4], \
                streams[3]
        streams, negs, mask, n_ex = block_streams(
            self._neg_table, self._keep_prob, *drawn, cfg.window,
            cfg.batch_size, K, sg=cfg.sg, hs=cfg.hs,
            compact=cfg.compact_pairs or mode == "pipelined_host")
        loss = chunk_loop(self._raw, self._tables, streams, negs, mask, n_ex,
                          lr, sg=cfg.sg, hs=cfg.hs, huffman=self._huff)
        return loss, n_ex

    def _train_device(self, sentences, corpus_path, epochs) -> dict:
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        pair_counts: List[torch.Tensor] = []
        mode = self._dispatch_mode
        for _ in range(epochs):
            blocks = self._sentence_blocks(self._sentences(sentences,
                                                           corpus_path))
            source, buf = self._prefetched(blocks, self.cfg.pipeline)
            try:
                for mat, lens, words in source:
                    with span("w2v.device_block", mode=mode), \
                            monitor("W2V_DEVICE_BLOCK"), \
                            monitor(f"W2V_DISPATCH_{mode.upper()}"):
                        loss, pairs = self._train_block(mat, lens, mode)
                    losses.append(loss)
                    pair_counts.append(pairs)
                    self.trained_words += words
                    self.wordcount_table.add([_WORDCOUNT_KEY], [words])
                    self._hybrid_sync(words)
            finally:
                if buf is not None:
                    buf.close()
            if self.comm_mode == "model_average":
                self._model_average_epoch()
        total_pairs = (int(torch.stack(pair_counts).sum())
                       if pair_counts else 0)
        return self._finish(t0, losses, total_pairs, "word2vec[device]",
                            blocks=len(losses))

    def _finish(self, t0, losses, total_pairs, what, **counts) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.words_per_sec = self.trained_words / max(elapsed, 1e-9)
        mean_loss = (float(torch.stack(losses[-50:]).mean())
                     if losses else 0.0)
        log.info("%s: %d words, %d pairs, %.0f words/sec, loss=%.4f", what,
                 self.trained_words, total_pairs, self.words_per_sec,
                 mean_loss)
        return {"words": self.trained_words, "pairs": total_pairs,
                "words_per_sec": self.words_per_sec, "loss": mean_loss,
                "seconds": elapsed, "comm_mode": self.comm_mode,
                "synced_words": self._synced_words(), **counts}

    # -- embeddings out ----------------------------------------------------
    def embeddings(self) -> np.ndarray:
        return self.input_table.get()

    def save(self, path: str, batch_rows: int = 100_000) -> None:
        """Rank-0 batched text export (ref :263-306 saves in 100K-row
        batches). Goes through the URI stream layer, so ``gs://`` targets
        work exactly as they do for checkpoints (plain paths are
        ``file://``)."""
        if not mv.is_master_worker():
            return
        from multiverso_tpu_torch.utils.stream import open_stream
        with open_stream(path, "w") as f:
            f.write(f"{len(self.dict)} {self.cfg.embedding_size}\n"
                    .encode())
            for start in range(0, len(self.dict), batch_rows):
                rows = list(range(start,
                                  min(start + batch_rows, len(self.dict))))
                emb = self.input_table.get_rows(rows).astype(np.float32)
                chunk = []
                for r, vec in zip(rows, emb):
                    vec_s = " ".join(f"{x:.6f}" for x in vec)
                    chunk.append(f"{self.dict.words[r]} {vec_s}\n")
                f.write("".join(chunk).encode())

    def analogy(self, a: str, b: str, c: str, topk: int = 5
                ) -> List[Tuple[str, float]]:
        """a : b :: c : ?  via vector arithmetic (b - a + c), inputs
        excluded."""
        ids = [self.dict.word2id.get(w) for w in (a, b, c)]
        if any(i is None for i in ids):
            return []
        emb = self.embeddings().astype(np.float32)
        emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        query = emb[ids[1]] - emb[ids[0]] + emb[ids[2]]
        query = query / (np.linalg.norm(query) + 1e-12)
        sims = emb @ query
        out: List[Tuple[str, float]] = []
        for i in np.argsort(-sims):
            if i in ids:
                continue
            out.append((self.dict.words[i], float(sims[i])))
            if len(out) == topk:
                break
        return out

    def most_similar(self, word: str, topk: int = 5
                     ) -> List[Tuple[str, float]]:
        wid = self.dict.word2id.get(word)
        if wid is None:
            return []
        emb = self.embeddings()
        norms = np.linalg.norm(emb, axis=1) + 1e-12
        sims = emb @ emb[wid] / (norms * norms[wid])
        order = np.argsort(-sims)
        out = []
        for i in order:
            if i != wid:
                out.append((self.dict.words[i], float(sims[i])))
            if len(out) == topk:
                break
        return out
