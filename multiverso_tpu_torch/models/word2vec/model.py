"""Word2vec (distributed WordEmbedding) — the flagship workload, sg-ns path.

Port of ``multiverso_tpu/models/word2vec/model.py``: skip-gram with
negative sampling over the five reference tables (input/output embedding
matrices, two AdaGrad accumulator matrices, the word-count KV table),
block-pipelined training with on-device pair generation, a words/sec
metric, linear lr decay for SGD and batched embedding export.

Each block of sentences becomes pairs on the device (subsampling, the
per-center shrunk window, compaction of the valid pairs to the front and
row-gathered unigram negatives), then the chunk loop trains it:

* ``pallas_grid`` (AUTO on a card) — the hand-written whole-block CUDA
  kernel (``ops/sgns.py``, B5), one launch per block;
* ``in_graph`` / ``pipelined_host`` — the plain torch chunk loop. In the
  JAX package the three modes are bitwise-equal executions of one step;
  in the port the two plain modes are the same loop.

Pair generation is split so a test can hand the JAX package's random
numbers to the port: :func:`draw_pair_randoms` draws from a
``torch.Generator``, and :func:`pair_gen` builds the streams from the
drawn tensors.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: hierarchical softmax and CBOW (A3), the host batch path
(``device_pipeline=False``, A3), a dp x tp mesh (A7), comm policies other
than None (A7) and bfloat16 parameters (A3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.core.options import KVTableOption, MatrixTableOption
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.models.word2vec.data import (BatchGenerator,
                                                       read_corpus)
from multiverso_tpu_torch.models.word2vec.dictionary import (Dictionary,
                                                             Sampler)
from multiverso_tpu_torch.ops.sgns import (MAX_NEGATIVE,
                                           build_sgns_grid_step,
                                           sgns_block_plain,
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
    block_words: int = 100_000
    pipeline: bool = True
    param_prefetch: bool = False
    scan_group: int = 32
    param_dtype: str = "float32"
    # Device pipeline: pair generation on the device; the host uploads
    # raw token ids only. The only path of this slice (the host batch
    # path waits: ROADMAP A3).
    device_pipeline: bool = False
    compact_pairs: bool = True
    # Chunk-loop execution: "pallas_grid" (the B5 kernel), "in_graph" /
    # "pipelined_host" (the plain torch chunk loop), None/"auto" ->
    # resolve_dispatch_mode.
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
# Pair pipeline
# ---------------------------------------------------------------------------
def pair_stream_shape(S: int, L: int, window: int, chunk: int,
                      negative: int, neg_table_len: int
                      ) -> Tuple[int, int, int]:
    """``(n_chunks, rows_needed, rows_tbl)`` of a block: the static chunk
    count of the pair stream, and the negative draw's row count out of a
    sampler table viewed as ``rows_tbl`` rows of width ``min(128, len)``."""
    P = 2 * sum(S * max(L - d, 0) for d in range(1, window + 1))
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


def _pair_arrays(sents, lengths, keep_prob, keep_u, wpos, window):
    """Masked offset-shift pairing: for each distance d, (center, context)
    both ways where the center's window reaches d and both words are
    valid (in the sentence and kept by subsampling)."""
    S, L = sents.shape
    pos = torch.arange(L, device=sents.device)[None, :]
    valid = pos < lengths[:, None]
    keep = keep_u < keep_prob[sents.to(torch.int64)]
    valid = valid & keep
    centers, contexts, pmask = [], [], []
    for d in range(1, window + 1):
        c = sents[:, :-d].reshape(-1)
        o = sents[:, d:].reshape(-1)
        m = ((wpos[:, :-d] >= d) & valid[:, :-d] & valid[:, d:]).reshape(-1)
        centers += [c, o]
        contexts += [o, c]
        pmask += [m, m]
    return torch.cat(centers), torch.cat(contexts), torch.cat(pmask)


def _compact_examples(pmask, chunk, arrays1d):
    """Stable-partition valid examples to the front: ``[P] -> [n, chunk]``
    plus the true example count, by a cumsum destination map (no host
    sync)."""
    P = pmask.shape[0]
    total = P + (-P) % chunk
    n = total // chunk
    n_ex = pmask.sum().to(torch.int32)
    dest = torch.cumsum(pmask.to(torch.int64), 0) - 1
    dest = torch.where(pmask, dest, torch.full_like(dest, total))
    out = []
    for a in arrays1d:
        buf = torch.zeros(total + 1, dtype=a.dtype, device=a.device)
        buf[dest] = a                   # slot ``total`` takes the dropped
        out.append(buf[:total].reshape(n, chunk))
    return out, n_ex, n


def _compact_stream(centers, contexts, pmask, chunk):
    (centers, contexts), n_pairs, n = _compact_examples(
        pmask, chunk, [centers, contexts])
    return centers, contexts, n_pairs, n


def pair_gen(neg_table, keep_prob, sents, lengths, keep_u, wpos, ridx,
             window: int, chunk: int, negative: int):
    """Pure pair building from drawn random tensors: returns
    ``(centers2d [n, chunk], contexts2d [n, chunk], negatives3d
    [n, chunk, negative], n_pairs)`` with the valid pairs compacted to the
    front and ``n_pairs`` their count (a device scalar)."""
    centers, contexts, pmask = _pair_arrays(sents, lengths, keep_prob,
                                            keep_u, wpos, window)
    centers, contexts, n_pairs, n = _compact_stream(centers, contexts,
                                                    pmask, chunk)
    negatives = _row_gather_negatives(neg_table, ridx, (n, chunk, negative))
    return centers, contexts, negatives, n_pairs


# ---------------------------------------------------------------------------
# The sg-ns step (plain torch; the chunk loop's body and the B5 oracle)
# ---------------------------------------------------------------------------
def _apply_update(w, g2, rows, grad, lr, adagrad: bool) -> None:
    """In place: scatter an embedding update (+AdaGrad) for possibly
    duplicated rows — ``g2[rows] += grad^2`` over all duplicates, then
    ``w[rows] += -lr*grad/sqrt(g2[rows] + 1e-6)`` with the summed g2
    (``-lr*grad`` for SGD). Out-of-range rows are dropped."""
    num_rows = w.shape[0]
    rows = rows.to(torch.int64)
    keep = ((rows >= 0) & (rows < num_rows))[:, None]
    safe = torch.where(keep[:, 0], rows, torch.zeros_like(rows))
    zero = torch.zeros_like(grad)
    if adagrad:
        g2.index_add_(0, safe, torch.where(keep, torch.square(grad), zero))
        denom = torch.sqrt(g2.index_select(0, rows.clamp(0, num_rows - 1))
                           + 1e-6)
        step = -lr * grad / denom
    else:
        step = -lr * grad
    w.index_add_(0, safe, torch.where(keep, step.to(w.dtype), zero))


def _ns_grads(u, v_pos, v_neg, mask):
    """Negative-sampling math (f32). u:[B,D] v_pos:[B,D] v_neg:[B,K,D]."""
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


def raw_sg_ns_step(adagrad: bool):
    """One sg-ns chunk: gather (ids clipped), loss and gradients, then the
    in-place updates of w_in by centers and of w_out by contexts followed
    by negatives. Returns the chunk's loss."""
    def step(w_in, w_out, g_in, g_out, centers, contexts, negatives, mask,
             lr):
        centers = centers.to(torch.int64)
        contexts = contexts.to(torch.int64)
        negatives = negatives.to(torch.int64)
        u = w_in.index_select(0, centers.clamp(0, w_in.shape[0] - 1))
        v_pos = w_out.index_select(0, contexts.clamp(0, w_out.shape[0] - 1))
        B, K = negatives.shape
        v_neg = w_out.index_select(
            0, negatives.reshape(-1).clamp(0, w_out.shape[0] - 1)
        ).reshape(B, K, -1)
        loss, grad_u, grad_vpos, grad_vneg = _ns_grads(u, v_pos, v_neg, mask)
        _apply_update(w_in, g_in, centers, grad_u, lr, adagrad)
        D = grad_vneg.shape[-1]
        rows = torch.cat([contexts, negatives.reshape(B * K)])
        grads = torch.cat([grad_vpos, grad_vneg.reshape(B * K, D)])
        _apply_update(w_out, g_out, rows, grads, lr, adagrad)
        return loss

    return step


DISPATCH_MODES = ("in_graph", "pipelined_host", "pallas_grid")


def resolve_dispatch_mode(cfg: "Word2VecConfig", in_rows: int,
                          out_rows: int, device: torch.device) -> str:
    """The port's dispatch-mode decision (the JAX table is TPU-derived).

    Explicit ``dispatch_mode`` wins (the deprecated ``chunk_dispatch`` maps
    onto it). AUTO on the CPU -> in_graph (the plain torch chunk loop). On
    a CUDA device, both AUTO and an explicit ``pallas_grid`` -> the B5
    kernel, one launch per block; a configuration the kernel does not take
    raises there instead of training through the plain loop. Only an
    explicit ``in_graph``/``pipelined_host`` runs the plain loop on a card."""
    mode = cfg.dispatch_mode
    if mode is None and cfg.chunk_dispatch is not None:
        mode = "pipelined_host" if cfg.chunk_dispatch else "in_graph"
    if mode not in (None, "auto"):
        check(mode in DISPATCH_MODES,
              f"dispatch_mode must be one of {DISPATCH_MODES} or 'auto'; "
              f"got {mode!r}")
    elif device.type != "cuda":
        log.info("w2v dispatch auto: %s -> in_graph", device.type)
        return "in_graph"
    if device.type == "cuda" and mode in (None, "auto", "pallas_grid"):
        check(sgns_grid_eligible(in_rows, out_rows, cfg.embedding_size,
                                 cfg.batch_size, cfg.negative,
                                 np.dtype(cfg.param_dtype), device),
              f"dispatch_mode={mode or 'auto'} on {device}: the sg-ns kernel "
              f"takes float32 tables, negative <= {MAX_NEGATIVE} and a "
              f"working set within the device's memory; vocab "
              f"{in_rows}/{out_rows} x D={cfg.embedding_size} "
              f"K={cfg.negative} is not taken (ROADMAP B5; an explicit "
              f"dispatch_mode=in_graph runs the plain chunk loop)")
        if mode in (None, "auto"):
            log.info("w2v dispatch auto: CUDA device -> pallas_grid")
        return "pallas_grid"
    return mode


def _waits(cfg: Word2VecConfig) -> None:
    """Raise for the configurations this slice does not run."""
    if cfg.hs or not cfg.sg:
        raise NotImplementedError(
            "word2vec hierarchical softmax / CBOW is not ported yet: "
            "ROADMAP A3 (only skip-gram negative sampling runs)")
    if not cfg.device_pipeline:
        raise NotImplementedError(
            "the word2vec host batch path (device_pipeline=False) is not "
            "ported yet: ROADMAP A3")
    if cfg.mesh_data * cfg.mesh_model > 1:
        raise NotImplementedError(
            "a word2vec dp x tp mesh (mesh_data x mesh_model > 1) is not "
            "ported yet: ROADMAP A7")
    if cfg.comm_policy:
        raise NotImplementedError(
            f"word2vec comm_policy={cfg.comm_policy!r} is not ported yet: "
            "ROADMAP A7")
    if np.dtype(cfg.param_dtype) != np.dtype(np.float32):
        raise NotImplementedError(
            f"word2vec param_dtype={cfg.param_dtype} is not ported yet "
            "(float32 only): ROADMAP A3")


class Word2Vec:
    def __init__(self, cfg: Word2VecConfig, dictionary: Dictionary):
        check(len(dictionary) >= 2, "vocabulary too small")
        check(cfg.optimizer in ("adagrad", "sgd"),
              f"optimizer must be adagrad|sgd; got {cfg.optimizer!r}")
        _waits(cfg)
        self.cfg = cfg
        self.dict = dictionary
        V, D = len(dictionary), cfg.embedding_size
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() first")
        self.device = zoo.device
        self.comm_mode = "fused"

        # The five reference tables (communicator.cpp:17-32).
        self.input_table = mv.create_table(MatrixTableOption(
            V, D, dtype=np.float32, random_init=True, init_low=-0.5 / D,
            init_high=0.5 / D, seed=cfg.seed, name="w2v_input",
            updater="default"))
        self.output_table = mv.create_table(MatrixTableOption(
            V, D, dtype=np.float32, name="w2v_output", updater="default"))
        self.adagrad_in = mv.create_table(MatrixTableOption(
            V, D, name="w2v_adagrad_in", updater="default"))
        self.adagrad_out = mv.create_table(MatrixTableOption(
            V, D, name="w2v_adagrad_out", updater="default"))
        self.wordcount_table = mv.create_table(
            KVTableOption(value_dtype=np.int64, name="w2v_wordcount"))

        self.generator = BatchGenerator(
            dictionary, batch_size=cfg.batch_size, window=cfg.window,
            negative=cfg.negative, sample=cfg.sample, sg=cfg.sg,
            seed=cfg.seed)
        self._adagrad = cfg.optimizer == "adagrad"

        sampler = self.generator.sampler
        # Shuffled so 128-wide rows are iid draws (row-gather sampling);
        # the same numpy seed as the JAX package.
        perm = np.random.default_rng(cfg.seed + 17).permutation(
            len(sampler.table))
        self._neg_table = torch.as_tensor(sampler.table[perm],
                                          device=self.device)
        keep_host = Sampler.keep_probability(
            dictionary.counts, cfg.sample).astype(np.float32)
        self._keep_prob = torch.as_tensor(keep_host, device=self.device)
        self._dispatch_mode = resolve_dispatch_mode(cfg, V, V, self.device)
        self._grid_step = build_sgns_grid_step(cfg.batch_size, cfg.negative,
                                               self._adagrad)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        #: The draw of a block's random numbers, ``(S, L, rows_needed,
        #: rows_tbl) -> (keep_u, wpos, ridx)``; a test may substitute one
        #: that hands in another source's numbers.
        self.draw_randoms = lambda S, L, rows_needed, rows_tbl: \
            draw_pair_randoms(self._gen, S, L, cfg.window, rows_needed,
                              rows_tbl, self.device)

        self.total_words = dictionary.total_count * max(cfg.epochs, 1)
        self.trained_words = 0
        self.words_per_sec = 0.0
        self._push_scale = 1.0 if cfg.delta_scale is None \
            else cfg.delta_scale

    @property
    def dispatch_mode(self) -> str:
        return self._dispatch_mode

    # -- lr schedule (ref distributed_wordembedding.cpp:92-134) ------------
    def _current_lr(self) -> float:
        if self._adagrad:
            return self.cfg.learning_rate
        frac = min(self.trained_words / max(self.total_words, 1), 1.0)
        return max(self.cfg.learning_rate * (1.0 - frac),
                   self.cfg.learning_rate * 1e-4)

    # -- training loop (ref TrainNeuralNetwork :147-237) -------------------
    def train(self, sentences: Optional[Iterable[Sequence[int]]] = None,
              corpus_path: Optional[str] = None,
              epochs: Optional[int] = None) -> dict:
        epochs = epochs if epochs is not None else self.cfg.epochs
        check(sentences is not None or corpus_path is not None,
              "need sentences or corpus_path")
        return self._train_device(sentences, corpus_path, epochs)

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
        """Pair generation + the chunk loop for one block, in place on the
        tables. Returns ``(loss, n_pairs)`` as device scalars."""
        cfg = self.cfg
        S, L = mat.shape
        n, rows_needed, rows_tbl = pair_stream_shape(
            S, L, cfg.window, cfg.batch_size, cfg.negative,
            self._neg_table.shape[0])
        keep_u, wpos, ridx = self.draw_randoms(S, L, rows_needed, rows_tbl)
        sents = torch.as_tensor(mat, device=self.device)
        lengths = torch.as_tensor(lens, device=self.device)
        centers2d, contexts2d, negs, n_pairs = pair_gen(
            self._neg_table, self._keep_prob, sents, lengths, keep_u,
            wpos.to(torch.int32), ridx, cfg.window, cfg.batch_size,
            cfg.negative)
        lr = np.float32(self._current_lr() * self._push_scale)
        tables = (self.input_table.store.data, self.output_table.store.data,
                  self.adagrad_in.store.data, self.adagrad_out.store.data)
        if mode == "pallas_grid":
            loss = self._grid_step(*tables, centers2d, contexts2d, negs,
                                   n_pairs, lr)[4]
        else:
            loss = sgns_block_plain(*tables, centers2d, contexts2d, negs,
                                    n_pairs, lr, self._adagrad)
        return loss, n_pairs

    def _train_device(self, sentences, corpus_path, epochs) -> dict:
        from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer

        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        pair_counts: List[torch.Tensor] = []
        mode = self._dispatch_mode
        for _ in range(epochs):
            if corpus_path is not None:
                sents: Iterable = (self.dict.encode(s)
                                   for s in read_corpus(corpus_path))
            else:
                sents = iter(sentences)
            blocks = self._sentence_blocks(sents)
            buf = None
            if self.cfg.pipeline:
                it = blocks
                buf = ASyncBuffer(lambda: next(it, None))

                def drain():
                    while True:
                        item = buf.get()
                        if item is None:
                            return
                        yield item
                source: Iterable = drain()
            else:
                source = blocks
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
            finally:
                if buf is not None:
                    buf.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.words_per_sec = self.trained_words / max(elapsed, 1e-9)
        total_pairs = int(torch.stack(pair_counts).sum()) \
            if pair_counts else 0
        mean_loss = (float(torch.stack(losses[-50:]).mean())
                     if losses else 0.0)
        log.info("word2vec[device]: %d words, %d pairs, %.0f words/sec, "
                 "loss=%.4f", self.trained_words, total_pairs,
                 self.words_per_sec, mean_loss)
        return {"words": self.trained_words, "pairs": total_pairs,
                "words_per_sec": self.words_per_sec, "loss": mean_loss,
                "seconds": elapsed, "comm_mode": self.comm_mode,
                "synced_words": None, "blocks": len(losses)}

    # -- embeddings out ----------------------------------------------------
    def embeddings(self) -> np.ndarray:
        return self.input_table.get()

    def save(self, path: str, batch_rows: int = 100_000) -> None:
        """Rank-0 batched text export (ref :263-306 saves in 100K-row
        batches). Local paths only (the URI stream layer waits: A4)."""
        if not mv.is_master_worker():
            return
        with open(path, "w") as f:
            f.write(f"{len(self.dict)} {self.cfg.embedding_size}\n")
            for start in range(0, len(self.dict), batch_rows):
                rows = list(range(start,
                                  min(start + batch_rows, len(self.dict))))
                emb = self.input_table.get_rows(rows).astype(np.float32)
                chunk = []
                for r, vec in zip(rows, emb):
                    vec_s = " ".join(f"{x:.6f}" for x in vec)
                    chunk.append(f"{self.dict.words[r]} {vec_s}\n")
                f.write("".join(chunk))

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
