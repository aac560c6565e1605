"""Distributed word2vec: multiple worker processes against PS-sharded tables.

Port of ``multiverso_tpu/models/word2vec/distributed.py``.

This is the reference's actual deployment
(``Applications/WordEmbedding/src/distributed_wordembedding.cpp`` +
``communicator.cpp``): the embedding matrices live row-sharded across server
processes; for each data block a worker

1. generates the block's training pairs AND its negative samples up front so
   the touched row set is known (ref ``data_block`` fills negatives at load),
2. pulls exactly those rows (``RequestParameter``, communicator.cpp:117-155),
3. trains locally on the pulled sub-matrix on the card (the Zoo's device)
   with the port's plain steps over the block's group of batches, in
   order (the counterpart of the JAX package's jitted ``lax.scan``; the
   steps' table updates go through ``ops/rows.add_rows_sorted``, B4 on a
   card),
4. pushes ``(new - old) / num_workers`` back (``AddDeltaParameter``,
   communicator.cpp:157-202 — the 1/N scaling applies to every table).

Optimizers: SGD with the linear lr decay (the reference default, plain
delta adds) or AdaGrad with the accumulators in their own PS tables
(``TABLE_G_IN``/``TABLE_G_OUT`` — the reference's two adagrad gradient
matrices), pulled and pushed alongside the embeddings.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.core.options import GetOption
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.models.word2vec.commplane import collect_and_remap
from multiverso_tpu_torch.models.word2vec.data import (BatchGenerator,
                                                       BlockStream)
from multiverso_tpu_torch.models.word2vec.dictionary import (Dictionary,
                                                             HuffmanEncoder)
from multiverso_tpu_torch.models.word2vec.model import (Word2VecConfig,
                                                        raw_step)
from multiverso_tpu_torch.parallel.ps_service import (
    DistributedKVTable, DistributedMatrixTable, DistributedSparseMatrixTable,
    PSService)
from multiverso_tpu_torch.telemetry import span
from multiverso_tpu_torch.utils.log import check, log


class DistributedWord2Vec:
    """All four word2vec variants (sg/cbow x ns/hs) over process-sharded
    tables. Input and output tables have separate id spaces (HS output rows
    are Huffman inner nodes), so each is pulled/remapped/pushed with its own
    touched-row set."""

    TABLE_IN = 100
    TABLE_OUT = 101
    TABLE_G_IN = 102
    TABLE_G_OUT = 103
    TABLE_WORD_COUNT = 104   # the reference's 5th table (src/constant.h:16-20)

    def __init__(self, cfg: Word2VecConfig, dictionary: Dictionary,
                 service: PSService, peers: List[Tuple[str, int]],
                 rank: int, num_workers: Optional[int] = None,
                 sparse_tables: bool = False):
        check(cfg.param_dtype == "float32",
              "distributed mode stores float32 tables; param_dtype="
              f"'{cfg.param_dtype}' is not supported here yet")
        self.cfg = cfg
        self.dict = dictionary
        self.rank = rank
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() first")
        #: Where the pulled sub-matrices train: the Zoo's device.
        self.device = zoo.device
        self.num_workers = num_workers or len(peers)
        self._adagrad = cfg.optimizer == "adagrad"
        V, D = len(dictionary), cfg.embedding_size
        out_rows = max((V - 1) if cfg.hs else V, 1)  # HS: inner nodes
        # sparse_tables=True: row pulls become INCREMENTAL — only rows
        # written since this worker's last pull cross the wire (keyed
        # UpdateGetState); frequent words, re-pulled every block, serve
        # from the worker cache. Cost: a [rows, D] host cache per table
        # per worker — the reference sparse table's exact trade
        # (``-sparse=true`` there).
        Table = (DistributedSparseMatrixTable if sparse_tables
                 else DistributedMatrixTable)
        self._pull_opt = GetOption(worker_id=0) if sparse_tables else None
        self.w_in = Table(self.TABLE_IN, V, D, service, peers, rank)
        self.w_out = Table(self.TABLE_OUT, out_rows, D, service, peers,
                           rank)
        # AdaGrad accumulators as their own PS tables — the reference's two
        # adagrad gradient matrices (communicator.cpp:17-32). Workers pull
        # rows, accumulate locally, and push back the delta scaled by
        # 1/num_workers, the same scaling the reference applies to every
        # table's delta (GetDeltaLoop, communicator.cpp:167).
        self.g_in = self.g_out = None
        if self._adagrad:
            self.g_in = Table(self.TABLE_G_IN, V, D, service, peers, rank)
            self.g_out = Table(self.TABLE_G_OUT, out_rows, D, service,
                               peers, rank)
        # Global word-count table: every worker pushes its per-block word
        # count and the lr schedule decays on the GLOBAL sum — the
        # reference's word-count KV table + lr thread
        # (distributed_wordembedding.cpp:92-134). A rank-local count would
        # leave N-rank SGD stuck at (1 - 1/N) of its schedule. This IS a
        # KV table as in the reference (src/constant.h:16-20): int64
        # server-side accumulation, exact past 2^24 words where float32
        # would drift.
        self.word_count = DistributedKVTable(self.TABLE_WORD_COUNT,
                                             service, peers, rank,
                                             dtype=np.int64)
        self.global_trained_words = 0.0
        self._synced_words = 0
        self._wc_pending: Optional[int] = None
        self._initialized = False
        self.generator = BatchGenerator(
            dictionary, batch_size=cfg.batch_size, window=cfg.window,
            negative=cfg.negative, sample=cfg.sample, sg=cfg.sg,
            seed=cfg.seed + rank)
        self.huffman = (HuffmanEncoder(dictionary.counts,
                                       cfg.max_code_length)
                        if cfg.hs else None)
        self._raw = raw_step(cfg.sg, cfg.hs, self._adagrad)
        self.last_loss = 0.0
        self.trained_words = 0
        self.total_words = dictionary.total_count * max(cfg.epochs, 1)
        self.words_per_sec = 0.0

    def _current_lr(self) -> float:
        if self._adagrad:
            return self.cfg.learning_rate
        progress = max(self.global_trained_words, float(self.trained_words))
        frac = min(progress / max(self.total_words, 1), 1.0)
        return max(self.cfg.learning_rate * (1.0 - frac),
                   self.cfg.learning_rate * 1e-4)

    def _sync_word_count(self) -> None:
        """Push this worker's new words; pull the global count
        ASYNCHRONOUSLY — consume the get fired before the block just
        trained and fire the next one, so the PS round-trip overlaps
        compute instead of serializing the loop on it (the reference
        decouples this with a background word-count/lr thread,
        distributed_wordembedding.cpp:92-134; here the same one-block
        staleness without the thread)."""
        delta = self.trained_words - self._synced_words
        if delta > 0:
            self.word_count.add_async([0], [int(delta)])
            self._synced_words = self.trained_words
        if self._wc_pending is not None:
            self.global_trained_words = float(
                self.word_count.wait(self._wc_pending)[0])
            self._wc_pending = self.word_count.get_async([0])
        else:
            # No pipeline primed (first block, or post-train refresh after
            # train() drained it): synchronous pull, then prime.
            self.global_trained_words = float(self.word_count.get([0])[0])
            self._wc_pending = self.word_count.get_async([0])

    # -- one data block ---------------------------------------------------
    def _prepare_block(self, block: List[Sequence[int]]):
        """Host-side stage: pair generation + touched-row collection (the
        per-variant touched-row sets of w_in and w_out and the remapped
        per-batch step args, ``commplane.collect_and_remap``)."""
        batches = list(self.generator.batches(block))
        if not batches:
            return None
        ids_in, ids_out, group = collect_and_remap(
            batches, self.cfg.sg, self.cfg.hs, self.huffman,
            self.cfg.max_code_length)
        return block, ids_in, ids_out, group

    def _issue_pulls(self, prep) -> list:
        """Fire ALL four pulls async — one round-trip window instead of
        2-4 sequential ones (the reference's trainers overlap pulls the
        same way, ps_model.cpp:236-271). Dense tables only."""
        _, ids_in, ids_out, _ = prep
        ops = [self.w_in.get_rows_async(ids_in),
               self.w_out.get_rows_async(ids_out)]
        if self._adagrad:
            ops.append(self.g_in.get_rows_async(ids_in))
            ops.append(self.g_out.get_rows_async(ids_out))
        return ops

    def _train_block(self, block: List[Sequence[int]]) -> int:
        prep = self._prepare_block(block)
        if prep is None:
            return 0
        ops = self._issue_pulls(prep) if self._pull_opt is None else None
        return self._finish_block(prep, ops)

    def _finish_block(self, prep, ops) -> int:
        with span("w2v.dist_block", rank=self.rank):
            return self._finish_block_inner(prep, ops)

    def _finish_block_inner(self, prep, ops) -> int:
        block, ids_in, ids_out, group = prep
        # Sparse tables keep the sequential incremental protocol (keyed
        # UpdateGetState is stateful per pull and only re-ships rows
        # re-staled since the last one).
        if ops is not None:
            local_in = self.w_in.wait(ops[0])
            local_out = self.w_out.wait(ops[1])
        else:
            local_in = self.w_in.get_rows(ids_in, self._pull_opt)
            local_out = self.w_out.get_rows(ids_out, self._pull_opt)
        old_in, old_out = local_in.copy(), local_out.copy()
        if self._adagrad:
            if ops is not None:
                local_gin = self.g_in.wait(ops[2])
                local_gout = self.g_out.wait(ops[3])
            else:
                local_gin = self.g_in.get_rows(ids_in, self._pull_opt)
                local_gout = self.g_out.get_rows(ids_out, self._pull_opt)
            old_gin, old_gout = local_gin.copy(), local_gout.copy()
        else:
            local_gin = np.zeros_like(local_in)
            local_gout = np.zeros_like(local_out)

        new_in, new_out, new_gin, new_gout = self._train_group(
            (local_in, local_out, local_gin, local_gout), group)

        # Push averaged deltas (AddDeltaParameter analog): the reference
        # divides EVERY table's delta by the worker count, accumulators
        # included (communicator.cpp:167). Async pushes: deltas stage in the
        # native buffer and flush as one frame per server when the next
        # block's pull arrives on the same FIFO stream (GetDeltaLoop's
        # overlap, distributed_wordembedding.cpp:157-171, without its
        # per-request reply waits).
        scale = 1.0 / self.num_workers
        self.w_in.add_rows_async(ids_in,
                                 (np.asarray(new_in) - old_in) * scale)
        self.w_out.add_rows_async(ids_out,
                                  (np.asarray(new_out) - old_out) * scale)
        if self._adagrad:
            self.g_in.add_rows_async(ids_in,
                                     (np.asarray(new_gin) - old_gin) * scale)
            self.g_out.add_rows_async(
                ids_out, (np.asarray(new_gout) - old_gout) * scale)
        return sum(len(s) for s in block)

    def _train_group(self, pulled, group) -> Tuple[np.ndarray, ...]:
        """The block's batches, in order, through the variant's plain step
        on the pulled sub-matrices on the device; returns the trained
        sub-matrices on the host. The JAX package pads the group to a power
        of two with masked-out batches so its scan compiles once per
        bucket; such a batch changes no table, so the port runs the real
        batches only."""
        dev = self.device
        tables = [torch.tensor(t, dtype=torch.float32, device=dev)
                  for t in pulled]
        args = [torch.as_tensor(np.stack([b[i] for b in group]), device=dev)
                for i in range(len(group[0]))]
        lr = torch.tensor(np.float32(self._current_lr()), device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(len(group)):
            loss = loss + self._raw(*tables, *[a[k] for a in args], lr)
        self.last_loss = float(loss)
        return tuple(t.cpu().numpy() for t in tables)

    # -- training -----------------------------------------------------------
    def _maybe_master_init(self) -> None:
        """Master-only random init (the binding trick: everyone else adds
        zero). Deferred to train() so construction never requires a remote
        peer to exist yet (peers' dispatch waits on table registration)."""
        if self._initialized:
            return
        self._initialized = True
        V, D = len(self.dict), self.cfg.embedding_size
        if self.rank == 0:
            rng = np.random.default_rng(self.cfg.seed)
            init = rng.uniform(-0.5 / D, 0.5 / D, size=(V, D)) \
                .astype(np.float32)
            self.w_in.add_rows(np.arange(V, dtype=np.int32), init)
        elif self.w_in._bsp:
            # BSP: non-masters issue one zero add so every worker's add
            # clock ticks uniformly — the reference binding's master-init
            # trick (binding/python/multiverso/tables.py: master sets
            # init_value, everyone else adds zeros). One row suffices:
            # an add ticks each server's clock exactly once regardless of
            # payload (_bsp_tick_parts fans a tick to non-routed servers).
            self.w_in.add_rows(np.zeros(1, dtype=np.int32),
                               np.zeros((1, D), dtype=np.float32))

    def train(self, sentences: Iterable[Sequence[int]],
              epochs: Optional[int] = None,
              on_block=None) -> dict:
        """Train; ``on_block(block_index, trained_words)`` fires after every
        data block (progress hook — the fault drill and dashboards use it).
        In BSP mode the worker retires its server-side clocks when done
        (``Zoo::FinishTrain`` on shutdown, ref src/zoo.cpp:106,152-161) so
        peers with more data don't wait on it forever."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        check(not getattr(self, "_bsp_retired", False),
              "train() is single-shot in BSP mode: this worker's clocks "
              "were retired by finish_train at the end of the previous "
              "call (pass all epochs in one call, as the reference's "
              "one-shot Zoo::FinishTrain contract requires)")
        self._maybe_master_init()
        t0 = time.perf_counter()
        n_blocks = 0
        # Double-buffered param prefetch (cfg.param_prefetch): block N+1's
        # pulls are in flight while block N computes. Async dense mode
        # only — BSP needs strict per-worker op order and sparse pulls
        # are stateful.
        prefetch = (self.cfg.param_prefetch and self._pull_opt is None
                    and not self.w_in._bsp)

        def done_one(words: int) -> None:
            nonlocal n_blocks
            self.trained_words += words
            self._sync_word_count()
            n_blocks += 1
            if on_block is not None:
                on_block(n_blocks, self.trained_words)

        for _ in range(epochs):
            stream = BlockStream(iter(sentences), self.cfg.block_words,
                                 prefetch=self.cfg.pipeline)
            if prefetch:
                pending = None
                for block in stream:
                    prep = self._prepare_block(block)
                    if prep is None:
                        done_one(0)     # block numbering parity with the
                        continue        # non-prefetch path (on_block fires)
                    ops = self._issue_pulls(prep)
                    if pending is not None:
                        done_one(self._finish_block(*pending))
                    pending = (prep, ops)
                if pending is not None:
                    done_one(self._finish_block(*pending))
            else:
                for block in stream:
                    done_one(self._train_block(block))
        # Drain staged pushes so peers (e.g. the saving master) see this
        # worker's last deltas after their barrier.
        for table in (self.w_in, self.w_out, self.g_in, self.g_out,
                      self.word_count):
            if table is not None:
                table.flush(wait=True)
        # Retire the pipelined word-count get: training ends with the
        # pipeline unprimed, so the next _sync_word_count pulls fresh.
        if self._wc_pending is not None:
            self.word_count.wait(self._wc_pending)
            self._wc_pending = None
        # BSP: this worker is done — set its clocks to infinity on every
        # shard (Server_Finish_Train, ref src/zoo.cpp:106 via StopPS +
        # src/server.cpp:190-213) so peers still training never gate on it.
        # Post-retire reads (e.g. the master's embeddings() pull) drain once
        # every worker has retired (INF <= INF is admissible).
        if self.w_in._bsp:
            self._bsp_retired = True
            for table in (self.w_in, self.w_out, self.g_in, self.g_out,
                          self.word_count):
                if table is not None:
                    table.finish_train()
        elapsed = time.perf_counter() - t0
        self.words_per_sec = self.trained_words / max(elapsed, 1e-9)
        return {"words": self.trained_words,
                "words_per_sec": self.words_per_sec, "seconds": elapsed}

    def embeddings(self) -> np.ndarray:
        return self.w_in.get_rows(np.arange(len(self.dict), dtype=np.int32))
