"""Distributed WordEmbedding CLI (port of
``multiverso_tpu/apps/word2vec_main.py``).

Parity with ``Applications/WordEmbedding/src/main.cpp``: train word
vectors from a text corpus, flags named after the reference/word2vec
conventions, rank-0 embedding export. All four variants (``-cbow``,
``-hs``) and both paths (``-use_device_pipeline=true`` on-device example
generation, ``false`` the host batch path). Runs on the CUDA card unless
``-w2v_device=cpu`` (or ``-platform=cpu``) is given. ``-world_size=N``
launches N rank processes on this host that train through the host PS
service (``models/word2vec/distributed.py``); they run on the card too
(several processes share one H100) unless ``-w2v_device=cpu`` is given.

Usage:
    python -m multiverso_tpu_torch.apps.word2vec_main \
        -train_file=corpus.txt -output_file=vectors.txt \
        -size=128 -window=5 -negative=5 -min_count=5 -epoch=1
"""

from __future__ import annotations

import sys
from typing import List

from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.dashboard import Dashboard
from multiverso_tpu_torch.utils.log import log

configure.define_string("train_file", "", "input corpus (text)")
configure.define_string("output_file", "vectors.txt", "embedding output")
configure.define_int("size", 100, "embedding dimension")
configure.define_int("window", 5, "context window")
configure.define_int("negative", 5, "negative samples (0 -> use -hs)")
configure.define_int("min_count", 5, "vocab frequency cutoff")
configure.define_int("epoch", 1, "training epochs")
configure.define_double("alpha", 0.05, "learning rate")
configure.define_double("sample", 1e-3, "frequent-word subsample rate")
configure.define_bool("cbow", False, "CBOW instead of skip-gram")
configure.define_bool("hs", False, "hierarchical softmax")
configure.define_int("batch_size", 8192, "pairs per device minibatch")
configure.define_bool("is_pipeline", True, "prefetch pipeline")
configure.define_bool("param_prefetch", False,
                      "distributed: double-buffered param pulls")
configure.define_int("data_block_size", 100000, "words per block")
configure.define_string("w2v_optimizer", "adagrad", "adagrad|sgd")
configure.define_bool("use_device_pipeline", True,
                      "on-device pair generation")
configure.define_int("block_sentences", 512,
                     "sentences per device block (device pipeline)")
configure.define_int("pad_sentence_length", 512,
                     "sentence pad length (device pipeline)")
configure.define_string("dispatch_mode", "auto",
                        "chunk-loop execution: auto|in_graph|"
                        "pipelined_host|pallas_grid (auto: the CUDA "
                        "kernel on a card, the plain torch loop on the "
                        "CPU)")
configure.define_int("dispatch_depth", 8,
                     "pipelined_host: chunk dispatches in flight")
configure.define_int("world_size", 1, "number of distributed worker ranks")
configure.define_int("w2v_rank", -1, "this rank (set by the launcher)")
configure.define_string("rendezvous_dir", "",
                        "shared dir for address exchange")
configure.define_string("w2v_summary_dir", "",
                        "distributed ranks: each writes rank<r>.json (words, "
                        "words/sec, last block loss, row kernel launches) "
                        "and rank<r>.npy (its embeddings() pulled after "
                        "every rank trained) here")
configure.define_string("w2v_device", "default",
                        "default|cpu: every rank, single or distributed, "
                        "runs on the card unless -w2v_device=cpu is "
                        "given; the local ranks of -world_size>1 share "
                        "the one card")


def _cfg_from_flags(device_pipeline: bool = True) -> "Word2VecConfig":
    """The one flag -> config mapping, shared by the local and distributed
    bodies. ``device_pipeline=False`` for distributed ranks: the
    pull-train-push ``DistributedWord2Vec`` generates pairs on the host to
    know its touched-row sets up front."""
    from multiverso_tpu_torch.apps._runner import comm_config
    from multiverso_tpu_torch.models.word2vec import Word2VecConfig

    comm = comm_config()
    return Word2VecConfig(
        embedding_size=configure.get_flag("size"),
        window=configure.get_flag("window"),
        negative=configure.get_flag("negative"),
        min_count=configure.get_flag("min_count"),
        sample=configure.get_flag("sample"),
        batch_size=configure.get_flag("batch_size"),
        learning_rate=configure.get_flag("alpha"),
        epochs=configure.get_flag("epoch"),
        sg=not configure.get_flag("cbow"), hs=configure.get_flag("hs"),
        optimizer=configure.get_flag("w2v_optimizer"),
        block_words=configure.get_flag("data_block_size"),
        pipeline=configure.get_flag("is_pipeline"),
        param_prefetch=configure.get_flag("param_prefetch"),
        device_pipeline=(device_pipeline and
                         configure.get_flag("use_device_pipeline")),
        block_sentences=configure.get_flag("block_sentences"),
        pad_sentence_length=configure.get_flag("pad_sentence_length"),
        dispatch_mode=configure.get_flag("dispatch_mode"),
        dispatch_depth=configure.get_flag("dispatch_depth"),
        comm_policy=comm["comm_policy"],
        comm_policy_overrides=comm["comm_policy_overrides"],
    )


def _body_distributed(world: int, rank: int) -> int:
    from multiverso_tpu_torch.apps._runner import rendezvous, wait_all_done
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.models.word2vec import Dictionary, read_corpus
    from multiverso_tpu_torch.models.word2vec.distributed import \
        DistributedWord2Vec
    from multiverso_tpu_torch.parallel.ps_service import PSService

    train_file = configure.get_flag("train_file")
    if not train_file:
        log.error("missing -train_file")
        return 1
    rdv = configure.get_flag("rendezvous_dir")
    if not rdv:
        log.error("distributed rank needs -rendezvous_dir")
        return 1
    dictionary = Dictionary.build(read_corpus(train_file),
                                  min_count=configure.get_flag("min_count"))
    log.info("rank %d/%d: vocab=%d on %s", rank, world, len(dictionary),
             Zoo.get().device)
    cfg = _cfg_from_flags(device_pipeline=False)
    svc = PSService()
    try:
        peers = rendezvous(rdv, rank, world, svc.address)
        w2v = DistributedWord2Vec(cfg, dictionary, svc, peers, rank=rank)
        sents = (dictionary.encode(s) for i, s in
                 enumerate(read_corpus(train_file)) if i % world == rank)
        stats = w2v.train(sents)
        log.info("rank %d trained on %s: %.0f words/sec, %d words, last "
                 "block loss %.6f", rank, w2v.device,
                 stats["words_per_sec"], stats["words"], w2v.last_loss)
        # Every rank's pushes land before anyone reads the tables back.
        wait_all_done(rdv, rank, world, tag="trained")
        emb = w2v.embeddings().astype("float32")
        summary_dir = configure.get_flag("w2v_summary_dir")
        if summary_dir:
            _write_summary(summary_dir, rank, stats, w2v, emb)
        if rank == 0:
            out = configure.get_flag("output_file")
            with open(out, "w") as f:
                f.write(f"{len(dictionary)} {cfg.embedding_size}\n")
                for i, vec in enumerate(emb):
                    f.write(dictionary.words[i] + " " +
                            " ".join(f"{x:.6f}" for x in vec) + "\n")
            log.info("rank 0 saved %s", out)
        wait_all_done(rdv, rank, world)
        svc.check_fatal()
    finally:
        svc.close()
    Dashboard.display(echo=True)
    return 0


def _write_summary(directory: str, rank: int, stats: dict, w2v,
                   emb) -> None:
    import json
    import os

    import numpy as np

    from multiverso_tpu_torch.ops import rows

    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, f"rank{rank}.npy"), emb)
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(w2v.device),
                   "words": stats["words"], "seconds": stats["seconds"],
                   "words_per_sec": stats["words_per_sec"],
                   "last_loss": w2v.last_loss,
                   "launches": dict(rows.LAUNCHES)}, f)


def _body(argv: List[str]) -> int:
    del argv
    from multiverso_tpu_torch.models.word2vec import (Dictionary, Word2Vec,
                                                      read_corpus)

    world = configure.get_flag("world_size")
    rank = configure.get_flag("w2v_rank")
    if world > 1 and rank >= 0:
        return _body_distributed(world, rank)

    train_file = configure.get_flag("train_file")
    if not train_file:
        log.error("missing -train_file")
        return 1
    log.info("building vocabulary from %s", train_file)
    dictionary = Dictionary.build(read_corpus(train_file),
                                  min_count=configure.get_flag("min_count"))
    log.info("vocab=%d total_words=%d", len(dictionary),
             dictionary.total_count)
    w2v = Word2Vec(_cfg_from_flags(), dictionary)
    stats = w2v.train(corpus_path=train_file)
    log.info("trained on %s (%s): %.0f words/sec, loss %.4f", w2v.device,
             w2v.dispatch_mode or "host batch path", stats["words_per_sec"],
             stats["loss"])
    w2v.save(configure.get_flag("output_file"))
    Dashboard.display(echo=True)
    return 0


def main(argv=None) -> int:
    from multiverso_tpu_torch.apps._runner import (_flag_value,
                                                   pin_device_if_requested,
                                                   run_app, spawn_ranks)

    args = list(argv if argv is not None else sys.argv[1:])
    # The launcher runs BEFORE run_app: it must not start the runtime (or
    # touch the card) just to fork workers. Raw-argv scan: flags are not
    # parsed yet.
    world = int(_flag_value(args, "world_size") or 1)
    has_rank = int(_flag_value(args, "w2v_rank") or -1) >= 0
    if world > 1 and not has_rank:
        return spawn_ranks("multiverso_tpu_torch.apps.word2vec_main", args,
                           world, rank_flag="w2v_rank")
    pin_device_if_requested(args, device_flag="w2v_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
