"""Distributed WordEmbedding CLI (port of
``multiverso_tpu/apps/word2vec_main.py``).

Parity with ``Applications/WordEmbedding/src/main.cpp``: train word
vectors from a text corpus, flags named after the reference/word2vec
conventions, rank-0 embedding export. All four variants (``-cbow``,
``-hs``) and both paths (``-use_device_pipeline=true`` on-device example
generation, ``false`` the host batch path). Runs on the CUDA card unless
``-w2v_device=cpu`` (or ``-platform=cpu``) is given. Multi-rank training
(``-world_size>1``) waits (ROADMAP A7).

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
configure.define_string("w2v_device", "cpu",
                        "distributed ranks: device (cpu|default); a "
                        "single-process run uses the card unless "
                        "-w2v_device=cpu is given explicitly")


def _cfg_from_flags() -> "Word2VecConfig":
    """The flag -> config mapping of the single-process trainer."""
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
        device_pipeline=configure.get_flag("use_device_pipeline"),
        block_sentences=configure.get_flag("block_sentences"),
        pad_sentence_length=configure.get_flag("pad_sentence_length"),
        dispatch_mode=configure.get_flag("dispatch_mode"),
        dispatch_depth=configure.get_flag("dispatch_depth"),
        comm_policy=comm["comm_policy"],
        comm_policy_overrides=comm["comm_policy_overrides"],
    )


def _body(argv: List[str]) -> int:
    del argv
    from multiverso_tpu_torch.models.word2vec import (Dictionary, Word2Vec,
                                                      read_corpus)

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
    from multiverso_tpu_torch.apps._runner import (pin_device_if_requested,
                                                   run_app)

    args = argv if argv is not None else sys.argv[1:]
    world = next((int(a.split("=", 1)[1]) for a in args
                  if a.lstrip("-").startswith("world_size=")), 1)
    if world > 1:
        raise NotImplementedError(
            "multi-rank word2vec (-world_size>1) is not ported yet: "
            "ROADMAP A7")
    pin_device_if_requested(args, device_flag="w2v_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
