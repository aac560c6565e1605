"""LDA CLI — lightLDA-style topic modeling on PS tables (port of
``multiverso_tpu/apps/lda_main.py``). Runs on the CUDA card unless
``-lda_device=cpu`` (or ``-platform=cpu``) is given.

Usage:
    python -m multiverso_tpu_torch.apps.lda_main -docs_file=docs.txt \
        -num_topics=20 -lda_iterations=100 -topn=10

Input: one document per line, whitespace-tokenized.
"""

from __future__ import annotations

import sys
from typing import List

from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.dashboard import Dashboard
from multiverso_tpu_torch.utils.log import log

configure.define_string("docs_file", "", "input corpus, one doc per line")
configure.define_int("num_topics", 16, "topic count")
configure.define_int("lda_iterations", 50, "Gibbs sweeps")
configure.define_double("lda_alpha", 0.1, "doc-topic prior")
configure.define_double("lda_beta", 0.01, "topic-word prior")
configure.define_int("topn", 10, "top words to print per topic")
configure.define_int("lda_min_count", 1, "vocab frequency cutoff")
configure.define_string("lda_device", "default",
                        "device (cpu|default): the card unless "
                        "-lda_device=cpu")


def _body(argv: List[str]) -> int:
    del argv
    import numpy as np

    from multiverso_tpu_torch.models.lda import LDA, LDAConfig
    from multiverso_tpu_torch.models.word2vec.dictionary import Dictionary

    docs_file = configure.get_flag("docs_file")
    if not docs_file:
        log.error("missing -docs_file")
        return 1
    with open(docs_file) as f:
        docs_tokens = [line.split() for line in f if line.strip()]
    dictionary = Dictionary.build(
        docs_tokens, min_count=configure.get_flag("lda_min_count"))
    log.info("docs=%d vocab=%d", len(docs_tokens), len(dictionary))

    words: List[int] = []
    doc_ids: List[int] = []
    for d, tokens in enumerate(docs_tokens):
        ids = dictionary.encode(tokens)
        words.extend(ids)
        doc_ids.extend([d] * len(ids))

    cfg = LDAConfig(num_topics=configure.get_flag("num_topics"),
                    alpha=configure.get_flag("lda_alpha"),
                    beta=configure.get_flag("lda_beta"),
                    iterations=configure.get_flag("lda_iterations"))
    lda = LDA(cfg, num_docs=len(docs_tokens), vocab_size=len(dictionary))
    stats = lda.train(np.asarray(words), np.asarray(doc_ids))
    log.info("trained on %s: %.0f tokens/sec", lda.device,
             stats["tokens_per_sec"])

    topn = configure.get_flag("topn")
    for k in range(cfg.num_topics):
        top = ", ".join(dictionary.words[w] for w in lda.top_words(k, topn))
        log.raw(f"topic {k:3d}: {top}")
    Dashboard.display(echo=True)
    return 0


def main(argv=None) -> int:
    from multiverso_tpu_torch.apps._runner import (pin_device_if_requested,
                                                   run_app)

    args = argv if argv is not None else sys.argv[1:]
    pin_device_if_requested(args, device_flag="lda_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
