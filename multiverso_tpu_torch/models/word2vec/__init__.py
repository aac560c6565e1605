from multiverso_tpu_torch.models.word2vec.data import (BatchGenerator,
                                                       BlockStream,
                                                       CbowBatch,
                                                       SkipGramBatch,
                                                       read_corpus)
from multiverso_tpu_torch.models.word2vec.dictionary import (Dictionary,
                                                             HuffmanEncoder,
                                                             Sampler)
from multiverso_tpu_torch.models.word2vec.model import (DISPATCH_MODES,
                                                        Word2Vec,
                                                        Word2VecConfig,
                                                        resolve_dispatch_mode)

__all__ = ["Word2Vec", "Word2VecConfig", "Dictionary", "HuffmanEncoder",
           "Sampler", "BatchGenerator", "BlockStream", "SkipGramBatch",
           "CbowBatch", "read_corpus", "DISPATCH_MODES",
           "resolve_dispatch_mode"]
