from multiverso_tpu_torch.models.logreg.logreg import LogReg
from multiverso_tpu_torch.models.logreg.model import (AllreduceModel,
                                                      LocalModel,
                                                      LogRegConfig,
                                                      ModelAverageModel,
                                                      PSModel, make_model)
from multiverso_tpu_torch.models.logreg.reader import (ArrayBatcher,
                                                       SampleReader,
                                                       parse_dense_line,
                                                       parse_libsvm_line)

__all__ = ["LogReg", "LogRegConfig", "LocalModel", "PSModel",
           "AllreduceModel", "ModelAverageModel", "make_model",
           "SampleReader", "ArrayBatcher", "parse_libsvm_line",
           "parse_dense_line"]
