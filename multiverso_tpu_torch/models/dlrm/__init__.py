"""DLRM-style online recommender (port of ``multiverso_tpu/models/dlrm``).

The model (``model.py`` — PS embedding tables + the hybrid dense step,
with a bitwise local twin), the synthetic drifting impression stream
(``stream.py``) and the streaming quality metrics (``metrics.py``). The
train-while-serve loop that drives them lives in
:mod:`multiverso_tpu_torch.recsys.online`; the CLI is
``python -m multiverso_tpu_torch.apps.dlrm_main``.
"""

from multiverso_tpu_torch.models.dlrm.metrics import StreamingAUC, exact_auc
from multiverso_tpu_torch.models.dlrm.model import (DLRMConfig, DLRMModel,
                                                    SnapshotScorer,
                                                    dense_param_count,
                                                    flatten_dense,
                                                    init_dense_params,
                                                    make_forward,
                                                    unflatten_dense)
from multiverso_tpu_torch.models.dlrm.stream import (ImpressionStream,
                                                     Impressions,
                                                     StreamConfig, zipf_ids)

__all__ = [
    "DLRMConfig", "DLRMModel", "SnapshotScorer", "dense_param_count",
    "flatten_dense", "init_dense_params", "make_forward", "unflatten_dense",
    "ImpressionStream", "Impressions", "StreamConfig", "zipf_ids",
    "StreamingAUC", "exact_auc",
]
