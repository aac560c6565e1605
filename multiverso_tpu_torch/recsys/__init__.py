"""Online recommender serving+training loop (port of
``multiverso_tpu/recsys``): :mod:`multiverso_tpu_torch.recsys.online`
drives train -> checkpoint -> replica-publish -> serve -> retrain
continuously over the DLRM model (:mod:`multiverso_tpu_torch.models.dlrm`).
"""

from multiverso_tpu_torch.recsys.online import (FreshnessTracker,
                                                OnlineConfig, OnlineLoop,
                                                ServeLoad, make_live_runner)

__all__ = ["FreshnessTracker", "OnlineConfig", "OnlineLoop", "ServeLoad",
           "make_live_runner"]
