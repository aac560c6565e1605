from multiverso_tpu_torch.binding.param_manager import (PyTreeParamManager,
                                                        SyncCallback,
                                                        TorchParamManager)

__all__ = ["PyTreeParamManager", "TorchParamManager", "SyncCallback"]
