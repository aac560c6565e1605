"""multiverso_tpu_torch — the PyTorch + CUDA port of multiverso_tpu.

The parameter-server table plane (Array/Matrix/KV tables, server-side
updaters, BSP clocks) and the word2vec skip-gram negative-sampling
trainer, on one NVIDIA H100, with the TPU package's Pallas kernels on
this path rewritten by hand in CUDA C++ (``csrc/``): the row gather, the
sorted scatter-add and the whole-block sg-ns trainer. The same ``mv.*``
surface and ``-flag=value`` flags as ``multiverso_tpu``; tables live on
``cuda:0`` unless ``-platform=cpu`` is given. The JAX package stays the
reference; this package never imports it or JAX.
"""

from multiverso_tpu_torch.api import (aggregate, barrier, create_table,
                                      create_distributed_array_table,
                                      create_distributed_kv_table,
                                      create_distributed_matrix_table,
                                      create_distributed_sparse_matrix_table,
                                      finish_train, get_flag, init,
                                      is_master_worker, net_bind,
                                      net_connect, num_servers, num_workers,
                                      rank, server_id, set_flag, shutdown,
                                      size, worker_id)
from multiverso_tpu_torch.core.options import (AddOption, ArrayTableOption,
                                               GetOption, KVTableOption,
                                               MatrixTableOption)

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "barrier", "rank", "size", "num_workers",
    "num_servers", "worker_id", "server_id", "is_master_worker",
    "set_flag", "get_flag", "create_table", "aggregate", "finish_train",
    "net_bind", "net_connect", "create_distributed_array_table",
    "create_distributed_matrix_table", "create_distributed_kv_table",
    "create_distributed_sparse_matrix_table",
    "AddOption", "GetOption", "ArrayTableOption", "MatrixTableOption",
    "KVTableOption",
]
