"""Public API — the ``MV_*`` surface (port of ``multiverso_tpu/api.py``).

Parity with ``include/multiverso/multiverso.h:9-65``: init/shutdown/
barrier, rank/size/worker/server queries, flag override, table creation
(the ``table_factory`` dispatch) and allreduce aggregate. ``init`` puts
the tables on the CUDA card unless ``-platform=cpu`` is given, and raises
when there is no card.

Not ported yet (``NotImplementedError``): ``net_bind``/``net_connect``
and the ``create_distributed_*`` tables (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from multiverso_tpu_torch.core.options import (ArrayTableOption,
                                               KVTableOption,
                                               MatrixTableOption, TableOption)
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.log import check


def init(argv: Optional[List[str]] = None, sync: Optional[bool] = None,
         num_local_workers: int = 1,
         device: Optional[torch.device] = None) -> List[str]:
    """``MV_Init`` analog: parse ``-key=value`` flags out of argv (returning
    the rest), then start the runtime on ``device`` (default: ``cuda:0``,
    or the CPU under ``-platform=cpu``)."""
    if sync is not None:
        configure.set_flag("sync", bool(sync))
    return Zoo.get().start(argv, device=device,
                           num_local_workers=num_local_workers)


def shutdown(finalize_net: bool = True) -> None:
    """``MV_ShutDown`` analog."""
    Zoo.get().stop(finalize_net)
    Zoo._reset_for_tests()


def barrier() -> None:
    Zoo.get().barrier()


def rank() -> int:
    return Zoo.get().rank()


def size() -> int:
    return Zoo.get().size()


def num_workers() -> int:
    return Zoo.get().num_workers()


def num_servers() -> int:
    return Zoo.get().num_servers()


def worker_id() -> int:
    return Zoo.get().worker_id()


def server_id() -> int:
    return Zoo.get().server_id()


def is_master_worker() -> bool:
    return worker_id() == 0


def set_flag(name: str, value: Any) -> None:
    configure.set_flag(name, value)


def get_flag(name: str) -> Any:
    return configure.get_flag(name)


def create_table(option: TableOption):
    """``MV_CreateTable`` + table_factory dispatch."""
    from multiverso_tpu_torch.tables.array_table import ArrayTable
    from multiverso_tpu_torch.tables.device_kv_table import DeviceKVTable
    from multiverso_tpu_torch.tables.kv_table import KVTable
    from multiverso_tpu_torch.tables.matrix_table import MatrixTable
    from multiverso_tpu_torch.tables.sparse_matrix_table import \
        SparseMatrixTable

    zoo = Zoo.get()
    check(zoo.started, "call mv.init() first")
    check(not zoo.ma_mode,
          "table service is disabled in model-average (-ma) mode "
          "(ref src/zoo.cpp:49)")
    if isinstance(option, ArrayTableOption):
        table = ArrayTable(option)
    elif isinstance(option, MatrixTableOption):
        table = (SparseMatrixTable(option) if option.is_sparse
                 else MatrixTable(option))
    elif isinstance(option, KVTableOption):
        table = (DeviceKVTable(option, value_dim=option.value_dim)
                 if option.device else KVTable(option))
    else:
        raise TypeError(f"unknown table option {type(option).__name__}")
    barrier()  # ref multiverso.h:40: creation is followed by a barrier
    return table


def aggregate(data):
    """``MV_Aggregate`` analog: allreduce-SUM across processes. One
    process is the whole world in this slice, so the sum is the data
    (the multi-process sum waits: ROADMAP A7)."""
    return np.array(data, copy=True)


def _waits_a7(what: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{what} (the host PS service) is not "
                                  "ported yet: ROADMAP A7")
    fn.__name__ = what
    return fn


net_bind = _waits_a7("net_bind")
net_connect = _waits_a7("net_connect")
create_distributed_array_table = _waits_a7("create_distributed_array_table")
create_distributed_matrix_table = _waits_a7("create_distributed_matrix_table")
create_distributed_kv_table = _waits_a7("create_distributed_kv_table")
create_distributed_sparse_matrix_table = _waits_a7(
    "create_distributed_sparse_matrix_table")


def finish_train(worker_id: Optional[int] = None) -> None:
    """``Zoo::FinishTrain`` analog: release this worker from every table's
    BSP clocks so stragglers can drain to shutdown."""
    zoo = Zoo.get()
    wid = worker_id if worker_id is not None else zoo.worker_id()
    if wid < 0:
        return
    for table in zoo.tables:
        ft = getattr(table, "finish_train", None)
        if ft is not None:
            ft(wid)
