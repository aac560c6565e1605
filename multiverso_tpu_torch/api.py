"""Public API — the ``MV_*`` surface (port of ``multiverso_tpu/api.py``).

Parity with ``include/multiverso/multiverso.h:9-65``: init/shutdown/
barrier, rank/size/worker/server queries, flag override, table creation
(the ``table_factory`` dispatch) and allreduce aggregate. ``init`` puts
the tables on the CUDA card unless ``-platform=cpu`` is given, and raises
when there is no card; with ``-coordinator`` (or ``-machine_file``) it
joins a ``torch.distributed`` world, over which ``rank``, ``size``,
``barrier`` and ``aggregate`` run. ``net_bind``/``net_connect`` and the
``create_distributed_*`` tables share tables across processes through the
host PS service (``parallel/ps_service.py``); each rank's shard lives on
its Zoo's device.
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
    """``MV_Aggregate`` analog: allreduce-SUM across the world's ranks
    (``parallel/collectives.py``). A tensor comes back as a tensor on its
    device, anything else as a numpy array; at one rank, a copy of the
    data."""
    from multiverso_tpu_torch.parallel import collectives
    return collectives.aggregate(data)


def net_bind(host: str = "127.0.0.1", port: int = 0):
    """``MV_NetBind`` analog (ref src/multiverso.cpp:58-62): start this
    process's PS service listener; returns (host, port). With ``-wal``
    the write-ahead delta log is armed before any table registers, in a
    per-rank subdirectory of ``-wal_dir``."""
    import os

    from multiverso_tpu_torch.parallel.ps_service import PSService
    from multiverso_tpu_torch.utils.configure import flag_or

    zoo = Zoo.get()
    check(zoo.started, "call mv.init() first")
    check(zoo.ps_service is None, "service already bound")
    zoo.ps_service = PSService(host, port)
    if bool(flag_or("wal", False)):
        wal_dir = str(flag_or("wal_dir", ""))
        check(bool(wal_dir), "-wal=true requires -wal_dir=DIR")
        zoo.ps_service.attach_wal(
            os.path.join(wal_dir, f"rank{int(flag_or('rank', 0))}"),
            flush_interval_ms=float(flag_or("wal_flush_ms", 25.0)),
            sync_acks=bool(flag_or("wal_sync_acks", False)))
    return zoo.ps_service.address


def net_connect(peers) -> None:
    """``MV_NetConnect`` analog (ref src/multiverso.cpp:64-68): record the
    full peer list ((host, port) per rank, this process's own entry
    included) used by distributed tables."""
    zoo = Zoo.get()
    check(zoo.started, "call mv.init() first")
    zoo.ps_peers = [tuple(p) for p in peers]


def _bound_service():
    zoo = Zoo.get()
    check(zoo.ps_service is not None, "call mv.net_bind() first")
    check(len(zoo.ps_peers) > 0, "call mv.net_connect() first")
    return zoo


def create_distributed_array_table(table_id: int, size: int, rank: int,
                                   dtype=None, updater: str = "default",
                                   use_pallas: bool = False):
    """Distributed (process-sharded) array table over the bound service +
    connected peers; this rank's shard lives on the Zoo's device."""
    from multiverso_tpu_torch.parallel.ps_service import \
        DistributedArrayTable

    zoo = _bound_service()
    table = DistributedArrayTable(table_id, size, zoo.ps_service,
                                  list(zoo.ps_peers), rank,
                                  dtype=dtype or np.float32,
                                  updater=updater, use_pallas=use_pallas)
    zoo.register_table(table)   # so shutdown closes its peer connections
    return table


def create_distributed_matrix_table(table_id: int, num_row: int,
                                    num_col: int, rank: int, dtype=None,
                                    updater: str = "default",
                                    use_pallas: bool = False):
    """Distributed (row-sharded across processes) matrix table over the
    bound service + connected peers (ref ``matrix_table.cpp:24-45`` row
    sharding, served by the host PS service). ``use_pallas`` gives this
    rank's shard the hand-written row kernels, as ``MatrixTableOption``
    does a local table."""
    from multiverso_tpu_torch.parallel.ps_service import \
        DistributedMatrixTable

    zoo = _bound_service()
    table = DistributedMatrixTable(table_id, num_row, num_col,
                                   zoo.ps_service, list(zoo.ps_peers), rank,
                                   dtype=dtype or np.float32,
                                   updater=updater, use_pallas=use_pallas)
    zoo.register_table(table)
    return table


def create_distributed_kv_table(table_id: int, rank: int, dtype=None):
    """Distributed (hash-partitioned across processes) key->value table
    over the bound service + connected peers (ref
    ``include/multiverso/table/kv_table.h:42-66``: key % num_servers
    routing, += merge server-side, on the host)."""
    from multiverso_tpu_torch.parallel.ps_service import DistributedKVTable

    zoo = _bound_service()
    table = DistributedKVTable(table_id, zoo.ps_service,
                               list(zoo.ps_peers), rank,
                               dtype=dtype or np.int64)
    zoo.register_table(table)
    return table


def create_distributed_sparse_matrix_table(table_id: int, num_row: int,
                                           num_col: int, rank: int,
                                           dtype=None,
                                           updater: str = "default",
                                           use_pallas: bool = False):
    """Distributed row-sharded matrix with SERVER-SIDE per-worker
    staleness: incremental whole-table Gets ship only rows touched since
    this worker's last pull (ref ``src/table/sparse_matrix_table.cpp:
    184-258``)."""
    from multiverso_tpu_torch.parallel.ps_service import \
        DistributedSparseMatrixTable

    zoo = _bound_service()
    table = DistributedSparseMatrixTable(table_id, num_row, num_col,
                                         zoo.ps_service,
                                         list(zoo.ps_peers), rank,
                                         dtype=dtype or np.float32,
                                         updater=updater,
                                         use_pallas=use_pallas)
    zoo.register_table(table)
    return table


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
