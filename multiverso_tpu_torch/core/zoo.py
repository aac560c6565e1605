"""Zoo — the runtime singleton: lifecycle, roles, registry, barrier.

Port of ``multiverso_tpu/core/zoo.py`` (ref ``include/multiverso/zoo.h``,
``src/zoo.cpp``): startup/shutdown ordering, node roles, table
registration, rank/size/worker/server queries and the global barrier.

The Zoo's own world is one process: one worker rank, one server shard on
one device (:func:`multiverso_tpu_torch.parallel.device.resolve_device`).
Several processes share tables through the host PS service
(``parallel/ps_service.py``): ``mv.net_bind`` keeps this process's
service in :attr:`Zoo.ps_service` and ``mv.net_connect`` the peer list in
:attr:`Zoo.ps_peers`. Multi-process start-up through a process group
(``-coordinator``, ``-machine_file``) waits for the ``torch.distributed``
plane (ROADMAP A7) and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from multiverso_tpu_torch.parallel import device as device_lib
from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check, log


class Role:
    """Bitmask roles (ref include/multiverso/node.h:6-27)."""
    NONE = 0
    WORKER = 1
    SERVER = 2
    ALL = 3

    _BY_NAME = {"none": NONE, "worker": WORKER, "server": SERVER,
                "default": ALL, "all": ALL}

    @classmethod
    def parse(cls, name: str) -> int:
        try:
            return cls._BY_NAME[name.lower()]
        except KeyError:
            raise ValueError(f"unknown ps_role '{name}'") from None

    @staticmethod
    def is_worker(role: int) -> bool:
        return bool(role & Role.WORKER)

    @staticmethod
    def is_server(role: int) -> bool:
        return bool(role & Role.SERVER)


class Zoo:
    _instance: Optional["Zoo"] = None
    _lock = make_lock("core.zoo")

    def __init__(self) -> None:
        self.started = False
        self.device: Optional[torch.device] = None
        self.role: int = Role.ALL
        self.ma_mode: bool = False
        self.sync_mode: bool = False
        self.tables: List[Any] = []
        self._barrier_count = 0
        self._num_local_workers = 1
        self.ps_service: Optional[Any] = None
        self.ps_peers: List[Any] = []

    # -- singleton ---------------------------------------------------------
    @classmethod
    def get(cls) -> "Zoo":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Zoo()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls) -> None:
        with cls._lock:
            cls._instance = None

    # -- lifecycle (ref src/zoo.cpp:41-80) ---------------------------------
    def start(self, argv: Optional[List[str]] = None,
              device: Optional[torch.device] = None,
              num_local_workers: int = 1) -> List[str]:
        check(not self.started, "Zoo already started")
        remaining = configure.parse_cmd_flags(argv)
        if configure.get_flag("coordinator") or \
                configure.get_flag("machine_file"):
            raise NotImplementedError(
                "multi-process start-up (-coordinator / -machine_file) is "
                "not ported yet: ROADMAP A7")
        self.device = device_lib.resolve_device(
            configure.get_flag("platform"), device)
        self.role = Role.parse(configure.get_flag("ps_role"))
        self.ma_mode = configure.get_flag("ma")
        self.sync_mode = configure.get_flag("sync")
        self._num_local_workers = max(1, int(num_local_workers))
        self.started = True
        log.debug("Zoo started on %s: rank %d/%d, %d server shard, "
                  "sync=%s ma=%s", self.device, self.rank(), self.size(),
                  self.num_servers(), self.sync_mode, self.ma_mode)
        return remaining

    def stop(self, finalize_net: bool = True) -> None:
        del finalize_net
        if not self.started:
            return
        self.barrier()
        for table in self.tables:
            close = getattr(table, "close", None)
            if close:
                close()
        self.tables.clear()
        if self.ps_service is not None:
            self.ps_service.close()
            self.ps_service = None
        self.ps_peers = []
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.device = None
        self.started = False

    # -- identity (ref include/multiverso/zoo.h:38-50) ---------------------
    def rank(self) -> int:
        return 0

    def size(self) -> int:
        return 1

    def num_workers(self) -> int:
        """Total logical workers: processes x local worker threads."""
        return self.size() * self._num_local_workers

    def num_servers(self) -> int:
        return 1

    def worker_id(self) -> int:
        return (self.rank() * self._num_local_workers
                if Role.is_worker(self.role) else -1)

    def server_id(self) -> int:
        return self.rank() if Role.is_server(self.role) else -1

    @property
    def num_local_workers(self) -> int:
        return self._num_local_workers

    # -- barrier (ref src/zoo.cpp:164-176) ---------------------------------
    def barrier(self) -> None:
        """One process: a barrier orders nothing beyond program order."""
        check(self.started, "Zoo not started")
        self._barrier_count += 1

    # -- table registry (ref src/zoo.cpp:178-186) --------------------------
    def register_table(self, table: Any) -> int:
        table_id = len(self.tables)
        self.tables.append(table)
        return table_id
