"""Zoo — the runtime singleton: lifecycle, roles, registry, barrier.

Port of ``multiverso_tpu/core/zoo.py`` (ref ``include/multiverso/zoo.h``,
``src/zoo.cpp``): startup/shutdown ordering, node roles, table
registration, rank/size/worker/server queries and the global barrier.

Each rank runs on one device
(:func:`multiverso_tpu_torch.parallel.device.resolve_device`: the card
unless ``-platform=cpu``) and holds its tables whole: one server shard a
rank. Two planes join ranks:

* the collective plane — ``-coordinator=host:port -world_size=N
  -rank=r`` (or ``-machine_file``, which derives the three) starts a
  ``torch.distributed`` process group over gloo, the RegisterNode /
  Controller handshake of the reference (``src/controller.cpp:38-80``);
  ``rank()``, ``size()`` and ``barrier()`` come from it, and
  :attr:`Zoo.mesh` lays its ranks out on the ``-mesh_shape`` axes
  (``parallel/mesh.py``). Without a coordinator the world is this one
  process and no process group exists;
* the host PS service (``parallel/ps_service.py``): ``mv.net_bind``
  keeps this process's service in :attr:`Zoo.ps_service` and
  ``mv.net_connect`` the peer list in :attr:`Zoo.ps_peers`.
"""

from __future__ import annotations

import ipaddress
import os
import socket
from datetime import timedelta
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from multiverso_tpu_torch.parallel import device as device_lib
from multiverso_tpu_torch.parallel import mesh as mesh_lib
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
        self.mesh: Optional[mesh_lib.RankMesh] = None
        self._group_started = False
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
        self.device = device_lib.resolve_device(
            configure.get_flag("platform"), device)
        self.role = Role.parse(configure.get_flag("ps_role"))
        self.ma_mode = configure.get_flag("ma")
        self.sync_mode = configure.get_flag("sync")
        self._num_local_workers = max(1, int(num_local_workers))
        # Machine-file mode (the reference's ZMQ deployment,
        # zmq_net.h:25-61): rank and world from this host's position in
        # the file. The file's ports are the PS service ports, so the
        # process group's coordinator binds one port above rank 0's.
        machine_file = configure.get_flag("machine_file")
        if machine_file and not configure.get_flag("coordinator"):
            from multiverso_tpu_torch.utils.net_util import \
                rank_from_machine_file

            my_rank, world, peers = rank_from_machine_file(machine_file)
            configure.set_flag("rank", my_rank)
            configure.set_flag("world_size", world)
            configure.set_flag("coordinator",
                               f"{peers[0][0]}:{peers[0][1] + 1}")
        coordinator = configure.get_flag("coordinator")
        if coordinator:
            _start_process_group(coordinator,
                                 int(configure.get_flag("world_size")),
                                 int(configure.get_flag("rank")))
            self._group_started = True
        self.mesh = mesh_lib.build_mesh()
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
        if self._group_started:
            dist.destroy_process_group()
            self._group_started = False
        self.mesh = None
        self.device = None
        self.started = False

    # -- identity (ref include/multiverso/zoo.h:38-50) ---------------------
    def rank(self) -> int:
        if self._group_started:
            return dist.get_rank()
        return 0

    def size(self) -> int:
        if self._group_started:
            return dist.get_world_size()
        return 1

    def num_workers(self) -> int:
        """Total logical workers: processes x local worker threads."""
        return self.size() * self._num_local_workers

    def num_servers(self) -> int:
        """Tables stay whole on each rank's device: one server shard
        (sharding a table over cards is ROADMAP A10)."""
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
        """Every rank of the process group waits for the others; in a
        one-process world a barrier orders nothing beyond program
        order."""
        check(self.started, "Zoo not started")
        self._barrier_count += 1
        if self._group_started and self.size() > 1:
            dist.barrier()

    # -- table registry (ref src/zoo.cpp:178-186) --------------------------
    def register_table(self, table: Any) -> int:
        table_id = len(self.tables)
        self.tables.append(table)
        return table_id


# A collective that waits longer than this for a peer fails instead of
# hanging the rank.
PROCESS_GROUP_TIMEOUT_S = 300


def _is_loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _start_process_group(coordinator: str, world: int, rank: int) -> None:
    """``init_process_group`` over gloo at ``tcp://coordinator``.

    gloo picks the network device its ranks talk over by resolving this
    host's name; where the name resolves to no address, or to one the
    ranks cannot reach, the group fails or hangs. A world whose
    coordinator is a loopback address lives on one host, so its ranks
    talk over the loopback device unless ``GLOO_SOCKET_IFNAME`` names
    another."""
    host, _, port = coordinator.rpartition(":")
    check(bool(host) and port.isdigit(),
          f"-coordinator must be host:port; got {coordinator!r}")
    check(world >= 1 and 0 <= rank < world,
          f"-rank={rank} is outside a world of -world_size={world}")
    if _is_loopback(host) and "GLOO_SOCKET_IFNAME" not in os.environ:
        loopback = [name for _, name in socket.if_nameindex()
                    if name == "lo"]
        if loopback:
            os.environ["GLOO_SOCKET_IFNAME"] = loopback[0]
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
