"""1-D dense ArrayTable (port of ``multiverso_tpu/tables/array_table.py``).

Reference: ``include/multiverso/table/array_table.h``,
``src/table/array_table.cpp`` — the worker always requests the whole table;
``Partition`` slices the value blob by per-server offsets
(``array_table.cpp:69-86``); the server applies the updater on Add and
returns its slice on Get.

Storage is a 1-D tensor on the Zoo's device (one server shard in this
slice); Add is one updater call over it. ``partition`` reproduces the
reference's offset arithmetic.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch.core.options import (AddOption, ArrayTableOption,
                                               GetOption)
from multiverso_tpu_torch.core.table import (ServerStore, WorkerTable,
                                             host_array)
from multiverso_tpu_torch.core.updater import get_updater
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.parallel.device import (check_comm_policy,
                                                  reference_server_offsets)
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.utils.log import check


class ArrayTable(WorkerTable):
    def __init__(self, option: ArrayTableOption):
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() before creating tables")
        updater = get_updater(option.dtype, option.updater)
        name = option.name or f"array_{len(zoo.tables)}"
        comm_policy = check_comm_policy(option.comm_policy, name)
        store = ServerStore(name, (option.size,), option.dtype, updater,
                            zoo.device, zoo.num_workers())
        super().__init__(store)
        self.size = option.size
        self.server_offsets = reference_server_offsets(option.size,
                                                       store.num_servers)
        self.comm_policy = comm_policy

    # -- get (ref array_table.cpp:29-46) -----------------------------------
    def get_async(self, option: Optional[GetOption] = None) -> int:
        with self._bsp_get(option):
            arr = self.store.read()
        return self._register(lambda: host_array(arr))

    def get(self, option: Optional[GetOption] = None) -> np.ndarray:
        with monitor("WORKER_TABLE_SYNC_GET"):
            return self.wait(self.get_async(option))

    def raw(self) -> torch.Tensor:
        """Device-resident view (a fresh buffer)."""
        return self.store.read()

    # -- add (ref array_table.cpp:48-66) -----------------------------------
    def add_async(self, delta, option: Optional[AddOption] = None) -> int:
        delta = np.asarray(delta, dtype=self.store.dtype)
        check(delta.shape == (self.size,),
              f"delta shape {delta.shape} != ({self.size},)")
        with self._bsp_add(option) as opt:
            self.store.apply_dense(delta, opt)
        return self._register_add()

    def add(self, delta, option: Optional[AddOption] = None) -> None:
        with monitor("WORKER_TABLE_SYNC_ADD"):
            self.wait(self.add_async(delta, option))

    def publish(self, values) -> None:
        """Whole-replica publish: overwrite the stored params."""
        self.store.write_dense(
            np.asarray(values, dtype=self.store.dtype).reshape(-1))

    # -- parity helper (ref array_table.cpp:69-86) -------------------------
    def partition(self, values: np.ndarray) -> Dict[int, np.ndarray]:
        """Slice a whole-table value buffer into per-server pieces using the
        reference's contiguous offsets."""
        values = np.asarray(values)
        out: Dict[int, np.ndarray] = {}
        offsets = self.server_offsets
        for sid in range(self.store.num_servers):
            lo, hi = offsets[sid], offsets[sid + 1]
            if hi > lo:
                out[sid] = values[lo:hi]
        return out
