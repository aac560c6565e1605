"""2-D dense MatrixTable (port of ``multiverso_tpu/tables/matrix_table.py``).

Reference: ``include/multiverso/table/matrix_table.h``,
``src/table/matrix_table.cpp`` — row-granular API (whole table, single
row, row-id vector), worker-side row routing (``matrix_table.cpp:235-313``),
server-side per-row updates and optional uniform random init
(``matrix_table.cpp:372-384``, numpy-seeded exactly as in the JAX package
so both start from the same values).

Storage is a [rows, cols] tensor on the Zoo's device. Row Get is a gather
(the B1 kernel on a ``use_pallas`` table); row Add is one updater call (on
a ``use_pallas`` table, the B2 kernel for the default/sgd updaters and the
fused B3 kernel for momentum_sgd/adagrad/ftrl).

A bfloat16 table (``dtype="bfloat16"``) returns float32 from ``get`` and
``get_rows`` (an exact widening: numpy has no bfloat16 without
``ml_dtypes``, so ``t.cpu().numpy()`` would raise) and takes float32
deltas, rounded to bfloat16 on the way in.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multiverso_tpu_torch.core.options import (AddOption, GetOption,
                                               MatrixTableOption)
from multiverso_tpu_torch.core.table import (ServerStore, WorkerTable,
                                             host_array, host_dtype)
from multiverso_tpu_torch.core.updater import get_updater
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.parallel.device import check_comm_policy
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.utils.log import check


class MatrixTable(WorkerTable):
    def __init__(self, option: MatrixTableOption):
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() before creating tables")
        updater = get_updater(option.dtype, option.updater)
        name = option.name or f"matrix_{len(zoo.tables)}"
        comm_policy = check_comm_policy(option.comm_policy, name)
        init = None
        if option.random_init:
            rng = np.random.default_rng(option.seed)
            init = rng.uniform(option.init_low, option.init_high,
                               size=(option.num_row, option.num_col)
                               ).astype(host_dtype(option.dtype))
        store = ServerStore(name, (option.num_row, option.num_col),
                            option.dtype, updater, zoo.device,
                            zoo.num_workers(), shard_axis=0, init_array=init,
                            use_pallas_rows=option.use_pallas)
        super().__init__(store)
        self.num_row = option.num_row
        self.num_col = option.num_col
        self.num_servers = store.num_servers
        self.num_row_each = max(1, self.num_row // self.num_servers)
        self.comm_policy = comm_policy

    # -- whole-table ops (sentinel key -1 in the reference) ----------------
    def get_async(self, option: Optional[GetOption] = None) -> int:
        with self._bsp_get(option):
            arr = self.store.read()
        return self._register(lambda: host_array(arr))

    def get(self, option: Optional[GetOption] = None) -> np.ndarray:
        with monitor("WORKER_TABLE_SYNC_GET"):
            return self.wait(self.get_async(option))

    def raw(self) -> torch.Tensor:
        return self.store.read()

    def add_async(self, delta, option: Optional[AddOption] = None) -> int:
        delta = np.asarray(delta, dtype=self.store.dtype)
        check(delta.shape == (self.num_row, self.num_col),
              f"delta shape {delta.shape} != {(self.num_row, self.num_col)}")
        with self._bsp_add(option) as opt:
            self.store.apply_dense(delta, opt)
        return self._register_add()

    def add(self, delta, option: Optional[AddOption] = None) -> None:
        with monitor("WORKER_TABLE_SYNC_ADD"):
            self.wait(self.add_async(delta, option))

    # -- row ops (ref matrix_table.h:25-75) --------------------------------
    def get_rows_async(self, row_ids,
                       option: Optional[GetOption] = None) -> int:
        row_ids = np.asarray(row_ids, dtype=np.int32)
        with self._bsp_get(option):
            arr = self.store.read_rows(row_ids)
        return self._register(lambda: host_array(arr))

    def get_rows(self, row_ids, option: Optional[GetOption] = None
                 ) -> np.ndarray:
        with monitor("WORKER_TABLE_SYNC_GET"):
            return self.wait(self.get_rows_async(row_ids, option))

    def get_row(self, row_id: int) -> np.ndarray:
        return self.get_rows([row_id])[0]

    def add_rows_async(self, row_ids, deltas,
                       option: Optional[AddOption] = None) -> int:
        row_ids = np.asarray(row_ids, dtype=np.int32)
        deltas = np.asarray(deltas, dtype=self.store.dtype)
        check(deltas.shape == (len(row_ids), self.num_col),
              f"row delta shape {deltas.shape} != "
              f"{(len(row_ids), self.num_col)}")
        with self._bsp_add(option) as opt:
            self.store.apply_rows(row_ids, deltas, opt)
        return self._register_add()

    def add_rows(self, row_ids, deltas,
                 option: Optional[AddOption] = None) -> None:
        with monitor("WORKER_TABLE_SYNC_ADD"):
            self.wait(self.add_rows_async(row_ids, deltas, option))

    def add_row(self, row_id: int, delta,
                option: Optional[AddOption] = None) -> None:
        self.add_rows([row_id], np.asarray(delta)[None, :], option)

    def publish(self, values) -> None:
        """Whole-replica publish: overwrite the stored params."""
        self.store.write_dense(np.asarray(values, dtype=self.store.dtype))

    def serving_runner(self, cache=None):
        raise NotImplementedError(
            "MatrixTable.serving_runner (the serving plane) is not ported "
            "yet: ROADMAP A9")

    # -- parity helper (ref matrix_table.cpp:235-313) ----------------------
    def partition(self, row_ids: Sequence[int]) -> Dict[int, np.ndarray]:
        """Route each row id to its server: ``min(r // num_row_each, n-1)``."""
        out: Dict[int, list] = {}
        for r in row_ids:
            sid = min(int(r) // self.num_row_each, self.num_servers - 1)
            out.setdefault(sid, []).append(int(r))
        return {sid: np.asarray(rows, dtype=np.int32)
                for sid, rows in out.items()}
