"""Core table machinery: device-resident server store + worker handle.

Port of ``multiverso_tpu/core/table.py`` (ref
``include/multiverso/table_interface.h:24-75``, ``src/table.cpp``).

* ``ServerStore``: one table's storage and updater state as tensors on the
  Zoo's device (one server shard in this slice). Every Add runs the
  pluggable updater under the store lock; the JAX package's buffer
  donation becomes in-place updates (or a swap of the stored tensor)
  under that lock. Reads return fresh buffers, so a reader never sees a
  half-applied update.
* ``WorkerTable``: client handle — sync ``get``/``add`` wrap async ops
  that return message ids; ``wait`` resolves them. CUDA's stream order
  plays the role of the reference's per-request waiters.

``use_pallas`` selects the hand-written row kernels under the same
eligibility as the JAX package (2-D float32, one shard, unsharded state)
and the same per-updater capability registry: ``scatter_add`` /
``scatter_sub`` route row Adds to the sorted scatter-add kernel (B2);
``fused_stateful`` (momentum_sgd, adagrad, ftrl) routes them to the
duplicate combine and then the fused gather-update-scatter kernel (B3);
row Gets go to the gather kernel (B1). On the CPU each kernel's plain
version runs. Cross-replica state sharding (``-state_sharding=on``) waits
for several cards (ROADMAP A10).

bfloat16 tables (``dtype="bfloat16"``, or a numpy dtype named so) are
stored as ``torch.bfloat16``. numpy knows that type only through
``ml_dtypes``, which the port does not need, so on the host such a table
takes and returns float32: deltas are rounded to bfloat16 on the way in
(round to nearest even, as the JAX package's ``np.asarray(delta,
bfloat16)``), and reads widen exactly. The row kernels stay float32-only,
as in the JAX package: a ``use_pallas`` bfloat16 table takes the plain
route. Every updater runs on it with the JAX package's math: the default
and sgd updaters fold a row Add's duplicate rows in lane order with a
rounding after every add, as XLA's scatter does; the stateful updaters
combine duplicates the same way (XLA's bfloat16 ``segment_sum``), keep
each state leaf in the dtype the JAX ``init_state`` gives it, and round
their float32 math to bfloat16 where the JAX package does.

Negative row ids (ROADMAP C5): the default and sgd row Adds of a table
without the row kernels wrap ids in ``[-rows, 0)`` to the table's end, as
JAX's ``.at[].add(mode="drop")`` does (``ops/rows.add_rows_sorted``); the
row kernels' routes (``use_pallas``) and every stateful route drop
negative ids, as the JAX package's Pallas kernels do (its stateful XLA
route reads row 0 and writes the last row, ROADMAP C7: not copied); Gets
clamp ids into range, -1 to row 0, as ``mode="clip"`` does.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.core.options import AddOption, GetOption
from multiverso_tpu_torch.core.updater import (Updater,
                                               pallas_row_capability)
from multiverso_tpu_torch.ops import rows
from multiverso_tpu_torch.telemetry import gauge
from multiverso_tpu_torch.utils.configure import get_flag
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
}


def is_bfloat16(dtype: Any) -> bool:
    """True for ``"bfloat16"``, ``torch.bfloat16`` and a numpy dtype
    named ``bfloat16``, without making numpy build that dtype (it can
    only with ``ml_dtypes`` loaded)."""
    if isinstance(dtype, str):
        return dtype == "bfloat16"
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    try:
        return np.dtype(dtype).name == "bfloat16"
    except TypeError:
        return False


def host_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype a table of ``dtype`` takes and returns on the host:
    float32 for a bfloat16 table (an exact widening), else ``dtype``."""
    return np.dtype(np.float32) if is_bfloat16(dtype) else np.dtype(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (tables are declared in numpy), or
    of ``"bfloat16"``."""
    if is_bfloat16(dtype):
        return torch.bfloat16
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"table dtype {dtype} is not ported yet") from None


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 widens to float32
    (numpy has no bfloat16 without ``ml_dtypes``)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class ServerStore:
    """Device-resident storage for one table + its updater state."""

    def __init__(self, name: str, shape: Tuple[int, ...], dtype: Any,
                 updater: Updater, device: torch.device, num_workers: int,
                 shard_axis: int = 0, init_array: Optional[np.ndarray] = None,
                 use_pallas_rows: bool = False,
                 state_sharding: Optional[str] = None):
        self.name = name
        self.logical_shape = tuple(int(s) for s in shape)
        #: The host-side dtype (float32 for a bfloat16 table).
        self.dtype = host_dtype(dtype)
        self.torch_dtype = torch_dtype(dtype)
        self.updater = updater
        self.device = torch.device(device)
        self.shard_axis = shard_axis
        self.num_workers = num_workers
        self.num_servers = 1
        self.padded_shape = self.logical_shape

        if init_array is None:
            self.data = torch.zeros(self.logical_shape,
                                    dtype=self.torch_dtype,
                                    device=self.device)
        else:
            check(tuple(init_array.shape) == self.logical_shape,
                  f"init shape {init_array.shape} != {self.logical_shape}")
            self.data = torch.as_tensor(
                np.array(init_array, dtype=self.dtype),
                device=self.device).to(self.torch_dtype)

        mode = (state_sharding if state_sharding is not None
                else get_flag("state_sharding"))
        check(mode in ("auto", "on", "off"),
              f"state_sharding must be auto|on|off, got {mode!r}")
        self.state = updater.init_state(self.padded_shape, self.torch_dtype,
                                        num_workers, self.device)
        if mode == "on" and self.state:
            raise NotImplementedError(
                "-state_sharding=on (cross-replica updater-state sharding) "
                "needs several cards: ROADMAP A10")
        self.state_sharded = False

        # Opt-in hand-written row kernels (ops/rows.py), selected through
        # the per-updater capability registry, under the JAX package's
        # eligibility: 2-D float32 tables, one shard, unsharded state.
        self._pallas_cap = None
        if (use_pallas_rows and len(self.padded_shape) == 2
                and self.torch_dtype == torch.float32
                and self.num_servers == 1):
            cap = pallas_row_capability(updater)
            if cap in ("scatter_add", "scatter_sub") or (
                    cap == "fused_stateful" and not self.state_sharded):
                self._pallas_cap = cap
        self._pallas_rows = self._pallas_cap is not None
        self._lock = make_lock("core.store")
        self._g_data_bytes = gauge(f"ps.data_bytes.{name}")
        self._g_state_bytes = gauge(f"ps.state_bytes.{name}")
        self._publish_memory_gauges()

    def _tensor(self, x, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device).to(
            dtype or self.torch_dtype)

    def _clip(self, row_ids) -> torch.Tensor:
        ids = self._tensor(row_ids, torch.int64)
        return ids.clamp(0, self.logical_shape[self.shard_axis] - 1)

    # -- server ops (ref ServerTable::ProcessAdd/ProcessGet) ---------------
    def apply_dense(self, delta, opt: AddOption) -> None:
        delta = self._tensor(delta)
        with self._lock:
            self.data, self.state = self.updater.update_dense(
                self.data, self.state, delta, opt.scalars())

    def apply_rows(self, row_ids, delta, opt: AddOption) -> None:
        ids = self._tensor(row_ids, torch.int64)
        delta = self._tensor(delta)
        with self._lock:
            if self._pallas_cap in ("scatter_add", "scatter_sub"):
                # SGD applies data -= delta (the client pre-scales lr).
                sign = -1.0 if self._pallas_cap == "scatter_sub" else 1.0
                rows.scatter_add_rows(self.data, ids, delta, sign=sign)
            elif self._pallas_cap == "fused_stateful":
                # As the XLA path: duplicates folded (set semantics must
                # combine, not race), then one in-place update of the
                # table and every state leaf; here one stable sort and ONE
                # kernel over the sorted runs.
                rows.fused_stateful_sorted_rows(self.data, self.state, ids,
                                                delta, opt.scalars(),
                                                self.updater)
            else:
                self.data, self.state = self.updater.update_rows(
                    self.data, self.state, ids, delta, opt.scalars())

    def read(self) -> torch.Tensor:
        """The whole table (a fresh buffer)."""
        with self._lock:
            return self.data.clone()

    def read_rows(self, row_ids) -> torch.Tensor:
        """Rows by id, ids clipped into range (``mode="clip"``). A 2-D
        float32 table gathers with B1 (``ops/rows.gather_rows``, bitwise
        ``index_select``), whether or not it is ``use_pallas``; another
        dtype with ``index_select``. The gather is issued under the lock,
        on the stream the in-place Adds run on, so it reads one
        consistent table and no later Add can overtake it (the JAX
        package's donation guard); the lookup runners read through
        here."""
        ids = self._clip(row_ids)
        with self._lock:
            if (self.data.dim() == 2 and self.shard_axis == 0
                    and self.data.dtype == torch.float32):
                return rows.gather_rows(self.data, ids)
            return self.data.index_select(self.shard_axis, ids)

    def block(self) -> None:
        """Wait until all previously issued updates have executed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def write_dense(self, values) -> None:
        """Overwrite the whole table (the whole-replica publish) with a
        host array, or with a tensor (which the store then owns: the
        model-average merge hands its merged tables over on the card)."""
        if torch.is_tensor(values):
            check(tuple(values.shape) == self.logical_shape,
                  f"publish shape {tuple(values.shape)} != "
                  f"{self.logical_shape}")
            new = values.to(self.device, self.torch_dtype).contiguous()
            with self._lock:
                self.data = new
            return
        values = np.asarray(values, dtype=self.dtype)
        check(tuple(values.shape) == self.logical_shape,
              f"publish shape {values.shape} != {self.logical_shape}")
        new = torch.as_tensor(np.array(values), device=self.device).to(
            self.torch_dtype)
        with self._lock:
            self.data = new

    # -- memory accounting -------------------------------------------------
    def data_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.state.values())

    def _publish_memory_gauges(self) -> None:
        self._g_data_bytes.set(self.data_bytes())
        self._g_state_bytes.set(self.state_bytes())

    # -- checkpointing (ref table_interface.h:61-75) -----------------------
    def _leaf_axis(self, leaf_ndim: int) -> int:
        """A state leaf's shard axis: the table's, shifted by any leading
        worker axis (AdaGrad's [num_workers, ...] g2)."""
        return self.shard_axis + (leaf_ndim - len(self.padded_shape))

    def store_state(self) -> Dict[str, np.ndarray]:
        """The JAX package's payload format: ``data`` plus one
        ``state/<leaf>`` entry per updater-state leaf, logical extents (a
        bfloat16 table's ``data`` widened to float32)."""
        with self._lock:
            out = {"data": host_array(self.data).copy()}
            for key, leaf in self.state.items():
                out[f"state/{key}"] = host_array(leaf).copy()
        return out

    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        data = np.asarray(payload["data"])
        check(tuple(data.shape) == self.logical_shape,
              f"checkpoint data shape {tuple(data.shape)} incompatible "
              f"with table '{self.name}' {self.logical_shape}")
        new_data = torch.as_tensor(np.array(data, dtype=self.dtype),
                                   device=self.device).to(self.torch_dtype)
        logical = self.logical_shape[self.shard_axis]
        new_state = dict(self.state)
        for key, leaf in self.state.items():
            saved = payload.get(f"state/{key}")
            if saved is None:
                continue
            saved = np.asarray(saved)
            ax = self._leaf_axis(leaf.dim())
            # Accept logical-extent saves and legacy padded saves (extent
            # >= logical along the shard axis); every other dim must match.
            check(saved.ndim == leaf.dim()
                  and all(saved.shape[i] == leaf.shape[i]
                          for i in range(leaf.dim()) if i != ax)
                  and saved.shape[ax] >= logical,
                  f"checkpoint state leaf '{key}' shape "
                  f"{tuple(saved.shape)} incompatible with live leaf "
                  f"{tuple(leaf.shape)} of table '{self.name}' "
                  f"(logical shard-axis extent {logical})")
            sl = [slice(None)] * leaf.dim()
            sl[ax] = slice(0, logical)
            new_state[key] = torch.as_tensor(
                np.array(saved[tuple(sl)]), device=self.device).to(leaf.dtype)
        with self._lock:
            self.data = new_data
            self.state = new_state
        self._publish_memory_gauges()


class WorkerTable:
    """Client-side handle: sync wraps async, per-request waiters
    (ref ``src/table.cpp:27-111``)."""

    MAX_PENDING = 1 << 16

    def __init__(self, store: ServerStore):
        self.store = store
        self._msg_id = 0
        self._pending: "collections.OrderedDict[int, Callable[[], Any]]" = \
            collections.OrderedDict()
        self._lock = make_lock("core.worker_table")
        from multiverso_tpu_torch.core.zoo import Zoo
        zoo = Zoo.get()
        self.table_id = zoo.register_table(self)
        # BSP gating (SyncServer semantics) among this process's local
        # workers (ref src/server.cpp:68-222).
        self._sync = None
        if zoo.sync_mode and zoo.num_local_workers > 1:
            from multiverso_tpu_torch.core.sync_coordinator import \
                SyncCoordinator
            self._sync = SyncCoordinator(zoo.num_local_workers,
                                         name=getattr(self, "name", ""))
        self._staleness_adaptive = bool(get_flag("staleness_adaptive"))

    # -- BSP gates (no-ops in async mode / single-worker worlds) -----------
    def _local_wid(self, wid: int) -> int:
        return wid % self._sync.num_workers

    @contextlib.contextmanager
    def _bsp_add(self, option: Optional[AddOption]):
        """Gate + stamp: yields the AddOption the caller must apply with
        (carrying the measured clock lag under ``-staleness_adaptive``
        for staleness-aware updaters)."""
        opt = option or AddOption()
        if self._sync is None:
            yield opt
            return
        wid = self._local_wid(opt.worker_id)
        self._sync.acquire_add(wid)
        if (self._staleness_adaptive and opt.staleness < 0
                and getattr(self.store.updater, "staleness_aware", False)):
            opt = dataclasses.replace(opt,
                                      staleness=self._sync.lag(wid))
        try:
            yield opt
        except BaseException:
            self._sync.abort_add(wid)
            raise
        self._sync.commit_add(wid)

    @contextlib.contextmanager
    def _bsp_get(self, option: Optional[GetOption]):
        if self._sync is None:
            yield
            return
        wid = self._local_wid(option.worker_id if option else 0)
        self._sync.acquire_get(wid)
        yield
        self._sync.commit_get(wid)

    def finish_train(self, worker_id: int) -> None:
        """``Zoo::FinishTrain`` analog (ref src/zoo.cpp:152-161)."""
        if self._sync is not None:
            self._sync.finish_train(self._local_wid(worker_id))

    # -- waiter bookkeeping ------------------------------------------------
    def _register(self, resolve: Callable[[], Any]) -> int:
        with self._lock:
            self._msg_id += 1
            msg_id = self._msg_id
            self._pending[msg_id] = resolve
            while len(self._pending) > self.MAX_PENDING:
                self._pending.popitem(last=False)
        return msg_id

    def _register_add(self) -> int:
        with self._lock:
            self._msg_id += 1
            return self._msg_id

    def wait(self, msg_id: int) -> Any:
        with self._lock:
            resolve = self._pending.pop(msg_id, None)
        if resolve is None:
            check(0 < msg_id <= self._msg_id, f"unknown msg_id {msg_id}")
            return self.store.block()
        return resolve()

    @property
    def name(self) -> str:
        return self.store.name

    def close(self) -> None:
        with self._lock:
            self._pending.clear()

