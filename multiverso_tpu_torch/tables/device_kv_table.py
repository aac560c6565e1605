"""Device-resident KV table: key directory over a value slab on the card.

Port of ``multiverso_tpu/tables/device_kv_table.py``. The plain
:class:`KVTable` keeps values host-side — faithful to the reference's
metadata use (``kv_table.h``), but wrong for KV workloads whose values are
large vectors (lightLDA-scale topic rows). This table keeps the **values on
the device** (a ``[capacity, value_dim]`` slab in a :class:`ServerStore`,
served by the same updaters as the matrix tables). The **key -> slot
directory** has two backings, selected by
``KVTableOption.device_directory``:

* host dict (default) — fine when batches are small relative to value
  traffic;
* device hash (:mod:`multiverso_tpu_torch.ops.device_hash`) — an
  open-addressing directory on the slab's device; a batch resolves in a
  few rounds of vectorized probes instead of a host Python loop.

Both give a payload of the same format (``kv_keys`` int64, ``kv_slots``
int32 beside the store's ``data`` and ``state/<leaf>``), so a checkpoint
moves between backings and between this package and the JAX package.
Keys are int64 keys, never row ids: only the slots they resolve to reach
the store (so the store's negative-row-id rules never see a key).

Capacity is fixed at creation (slots are never reclaimed — matching the
reference's grow-only server maps); exceeding it is a fatal check.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch.core.options import AddOption, KVTableOption
from multiverso_tpu_torch.core.table import ServerStore, host_array
from multiverso_tpu_torch.core.updater import get_updater
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.ops import device_hash
from multiverso_tpu_torch.utils.log import check


class DeviceKVTable:
    def __init__(self, option: KVTableOption, value_dim: int = 1):
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() before creating tables")
        self.name = option.name or f"devkv_{len(zoo.tables)}"
        self.capacity = option.capacity
        self.value_dim = int(value_dim)
        updater = get_updater(option.value_dtype, option.updater)
        self.store = ServerStore(self.name,
                                 (self.capacity, self.value_dim),
                                 option.value_dtype, updater, zoo.device,
                                 zoo.num_workers())
        self._device_dir = bool(getattr(option, "device_directory", False))
        self._dir_state = (device_hash.make_state(self.capacity,
                                                  self.store.device)
                           if self._device_dir else None)
        self._slots: Dict[int, int] = {}
        self._next_slot = 0
        self._lock = threading.Lock()
        self.table_id = zoo.register_table(self)

    # -- directory ---------------------------------------------------------
    def _resolve(self, keys: np.ndarray, allocate: bool):
        """keys -> slot ids; unknown keys get -1 (get) or a fresh slot
        (add). The device directory returns a tensor on the slab's device,
        the host dict a numpy array."""
        if self._device_dir:
            return self._resolve_device(keys, allocate)
        out = np.empty(len(keys), dtype=np.int32)
        with self._lock:
            for i, k in enumerate(keys.tolist()):
                slot = self._slots.get(k)
                if slot is None:
                    if not allocate:
                        out[i] = -1
                        continue
                    check(self._next_slot < self.capacity,
                          f"DeviceKVTable '{self.name}' capacity "
                          f"{self.capacity} exhausted")
                    slot = self._next_slot
                    self._next_slot += 1
                    self._slots[k] = slot
                out[i] = slot
        return out

    def _resolve_device(self, keys: np.ndarray, allocate: bool
                        ) -> torch.Tensor:
        n = len(keys)
        if n == 0:
            return torch.empty(0, dtype=torch.int32,
                               device=self.store.device)
        # Pad to the next power of two, as the JAX package does (its jit
        # specializes on a handful of batch lengths); the padded batch is
        # what decides the claim order, so the port pads the same way.
        # Padding repeats the first key: a duplicate converges to the same
        # slot, so an insert allocates nothing extra.
        padded = 1
        while padded < n:
            padded *= 2
        keys = np.concatenate(
            [np.asarray(keys, dtype=np.int64),
             np.full(padded - n, keys[0], dtype=np.int64)])
        hi, lo = device_hash.split_keys(keys)
        with self._lock:
            if allocate:
                state, slots, overflow = device_hash.insert(
                    self._dir_state, hi, lo)
                check(not overflow,
                      f"DeviceKVTable '{self.name}' capacity "
                      f"{self.capacity} exhausted")
                self._dir_state = state
            else:
                slots = device_hash.lookup(self._dir_state, hi, lo)
        return slots[:n]

    def __len__(self) -> int:
        with self._lock:
            if self._device_dir:
                return int(self._dir_state.next_slot)
            return len(self._slots)

    # -- ops ---------------------------------------------------------------
    def add(self, keys, values,
            option: Optional[AddOption] = None) -> None:
        """Server-side updater per key (``+=`` with the default updater)."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        values = np.asarray(values, dtype=self.store.dtype)
        if values.ndim == 1:
            values = values[:, None]
        check(values.shape == (len(keys), self.value_dim),
              f"values shape {values.shape} != "
              f"{(len(keys), self.value_dim)}")
        slots = self._resolve(keys, allocate=True)
        self.store.apply_rows(slots, values, option or AddOption())

    def get(self, keys) -> np.ndarray:
        """Missing keys read as zero (reference map semantics)."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        slots = self.store._tensor(self._resolve(keys, allocate=False),
                                   torch.int64)
        rows = self.store.read_rows(slots.clamp(min=0))
        rows[slots < 0] = 0
        rows = host_array(rows)
        return rows[:, 0] if self.value_dim == 1 else rows

    # -- checkpointing -----------------------------------------------------
    def store_state(self) -> Dict[str, np.ndarray]:
        with self._lock:
            if self._device_dir:
                # The (key, slot) pairs in bucket order, so the payload
                # format matches the host-dict variant (a checkpoint is
                # portable across directory backings).
                s = self._dir_state
                occ = s.slot >= 0
                keys = device_hash.join_keys(s.k_hi[occ].cpu().numpy(),
                                             s.k_lo[occ].cpu().numpy())
                slots = s.slot[occ].cpu().numpy()
            else:
                keys = np.asarray(list(self._slots.keys()), dtype=np.int64)
                slots = np.asarray(list(self._slots.values()),
                                   dtype=np.int32)
        payload = self.store.store_state()
        payload["kv_keys"] = keys
        payload["kv_slots"] = slots
        return payload

    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        self.store.load_state(payload)
        keys = payload["kv_keys"]
        slots = payload["kv_slots"]
        with self._lock:
            if self._device_dir:
                self._dir_state = device_hash.make_state(self.capacity,
                                                         self.store.device)
                if len(keys):
                    hi, lo = device_hash.split_keys(np.asarray(keys))
                    state, overflow = device_hash.insert_preassigned(
                        self._dir_state, hi, lo,
                        np.asarray(slots, dtype=np.int32))
                    check(not overflow,
                          f"DeviceKVTable '{self.name}': checkpoint exceeds "
                          f"capacity {self.capacity}")
                    self._dir_state = state
            else:
                self._slots = dict(zip(keys.tolist(), slots.tolist()))
                self._next_slot = (int(slots.max()) + 1
                                   if len(slots) else 0)

    def close(self) -> None:
        with self._lock:
            self._slots.clear()
            if self._device_dir:
                self._dir_state = device_hash.make_state(self.capacity,
                                                         self.store.device)
