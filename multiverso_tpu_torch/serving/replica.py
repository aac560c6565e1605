"""Checkpoint-to-serving handoff: frozen read-only replicas.

Port of ``multiverso_tpu/serving/replica.py``. Training owns the live
tables and their add path; a serving fleet wants parameters that never
move under a request. The bridge is the checkpoint stream that training
already emits (``core/checkpoint.py``): a :class:`CheckpointReplica` loads
the latest COMPLETE ``ckpt_*`` checkpoint (``meta.json`` is its
durability marker), reassembles rank-sharded tables by their
``shard_meta`` offsets, converts each table ONCE into its storage form on
the device (``-serve_table_dtype``: f32, bf16 or int8 with per-row scales,
``serving/quant.py::encode_table``), and hot-swaps to a newer checkpoint
by loading into staging and rebinding ONE reference: concurrent readers
captured the old snapshot object and finish against it, so a swap never
blocks a get and a get never observes a half-loaded table.

The npz file format is the JAX package's, so a replica of either package
serves a checkpoint that either package wrote. Tables live on the card
unless the caller (or ``-platform=cpu``) asks for the CPU.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.core.checkpoint import (checkpoint_manifests,
                                                  latest_checkpoint,
                                                  read_table_payload)
from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.serving.quant import (decode_rows, encode_table,
                                                storage_dtype)
from multiverso_tpu_torch.telemetry import counter, gauge
from multiverso_tpu_torch.utils.configure import flag_or
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check, log


class ReplicaSnapshot:
    """One immutable checkpoint's worth of tables. ``tables`` maps table
    name -> ``(payload, scale)`` storage pairs on the device, in the
    replica's storage dtype (shards already reassembled, converted once
    at swap time so per-batch gathers never pay a host-to-device copy or
    re-quantization). ``scale`` is None except for int8 (per-row absmax,
    ``serving/quant.py``)."""

    __slots__ = ("step", "root", "dtype", "_tables", "_dequant",
                 "_dequant_lock")

    def __init__(self, step: int, root: str,
                 tables: Dict[str, Tuple], dtype: str = "f32"):
        self.step = step
        self.root = root
        self.dtype = dtype
        self._tables = tables
        self._dequant: Dict[str, torch.Tensor] = {}
        self._dequant_lock = make_lock("serve.replica.dequant")

    def storage(self, name: str) -> Tuple:
        """``(payload, scale-or-None)`` in storage form — what the
        lookup runner's gather reads."""
        check(name in self._tables,
              f"checkpoint has no table '{name}' "
              f"(has: {sorted(self._tables)})")
        return self._tables[name]

    def table(self, name: str) -> torch.Tensor:
        """The table at f32 on the device: for f32 storage the resident
        tensor itself (bit for bit the checkpoint); quantized storage is
        decoded (``decode_rows``) once and cached (a convenience for
        scorers and tests: the lookup runner reads :meth:`storage`)."""
        data, scale = self.storage(name)
        if scale is None and data.dtype == torch.float32:
            return data
        with self._dequant_lock:
            cached = self._dequant.get(name)
            if cached is None:
                cached = decode_rows(data, scale, self.dtype)
                self._dequant[name] = cached
            return cached

    @property
    def names(self) -> List[str]:
        return sorted(self._tables)


def _assemble(shards: List[Tuple[int, np.ndarray]]) -> np.ndarray:
    """Concatenate rank shards by their row offsets. Offsets must tile the
    table contiguously (the reference's offset arithmetic guarantees it);
    a gap means a rank's checkpoint is missing — fail loudly."""
    shards = sorted(shards, key=lambda s: s[0])
    expect = 0
    parts = []
    for offset, data in shards:
        check(offset == expect,
              f"shard offset {offset} != expected {expect} — a rank's "
              "shard file is missing from the checkpoint")
        parts.append(data)
        expect = offset + data.shape[0]
    return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def load_checkpoint_tables(root: str) -> Dict[str, np.ndarray]:
    """Read every table of one ``ckpt_*`` directory into host arrays,
    merging rank shards via their ``shard_meta`` blobs. Tables WITHOUT
    shard metadata are per-process replicas (every rank's manifest lists
    its own full copy): the first rank's copy is taken verbatim."""
    manifests = checkpoint_manifests(root)
    check(bool(manifests), f"no manifest in {root}")
    shards: Dict[str, List[Tuple[int, np.ndarray]]] = {}
    replicas: Dict[str, np.ndarray] = {}
    for meta in manifests:
        files = meta.get("files", {})
        for name in meta["tables"]:
            payload = read_table_payload(
                os.path.join(root, files.get(name, f"{name}.npz")))
            meta_arr = payload.get("shard_meta")
            if meta_arr is None:
                replicas.setdefault(name, np.asarray(payload["data"]))
                continue
            shards.setdefault(name, []).append(
                (int(meta_arr[3]), np.asarray(payload["data"])))
    out = {name: _assemble(parts) for name, parts in shards.items()}
    for name, data in replicas.items():
        out.setdefault(name, data)      # a sharded save wins over a replica
    return out


class CheckpointReplica:
    """Latest-checkpoint follower with atomic hot-swap.

    ``refresh()`` is cheap when nothing changed (one directory listing);
    when a newer complete checkpoint appears it loads into staging and
    swaps. ``start_auto_refresh`` runs refresh on a daemon poll loop so a
    serving process follows training without any coordination channel
    beyond the checkpoint directory. ``table_dtype`` defaults to
    ``-serve_table_dtype``; ``device`` to the ``-platform`` flag's (the
    card unless ``cpu``)."""

    def __init__(self, directory: str, load: bool = True,
                 table_dtype: Optional[str] = None,
                 device: Optional[torch.device] = None):
        if table_dtype is None:
            table_dtype = str(flag_or("serve_table_dtype", "f32"))
        self.table_dtype = storage_dtype(table_dtype)
        self.device = resolve_device(str(flag_or("platform", "")), device)
        self.directory = directory
        self._snap: Optional[ReplicaSnapshot] = None
        self._refresh_lock = make_lock("serve.replica.refresh")
        self._poll: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._g_step = gauge("serve.replica_step")
        self._c_swaps = counter("serve.replica_swaps")
        if load:
            check(self.refresh(),
                  f"no complete checkpoint under {directory}")

    def refresh(self) -> bool:
        """Load the newest complete checkpoint if it is newer than the
        current snapshot; returns True when a swap happened."""
        with self._refresh_lock:
            root = latest_checkpoint(self.directory)
            if root is None:
                return False
            step = int(os.path.basename(root).split("_")[1])
            cur = self._snap
            if cur is not None and step <= cur.step:
                return False
            tables = load_checkpoint_tables(root)
            # Device-convert ONCE per swap, in the storage dtype: the
            # runners' gathers then never pay a host-to-device copy.
            tables = {name: encode_table(data, self.table_dtype,
                                         self.device)
                      for name, data in tables.items()}
            # Single reference rebind = the swap. Readers that already
            # hold the old snapshot keep serving it; new batches see the
            # new one. Nothing blocks, nothing tears.
            self._snap = ReplicaSnapshot(step, root, tables,
                                         self.table_dtype)
            self._g_step.set(step)
            self._c_swaps.inc()
            log.info("serving replica: swapped to step %d (%s)", step, root)
            return True

    def snapshot(self) -> ReplicaSnapshot:
        snap = self._snap
        check(snap is not None, "replica has no loaded checkpoint")
        return snap

    @property
    def step(self) -> int:
        return self.snapshot().step

    # -- follower loop ------------------------------------------------------
    def start_auto_refresh(self, interval_s: float = 5.0) -> None:
        if self._poll is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.refresh()
                except Exception as e:  # noqa: BLE001 - a torn/partial
                    # checkpoint mid-write must not kill the follower.
                    log.warning("replica refresh failed (will retry): %s",
                                e)

        self._poll = threading.Thread(target=loop, name="replica-refresh",
                                      daemon=True)
        self._poll.start()

    def close(self) -> None:
        self._stop.set()
        if self._poll is not None:
            self._poll.join(timeout=10)
            self._poll = None
