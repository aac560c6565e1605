"""The async checkpoint backend: tables staged to host, written in
background threads.

Port of ``multiverso_tpu/core/checkpoint_orbax.py``. orbax is a JAX
library, so the port writes **its own format** under the JAX package's
layout and commit protocol:

* one ``orbax_<step:012d>`` root per checkpoint, written into a
  ``<root>.tmp-<pid>`` staging directory;
* one directory per table with a store, holding one ``.npy`` file per
  leaf (``data``, ``state_<leaf>``) and ``leaves.json``, which names the
  format (:data:`FORMAT`) and each leaf's dtype; a bfloat16 leaf is
  stored as its 16-bit pattern (``uint16``) and tagged ``bfloat16``, as
  the npz backend stores it;
* host-only tables (the host KV table) as ``<name>.npz`` of their own
  payload;
* the ``manifest.json`` durability marker, written and fsynced inside the
  staging directory once every writer has finished, then one atomic
  rename of the staging directory to the root. A crash at any earlier
  point leaves any previous checkpoint of the step untouched, and a
  directory with a manifest is complete by construction.

The manifest names :data:`FORMAT` too. A tree that the JAX package's orbax
backend wrote (an orbax/tensorstore tree) has neither mark, and
:func:`load_all` refuses it with an error that names its format rather
than misread it.

**Snapshot consistency.** The JAX backend relies on table updates
replacing ``store.data``. In the port, the row kernels and the stateful
routes update ``store.data`` in place. So :func:`save_all_async` takes
each store's lock, enqueues every leaf's device-to-host copy into a host
buffer (pinned on a card) on the current stream, which is the stream the
table's Adds run on, and records a CUDA event; an Add issued after it
returns runs after those copies in stream order and cannot leak into the
snapshot. Each table's writer thread waits on its event, then writes. On
the CPU the copies are made under the lock before the call returns. The
host buffers belong to a :class:`HostStaging`, which a
:class:`~multiverso_tpu_torch.core.checkpoint.CheckpointManager` keeps
across its saves (it joins the previous save before it starts the next,
so no writer still reads a buffer it reuses).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.utils.log import check, log

#: The port's async checkpoint format, named in every manifest and in
#: every table directory's ``leaves.json``.
FORMAT = "multiverso_tpu_torch.npy_tree/v1"
_LEAVES = "leaves.json"


class CheckpointFormatError(ValueError):
    """A checkpoint tree this backend did not write (for example one that
    the JAX package's orbax backend wrote)."""


def _table_name(table: Any, i: int) -> str:
    return getattr(table, "name", f"table_{i}")


def _leaves(store) -> List[Tuple[str, torch.Tensor]]:
    """``(file stem, tensor)`` of every leaf of a store, the JAX
    backend's pytree keys: ``data`` and ``state_<leaf>``."""
    out = [("data", store.data)]
    out += [(f"state_{k}", v) for k, v in store.state.items()]
    return out


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class HostStaging:
    """Reusable host buffers for the leaves of each table (pinned when
    the leaf lives on a card), keyed by table and leaf; a buffer is
    reallocated only when its leaf's shape or dtype changed."""

    def __init__(self) -> None:
        self._bufs: Dict[Tuple[str, str], torch.Tensor] = {}

    def buffer(self, table: str, leaf: str, like: torch.Tensor
               ) -> torch.Tensor:
        buf = self._bufs.get((table, leaf))
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=like.is_cuda)
            self._bufs[(table, leaf)] = buf
        return buf

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self._bufs.values())


def _stage(store, name: str, staging: HostStaging):
    """Enqueue the copies of every leaf of ``store`` under its lock;
    returns ``(leaves, event)``: the host buffers by file stem and the
    event to wait on before reading them (None on the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    event = None
    with store._lock:
        for stem, leaf in _leaves(store):
            buf = staging.buffer(name, stem, leaf)
            buf.copy_(leaf, non_blocking=leaf.is_cuda)
            out[stem] = buf
        if store.data.is_cuda:
            event = torch.cuda.Event()
            event.record()
    return out, event


def _host_leaf(buf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A staged leaf as the numpy array written and its dtype tag."""
    if buf.dtype == torch.bfloat16:
        return buf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = buf.numpy()
    return arr, arr.dtype.name


def _write_table(path: str, leaves: Dict[str, torch.Tensor],
                 event) -> None:
    """One table's writer thread: wait for its copies, then one ``.npy``
    per leaf and ``leaves.json`` (all fsynced)."""
    if event is not None:
        event.synchronize()
    os.makedirs(path, exist_ok=True)
    tags = {}
    for stem, buf in leaves.items():
        arr, tags[stem] = _host_leaf(buf)
        _fsync_write(os.path.join(path, f"{stem}.npy"),
                     lambda f, a=arr: np.save(f, a, allow_pickle=False))
    _fsync_write(os.path.join(path, _LEAVES),
                 lambda f: f.write(json.dumps(
                     {"format": FORMAT, "leaves": tags}).encode()))


class _Writer(threading.Thread):
    """One table's background write; keeps its error for the join."""

    def __init__(self, path: str, leaves, event):
        super().__init__(name=f"ckpt-write-{os.path.basename(path)}",
                         daemon=True)
        self._args = (path, leaves, event)
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            _write_table(*self._args)
        except BaseException as e:  # noqa: BLE001 - re-raised at the join
            self.error = e


class AsyncSaveHandle:
    """In-flight checkpoint: the tables are staged when
    :func:`save_all_async` returns (so training may keep updating them),
    the writes finish in background threads until
    :meth:`wait_until_finished`, which commits the staging directory:
    ``manifest.json`` into it (fsynced), then one atomic rename to the
    root."""

    def __init__(self, root: str, staging: str, writers: list,
                 table_names=None, t0: Optional[float] = None) -> None:
        self.root = root
        self._staging = staging
        self._writers = writers
        self._tables = list(table_names or [])
        self._t0 = time.perf_counter() if t0 is None else t0
        #: Seconds from the call of ``save_all_async`` to its return, and
        #: to the end of the commit (set by the first join).
        self.staged_s = time.perf_counter() - self._t0
        self.total_s: Optional[float] = None

    def wait_until_finished(self) -> str:
        writers, self._writers = self._writers, []
        first_error = None
        for w in writers:       # join EVERY writer even if one failed
            w.join()
            first_error = first_error or w.error
        if first_error is not None:
            # A failed save never commits: a second join finds no tables
            # to manifest, and the partial staging directory goes.
            self._tables = []
            shutil.rmtree(self._staging, ignore_errors=True)
            raise first_error
        if self._tables:
            tmp = os.path.join(self._staging, "manifest.json.tmp")
            _fsync_write(tmp, lambda f: f.write(json.dumps(
                {"tables": self._tables, "time": time.time(),
                 "format": FORMAT}).encode()))
            os.replace(tmp, os.path.join(self._staging, "manifest.json"))
            # The staging dir is now a complete, manifested checkpoint
            # (restore accepts manifested ``.tmp-`` dirs for the crash
            # windows below), so an old same-step copy may go first.
            if os.path.isdir(self.root):
                shutil.rmtree(self.root, ignore_errors=True)
            os.replace(self._staging, self.root)
            self._tables = []
            self.total_s = time.perf_counter() - self._t0
        return self.root


def save_all_async(directory: str, step: int = 0,
                   staging: Optional[HostStaging] = None) -> AsyncSaveHandle:
    """Start checkpointing every registered table into
    ``directory/orbax_<step>``; returns once every table's copies are
    enqueued (see the module's note on snapshot consistency). Call
    ``wait_until_finished()`` before relying on the files. ``staging``
    holds the host buffers (a fresh set when None); the caller must not
    pass it to another save until this one has been joined."""
    zoo = Zoo.get()
    check(zoo.started, "runtime not started")
    t0 = time.perf_counter()
    staging = staging if staging is not None else HostStaging()
    root = os.path.join(os.path.abspath(directory), f"orbax_{step:012d}")
    tmp_dir = f"{root}.tmp-{os.getpid()}"
    if os.path.isdir(tmp_dir):       # a dead earlier attempt of this pid
        shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir, exist_ok=True)
    writers: List[_Writer] = []
    names: List[str] = []
    try:
        for i, table in enumerate(zoo.tables):
            name = _table_name(table, i)
            names.append(name)
            store = getattr(table, "store", None)
            if store is None:
                # host-resident tables: their own npz payload
                payload = table.store_state()
                _fsync_write(os.path.join(tmp_dir, f"{name}.npz"),
                             lambda f, p=payload: np.savez(f, **p))
                continue
            leaves, event = _stage(store, name, staging)
            w = _Writer(os.path.join(tmp_dir, name), leaves, event)
            writers.append(w)
            w.start()
    except BaseException:
        # Join the writers already started; a failed save never commits.
        try:
            AsyncSaveHandle(root, tmp_dir, writers).wait_until_finished()
        except Exception:  # noqa: BLE001 - the save error is the one raised
            pass
        raise
    return AsyncSaveHandle(root, tmp_dir, writers, table_names=names, t0=t0)


def save_all(directory: str, step: int = 0) -> str:
    """Blocking checkpoint of every registered table (async under the
    hood: per-table background writers joined before returning)."""
    return save_all_async(directory, step).wait_until_finished()


def _read_json(path: str) -> Dict:
    with open(path, "rb") as f:
        return json.loads(f.read().decode())


def check_format(checkpoint_dir: str) -> Dict:
    """The manifest of a tree this backend wrote; raises
    :class:`CheckpointFormatError` for any other tree."""
    meta = _read_json(os.path.join(checkpoint_dir, "manifest.json"))
    if meta.get("format") != FORMAT:
        raise CheckpointFormatError(
            f"{checkpoint_dir} is not a {FORMAT} tree: its manifest names no "
            "such format, so it is an orbax/tensorstore tree written by the "
            "JAX package's orbax backend, which this port does not read "
            "(write the checkpoint with the npz backend, ckpt_* "
            "directories, which both packages read)")
    return meta


def _read_leaf(path: str, stem: str, tag: str) -> torch.Tensor:
    arr = np.load(os.path.join(path, f"{stem}.npy"), allow_pickle=False)
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    check(arr.dtype.name == tag,
          f"leaf {stem} of {path} holds {arr.dtype.name}, tagged {tag}")
    return torch.from_numpy(arr)


def load_all(checkpoint_dir: str) -> None:
    """Restore every registered table from one manifested tree: each
    store's ``data`` and state leaves (shape and dtype as the live ones),
    host-only tables from their npz payloads."""
    check_format(checkpoint_dir)
    zoo = Zoo.get()
    for i, table in enumerate(zoo.tables):
        name = _table_name(table, i)
        store = getattr(table, "store", None)
        if store is None:
            path = os.path.join(checkpoint_dir, f"{name}.npz")
            if os.path.exists(path):
                data = np.load(path)
                table.load_state({k: data[k] for k in data.files})
            continue
        path = os.path.join(checkpoint_dir, name)
        if not os.path.exists(path):
            log.error("async checkpoint missing table '%s'", name)
            continue
        meta = _read_json(os.path.join(path, _LEAVES))
        if meta.get("format") != FORMAT:
            raise CheckpointFormatError(
                f"table directory {path} is not a {FORMAT} tree")
        tags = meta["leaves"]
        restored = {}
        for stem, live in _leaves(store):
            check(stem in tags, f"checkpoint of '{name}' lacks leaf {stem}")
            host = _read_leaf(path, stem, tags[stem])
            check(tuple(host.shape) == tuple(live.shape)
                  and host.dtype == live.dtype,
                  f"checkpoint leaf {stem} of '{name}' is "
                  f"{tuple(host.shape)} {host.dtype}, the live leaf "
                  f"{tuple(live.shape)} {live.dtype}")
            restored[stem] = host.to(live.device)
        with store._lock:
            store.data = restored.pop("data")
            for key in list(store.state):
                store.state[key] = restored[f"state_{key}"]
