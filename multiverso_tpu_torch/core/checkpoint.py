"""Checkpoint / resume for tables.

Port of ``multiverso_tpu/core/checkpoint.py``.

Parity with the reference's ``ServerTable : Serializable {Store, Load}``
surface (``include/multiverso/table_interface.h:61-75``; raw dumps at
``src/table/array_table.cpp:144-151``, ``matrix_table.cpp:457-464``) plus the
periodic-trigger/restore driver the reference's Docker tests referenced but
the core had dropped (SURVEY.md §5: "no periodic trigger in-core").

Table payloads (parameter array + updater state) serialize as npz through
the URI-schemed stream layer (:mod:`multiverso_tpu_torch.utils.stream`);
:class:`CheckpointManager` adds step-interval triggers, retention, and
latest-checkpoint resume.

The file format is the JAX package's, so a checkpoint written by either
package loads in the other bit for bit. A bfloat16 entry (a bfloat16
table's ``data``, momentum's bfloat16 ``smooth``) is stored as its 16-bit
pattern (``uint16``) and named in the ``__extension_dtypes__`` tag. The
port's ``store_state`` hands such an entry over widened to float32 (numpy
has no bfloat16 without ``ml_dtypes``); the widening is exact, so
:func:`save_table` takes the top 16 bits of each float32 back, and
:func:`read_table_payload` widens the stored pattern to float32 again,
which the store narrows to ``torch.bfloat16`` exactly.

``CheckpointManager(backend="orbax")`` runs the async backend of
:mod:`multiverso_tpu_torch.core.checkpoint_orbax` (the port's own format
under the JAX package's ``orbax_<step>`` layout and commit protocol); a
directory that holds both backends' trees is pruned as the JAX package
prunes it.
"""

from __future__ import annotations

import io
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.utils.log import check, log
from multiverso_tpu_torch.utils.stream import exists, open_stream


_DTYPE_TAG_KEY = "__extension_dtypes__"


def _live_tensor(table: Any, key: str) -> Optional[torch.Tensor]:
    """The stored tensor behind payload entry ``key`` (``data`` or
    ``state/<leaf>``), or None for host-side entries (KV keys, slots)."""
    store = getattr(table, "store", None)
    if store is None:
        return None
    if key == "data":
        return store.data
    if key.startswith("state/"):
        return store.state.get(key[len("state/"):])
    return None


def bfloat16_bits(values: np.ndarray) -> np.ndarray:
    """float32 values that are exactly bfloat16 -> their uint16 patterns."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    return (values.view(np.uint32) >> 16).astype(np.uint16)


def bfloat16_widen(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 patterns -> the float32 values they denote."""
    bits = np.ascontiguousarray(bits, dtype=np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def save_table(table: Any, uri: str) -> None:
    """``ServerTable::Store`` analog: table payload -> stream as npz."""
    payload = table.store_state() if hasattr(table, "store_state") \
        else table.store.store_state()
    out: Dict[str, np.ndarray] = {}
    tags: List[str] = []
    for k, v in payload.items():
        live = _live_tensor(table, k)
        if live is not None and live.dtype == torch.bfloat16:
            out[k] = bfloat16_bits(v)
            tags.append(f"{k}=bfloat16")
        else:
            out[k] = v
    if tags:
        out[_DTYPE_TAG_KEY] = np.asarray(tags)
    buf = io.BytesIO()
    np.savez(buf, **out)
    with open_stream(uri, "w") as s:
        s.write(buf.getvalue())


def read_table_payload(uri: str) -> Dict[str, np.ndarray]:
    """Read one table's checkpoint payload (data + updater state + any
    directory entries) WITHOUT a live table to load it into — the
    checkpoint-to-serving handoff. bfloat16 entries come back widened to
    float32 (exactly)."""
    with open_stream(uri, "r") as s:
        data = np.load(io.BytesIO(s.read()))
        payload = {k: data[k] for k in data.files if k != _DTYPE_TAG_KEY}
    if _DTYPE_TAG_KEY in data.files:
        for tag in data[_DTYPE_TAG_KEY].tolist():
            key, _, dtype_name = tag.partition("=")
            if dtype_name != "bfloat16":
                raise NotImplementedError(
                    f"checkpoint entry {key!r} has dtype {dtype_name}, "
                    "which the port does not read")
            payload[key] = bfloat16_widen(payload[key])
    return payload


def load_table(table: Any, uri: str) -> None:
    """``ServerTable::Load`` analog."""
    payload = read_table_payload(uri)
    if hasattr(table, "load_state"):
        table.load_state(payload)
    else:
        table.store.load_state(payload)


def _save_rank(zoo: Zoo) -> int:
    """The rank a process's checkpoint files are named by: its rank in
    the PS world where a service has adopted one (the JAX module's
    ``_ps_rank``), else its rank in the collective world (0 in a world of
    one process, where the JAX module also names everything rank 0)."""
    svc = getattr(zoo, "ps_service", None)
    rank = getattr(svc, "rank", None) if svc is not None else None
    return rank if rank is not None else zoo.rank()


def _meta_name(rank: int) -> str:
    """Each rank writes its own manifest into a shared checkpoint dir
    (rank 0 keeps the plain name for single-process compatibility)."""
    return "meta.json" if rank == 0 else f"meta.r{rank}.json"


def save_all(directory: str, step: int = 0) -> str:
    """Checkpoint every registered table into ``directory/ckpt_{step}/``.

    Distributed tables contribute only this rank's shard,
    filename-qualified by their ``checkpoint_suffix``; on ranks > 0 every
    other table's file is qualified with the rank too (it is per-process
    replica state), so ranks saving into a shared directory never
    collide."""
    zoo = Zoo.get()
    check(zoo.started, "runtime not started")
    rank = _save_rank(zoo)
    root = os.path.join(directory, f"ckpt_{step:012d}")
    names: List[str] = []
    files: Dict[str, str] = {}
    for i, table in enumerate(zoo.tables):
        name = getattr(table, "name", f"table_{i}")
        suffix = getattr(table, "checkpoint_suffix",
                         f"-r{rank}" if rank else "")
        fname = f"{name}{suffix}.npz"
        save_table(table, os.path.join(root, fname))
        names.append(name)
        files[name] = fname
    meta = {"step": step, "time": time.time(), "tables": names,
            "files": files}
    with open_stream(os.path.join(root, _meta_name(rank)), "w") as s:
        s.write(json.dumps(meta).encode())
    return root


def load_all(checkpoint_dir: str) -> int:
    """Restore every registered table from a ``ckpt_*`` directory; returns
    the step. Each rank reads its own manifest (falling back to rank 0's
    for checkpoints written by a single process)."""
    zoo = Zoo.get()
    meta_path = os.path.join(checkpoint_dir, _meta_name(_save_rank(zoo)))
    if not exists(meta_path):
        meta_path = os.path.join(checkpoint_dir, "meta.json")
    with open_stream(meta_path, "r") as s:
        meta = json.loads(s.read().decode())
    files = meta.get("files", {})
    by_name = {getattr(t, "name", f"table_{i}"): t
               for i, t in enumerate(zoo.tables)}
    for name in meta["tables"]:
        table = by_name.get(name)
        if table is None:
            log.error("checkpoint has unknown table '%s'; skipping", name)
            continue
        fname = files.get(name, f"{name}.npz")
        load_table(table, os.path.join(checkpoint_dir, fname))
    return int(meta["step"])


def checkpoint_manifests(checkpoint_dir: str) -> List[Dict]:
    """Every rank's manifest in one ``ckpt_*`` directory (``meta.json`` +
    ``meta.r<rank>.json``), rank-ordered."""
    out: List[Dict] = []
    if not os.path.isdir(checkpoint_dir):
        return out
    names = sorted(
        (n for n in os.listdir(checkpoint_dir)
         if re.fullmatch(r"meta(\.r\d+)?\.json", n)),
        key=lambda n: 0 if n == "meta.json"
        else int(n.split(".")[1][1:]))
    for name in names:
        with open_stream(os.path.join(checkpoint_dir, name), "r") as s:
            out.append(json.loads(s.read().decode()))
    return out


def latest_checkpoint(directory: str, prefix: str = "ckpt",
                      selector: str = "meta.json") -> Optional[str]:
    """Newest COMPLETE checkpoint dir: ``<prefix>_<step>`` containing the
    ``selector`` file (the durability marker its writer creates last — a
    crash mid-save leaves a selectorless, never-restored directory).
    Ordered by numeric step."""
    if not os.path.isdir(directory):
        return None
    candidates = sorted(
        (d for d in os.listdir(directory)
         if re.fullmatch(rf"{prefix}_\d{{12}}", d) and
         os.path.exists(os.path.join(directory, d, selector))),
        key=lambda d: int(d.split("_")[1]))
    if not candidates:
        return None
    return os.path.join(directory, candidates[-1])


class CheckpointManager:
    """Periodic save + retention + resume.

    ``backend="npz"`` (default) writes reference-style per-table npz
    streams synchronously. ``backend="orbax"`` uses the async backend
    (``core/checkpoint_orbax.py``): ``maybe_save`` returns once the tables
    are staged and the writes land in background threads, so the periodic
    trigger overlaps training; at most one save is in flight (the next
    trigger, or ``finalize()``, joins the previous one first), and the
    host staging buffers are reused from save to save."""

    def __init__(self, directory: str, save_every_steps: int = 1000,
                 keep_last: int = 3, backend: str = "npz"):
        check(backend in ("npz", "orbax"), f"unknown backend {backend!r}")
        self.directory = directory
        self.save_every_steps = max(1, save_every_steps)
        self.keep_last = max(1, keep_last)
        self.backend = backend
        self._last_saved_step = -1
        self._pending = None     # in-flight async AsyncSaveHandle
        self._staging = None     # the async backend's host buffers
        #: The last async save's handle (its ``staged_s``/``total_s``).
        self.last_handle = None

    def maybe_save(self, step: int) -> Optional[str]:
        """Returns the checkpoint root when a save was triggered. With the
        orbax backend the returned root is still being written in the
        background and is durable only once its ``manifest.json`` appears
        (written by the join at the next trigger or ``finalize()``);
        restore selects on that marker."""
        if step % self.save_every_steps != 0 or step == self._last_saved_step:
            return None
        if self.backend == "orbax":
            from multiverso_tpu_torch.core import checkpoint_orbax as co
            self._join_pending()          # at most one save in flight
            if self._staging is None:
                self._staging = co.HostStaging()
            handle = co.save_all_async(self.directory, step,
                                       staging=self._staging)
            self._pending = self.last_handle = handle
            self._last_saved_step = step
            return handle.root
        path = save_all(self.directory, step)
        self._last_saved_step = step
        self._prune()
        return path

    def _join_pending(self) -> None:
        if self._pending is not None:
            try:
                self._pending.wait_until_finished()
            finally:
                self._pending = None
            self._prune()

    def finalize(self) -> None:
        """Join the in-flight async save (call before shutdown/restore)."""
        self._join_pending()

    def _is_complete(self, name: str) -> bool:
        selector = "manifest.json" if name.startswith("orbax_") \
            else "meta.json"
        return os.path.exists(os.path.join(self.directory, name, selector))

    def _prune(self) -> None:
        if not os.path.isdir(self.directory):
            return
        # Numeric-step order, prefix-agnostic: a directory holding both
        # backends' checkpoints must never retention-delete the NEWEST
        # steps because of lexicographic prefix ordering.
        ckpts = sorted(
            (d for d in os.listdir(self.directory)
             if re.fullmatch(r"(ckpt|orbax)_\d{12}", d)),
            key=lambda d: int(d.split("_")[1]))
        # Only COMPLETE checkpoints (selector file present) count toward
        # keep_last — an interrupted save must never displace a restorable
        # one. Incomplete dirs older than the newest complete checkpoint
        # are crash garbage and go too; NEWER incomplete dirs are left
        # alone (a peer rank's save may be in flight on a shared dir).
        complete = [d for d in ckpts if self._is_complete(d)]
        stales = complete[:-self.keep_last]
        newest = int(complete[-1].split("_")[1]) if complete else None
        if newest is not None:
            stales += [d for d in ckpts
                       if not self._is_complete(d)
                       and int(d.split("_")[1]) < newest]
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"orbax_(\d{12})\.tmp-\d+", d)
            if not m:
                continue
            full = os.path.join(self.directory, d)
            step = int(m.group(1))
            if os.path.exists(os.path.join(full, "manifest.json")):
                # Manifested staging (crash between manifest and rename):
                # restorable, so keep it until a committed root of the
                # same-or-newer step supersedes it.
                if newest is not None and step <= newest:
                    stales.append(d)
            else:
                # Manifest-less staging: a dead save — but only if it is
                # actually dead (age gate: a LIVE save of a concurrent
                # process also looks like this on a shared directory).
                try:
                    age = time.time() - os.path.getmtime(full)
                except OSError:
                    continue
                if age > 900:
                    stales.append(d)
        for stale in stales:
            full = os.path.join(self.directory, stale)
            if stale.startswith("orbax_"):
                # Nested orbax tree; its own commit markers are the
                # selector, so recursive removal is safe.
                import shutil
                shutil.rmtree(full, ignore_errors=True)
                continue
            try:   # concurrent ranks may prune the same shared directory
                # Manifests go FIRST: latest_checkpoint selects on
                # meta.json, so a crash (or racing rank) mid-prune leaves
                # an unselectable directory, never one whose manifest
                # survives its shard files.
                entries = sorted(
                    os.listdir(full),
                    key=lambda f: (f != "meta.json",   # the selector file
                                   not f.startswith("meta")))
                for f in entries:
                    os.unlink(os.path.join(full, f))
                os.rmdir(full)
            except OSError:
                pass

    def _orbax_candidates(self):
        """Every MANIFESTED orbax dir — committed roots AND manifested
        staging dirs (a crash between 'manifest written' and 'rename
        landed' leaves the complete checkpoint under its staging name;
        the manifest, not the name, is the durability marker). Returns
        [(step, is_plain_root, name)]."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"orbax_(\d{12})(\.tmp-\d+)?", d)
            if m and os.path.exists(os.path.join(self.directory, d,
                                                 "manifest.json")):
                out.append((int(m.group(1)), m.group(2) is None, d))
        return out

    def restore_latest(self) -> Optional[int]:
        if self.backend == "orbax":
            from multiverso_tpu_torch.core import checkpoint_orbax as co
            self._join_pending()
            cands = self._orbax_candidates()
            if not cands:
                return None
            step, _, name = max(cands)   # newest step; plain root wins ties
            co.load_all(os.path.join(self.directory, name))
            return step
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return load_all(path)
