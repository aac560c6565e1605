"""Framework param managers: sync a model's parameters through one table.

Port of ``multiverso_tpu/binding/param_manager.py``. Parity with the
reference binding shims:

* ``MVSharedVariable.mv_sync`` (``binding/python/multiverso/theano_ext/
  sharedvar.py:12-75``): push (current - last_synced) delta, then pull.
* ``MVModelParamManager`` (``theano_ext/param_manager.py:9-81``): flatten all
  model params into ONE ArrayTable; per-batch/epoch sync.
* ``MVCallback`` (``keras_ext/callbacks.py:8-39``): sync every ``freq``
  batches.

:class:`PyTreeParamManager` takes a tree of tensors (nested dicts, lists
and tuples, the shape of the JAX package's pytrees) and flattens it in
the JAX package's leaf order: dict keys sorted, sequences in order, so
both packages lay a model out in the table alike. :class:`TorchParamManager`
takes an ``nn.Module``. The table lives on the Zoo's device.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

import multiverso_tpu_torch as mv


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


class PyTreeParamManager:
    """Flattens a tree of tensors into one ArrayTable and syncs it.

    ASGD semantics across workers: each worker pushes its local delta since
    the last sync and pulls the merged global parameters. Pulled leaves
    come back as tensors of each leaf's dtype on its device.
    """

    def __init__(self, params: Any, name: str = "pytree_params"):
        leaves = tree_leaves(params)
        self._like = params
        self._shapes = [tuple(l.shape) for l in leaves]
        self._sizes = [int(np.prod(s)) if s else 1 for s in self._shapes]
        self._dtypes = [l.dtype for l in leaves]
        self._devices = [l.device for l in leaves]
        total = sum(self._sizes)
        self.table = mv.create_table(
            mv.ArrayTableOption(size=total, name=name))
        # Master seeds the initial values; everyone else contributes zero
        # (the reference's master-only init trick, tables.py:58-75).
        if mv.is_master_worker():
            self.table.add(self._flatten(params))
        else:
            self.table.add(np.zeros(total, dtype=np.float32))
        mv.barrier()
        self._last_synced = self.table.get()

    def _flatten(self, params: Any) -> np.ndarray:
        return np.concatenate(
            [torch.as_tensor(l).detach().to(torch.float32).reshape(-1)
             .cpu().numpy() for l in tree_leaves(params)])

    def _unflatten(self, flat: np.ndarray) -> Any:
        leaves = []
        offset = 0
        for shape, size, dtype, dev in zip(self._shapes, self._sizes,
                                           self._dtypes, self._devices):
            chunk = np.array(flat[offset:offset + size]).reshape(shape)
            leaves.append(torch.from_numpy(chunk).to(device=dev,
                                                     dtype=dtype))
            offset += size
        return tree_unflatten(self._like, leaves)

    def sync(self, params: Any) -> Any:
        """Push local delta, pull global params (mv_sync analog)."""
        current = self._flatten(params)
        self.table.add(current - self._last_synced)
        self._last_synced = self.table.get()
        return self._unflatten(self._last_synced)

    def get(self) -> Any:
        self._last_synced = self.table.get()
        return self._unflatten(self._last_synced)


class TorchParamManager:
    """Same contract for a torch ``nn.Module`` (the Lua/Torch binding's
    ArrayTableHandler role, ``binding/lua/ArrayTableHandler.lua:6-56``)."""

    def __init__(self, module: Any, name: str = "torch_params"):
        self._module = module
        self._params = list(module.parameters())
        self._sizes = [int(p.numel()) for p in self._params]
        total = sum(self._sizes)
        self.table = mv.create_table(
            mv.ArrayTableOption(size=total, name=name))
        if mv.is_master_worker():
            self.table.add(self._flatten())
        else:
            self.table.add(np.zeros(total, dtype=np.float32))
        mv.barrier()
        self._last_synced = self.table.get()
        self._write_back(self._last_synced)

    def _flatten(self) -> np.ndarray:
        return np.concatenate(
            [p.detach().cpu().numpy().astype(np.float32).ravel()
             for p in self._params])

    def _write_back(self, flat: np.ndarray) -> None:
        offset = 0
        with torch.no_grad():
            for p, size in zip(self._params, self._sizes):
                chunk = flat[offset:offset + size].reshape(tuple(p.shape))
                p.copy_(torch.from_numpy(np.array(chunk, copy=True)))
                offset += size

    def sync(self) -> None:
        current = self._flatten()
        self.table.add(current - self._last_synced)
        self._last_synced = self.table.get()
        self._write_back(self._last_synced)


class SyncCallback:
    """Sync every ``freq`` batches (keras MVCallback analog,
    callbacks.py:8-39)."""

    def __init__(self, manager: Any, freq: int = 1):
        self.manager = manager
        self.freq = max(1, freq)
        self._batch = 0
        self.latest: Optional[Any] = None

    def on_batch_end(self, params: Optional[Any] = None) -> Optional[Any]:
        self._batch += 1
        if self._batch % self.freq == 0:
            if params is not None:
                self.latest = self.manager.sync(params)
            else:
                self.manager.sync()
            return self.latest
        return None
