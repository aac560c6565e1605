"""The rank mesh: the world's ranks laid out on named axes.

Port of ``multiverso_tpu/parallel/mesh.py``. The JAX package's mesh lays
*devices* out on named axes (``"server"`` for table shards, ``"worker"``
for data parallelism) and its collectives are XLA's over those axes. The
port's mesh lays the *ranks* of the ``torch.distributed`` world out the
same way: ``-mesh_shape=axis:size,...`` in row-major order, every rank on
every axis, with one process subgroup per slice of each axis (the ranks
that differ only in that axis's coordinate). The collectives of
``parallel/collectives.py`` and the dense merge of
``parallel/comm_policy.py`` run over an axis's subgroup.

Tables stay whole on each rank's card: the mesh names the ranks that
reduce together, and no table is sharded over it (``num_servers`` stays
1; sharding a table over cards is ROADMAP A10).

A world of one rank has no process group: every axis has size 1 and every
collective over it is the identity.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from multiverso_tpu_torch.utils.configure import get_flag

SERVER_AXIS = "server"
WORKER_AXIS = "worker"
#: The long-context LM's axes: data x sequence parallelism, or the 1F1B
#: pipeline's stages x sequence (``models/attention_lm.py``).
DATA_AXIS = "data"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse ``'axis:size,axis:size'`` into an ordered dict."""
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        axes[name.strip()] = int(size)
    return axes


class RankMesh:
    """The world's ranks on named axes, and this rank's subgroup on each.

    ``shape`` is the axis -> size dict (the JAX ``Mesh.shape``);
    ``ranks`` the rank of every mesh position; :meth:`group` the process
    group of this rank's slice along an axis (None for an axis of size 1:
    nothing to reduce over)."""

    def __init__(self, axes: Dict[str, int], rank: int, groups: Dict):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names = tuple(axes)
        self.ranks = np.arange(int(np.prod(list(axes.values()))),
                               dtype=np.int64).reshape(tuple(axes.values()))
        self.rank = rank
        self._groups = groups

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 off the mesh's axes)."""
        if axis not in self.shape:
            return 0
        pos = np.argwhere(self.ranks == self.rank)[0]
        return int(pos[self.axis_names.index(axis)])

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis``."""
        return self._groups.get(axis)

    @property
    def size(self) -> int:
        """Ranks on the mesh."""
        return int(self.ranks.size)

    @property
    def world_group(self):
        """The process group of every rank of the mesh (None: one rank)."""
        return dist.group.WORLD if self.size > 1 else None


def _slices(ranks: np.ndarray, axis: int):
    """Every slice of ``ranks`` along ``axis``: the rank lists that differ
    only in that coordinate, in a fixed order (every rank must create the
    subgroups in the same order)."""
    moved = np.moveaxis(ranks, axis, -1)
    for idx in itertools.product(*(range(n) for n in moved.shape[:-1])):
        yield [int(r) for r in moved[idx]]


def build_mesh(spec: Optional[str] = None) -> RankMesh:
    """Build the rank mesh of this process's world.

    Default: a 1-D mesh with every rank on the ``"server"`` axis, the JAX
    package's default layout. ``spec`` (default ``-mesh_shape``) names the
    axes; their sizes must multiply to the world size. In a world of more
    than one rank every rank must call this, in the same order: it creates
    the axes' subgroups collectively."""
    multi = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    if spec is None:
        spec = get_flag("mesh_shape")
    axes = parse_mesh_spec(spec) if spec else {SERVER_AXIS: world}
    total = int(np.prod(list(axes.values()))) if axes else 1
    if total != world:
        raise ValueError(f"mesh_shape {spec!r} has {total} positions; the "
                         f"world has {world} ranks")
    ranks = np.arange(world, dtype=np.int64).reshape(tuple(axes.values()))
    groups: Dict = {}
    for i, name in enumerate(axes):
        if axes[name] <= 1:
            continue
        if axes[name] == world:
            groups[name] = dist.group.WORLD
            continue
        for members in _slices(ranks, i):
            group = dist.new_group(members)
            if rank in members:
                groups[name] = group
    return RankMesh(axes, rank, groups)


def lm_axes(world: int, seq_parallel: Optional[int] = None,
            data_parallel: Optional[int] = None,
            pipeline_stages: int = 0) -> Dict[str, int]:
    """The long-context LM's axes and sizes on a world of ``world`` ranks,
    with the JAX ``AttentionLM``'s defaults: ``{stage: P, seq: sp}``
    (``sp = seq_parallel or 1``) for the 1F1B pipeline of ``P > 0``
    stages, else ``{data: dp, seq: sp}`` with ``sp = seq_parallel or
    min(world, 4)`` and ``dp = data_parallel or world // sp``. The model
    checks that the sizes fit the world."""
    if pipeline_stages > 0:
        return {STAGE_AXIS: pipeline_stages, SEQ_AXIS: seq_parallel or 1}
    sp = seq_parallel or min(world, 4)
    return {DATA_AXIS: data_parallel or max(world // sp, 1), SEQ_AXIS: sp}


def lm_mesh_spec(world: int, seq_parallel: Optional[int] = None,
                 data_parallel: Optional[int] = None,
                 pipeline_stages: int = 0) -> str:
    """The ``-mesh_shape`` of :func:`lm_axes`."""
    return ",".join(f"{a}:{k}" for a, k in lm_axes(
        world, seq_parallel, data_parallel, pipeline_stages).items())


def build_lm_mesh(seq_parallel: Optional[int] = None,
                  data_parallel: Optional[int] = None,
                  pipeline_stages: int = 0) -> RankMesh:
    """The rank mesh of the long-context LM over this process's world
    (:func:`lm_mesh_spec`); every rank of the world must call it, in the
    same order, as :func:`build_mesh`."""
    multi = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if multi else 1
    return build_mesh(lm_mesh_spec(world, seq_parallel, data_parallel,
                                   pipeline_stages))
