"""Allreduce / aggregate — the collective plane over ``torch.distributed``.

Port of ``multiverso_tpu/parallel/collectives.py``. Reference:
``MV_Aggregate`` -> ``MPI_Allreduce(MPI_IN_PLACE, SUM)``
(``src/multiverso.cpp:53-56``, ``mpi_net.h:147-151``), plus the
``AllreduceEngine``'s allgather and reduce-scatter
(``src/net/allreduce_engine.cpp:31-172``).

The JAX package's collectives are XLA's ``psum``, ``all_gather`` and
``psum_scatter`` over a device mesh axis, given one global array whose
slices along dim 0 are the devices' shards. The port's world is a
``torch.distributed`` process group over the gloo backend (on the card
and on the CPU alike: NCCL refuses two ranks on one card), and a rank
holds only its own shard. So each function here takes this rank's part
of the JAX function's global input and returns this rank's part of its
output; at world size 1 both are the JAX function's, and over a mesh axis
of ``n`` ranks the results are the JAX function's on an ``n``-device
axis.

gloo reduces CUDA tensors only in ``all_reduce`` and ``broadcast``; the
all-gather and the reduce-scatter stage a card tensor through a host
buffer explicitly, and each staged copy is counted
(``comm.collective.host_copies`` / ``.host_bytes``).

Without a process group (one rank, no ``-coordinator``) every collective
is the identity. A mesh axis of more than one rank with no process group
raises: nothing runs locally in place of a collective.

The long-context LM's collectives are differentiable
(``torch.autograd.Function``s over a group of ranks, :func:`ring_shift`,
:func:`all_to_all`, :func:`group_sum`): the port's ``ppermute``, tiled
``all_to_all`` and ``psum``. gloo moves card tensors only in
``all_reduce`` and ``broadcast``, so the point-to-point exchanges and the
all-to-all stage through the host, counted like the others. Every
exchange pairs an ``isend`` with an ``irecv`` under a tag of its own,
numbered per group in call order (every rank of a group makes the same
calls in the same order) with the backward exchange one tag above its
forward one: two ranks never pair the wrong messages, whatever order
autograd runs independent nodes in.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from multiverso_tpu_torch.parallel.mesh import SERVER_AXIS
from multiverso_tpu_torch.telemetry import counter


def world_size() -> int:
    """Ranks in this process's world (1 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _stage(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host for a collective gloo runs there only: a card
    tensor is copied (and counted), a host tensor is used as it is."""
    if x.device.type == "cpu":
        return x.contiguous()
    counter("comm.collective.host_copies").inc()
    counter("comm.collective.host_bytes").inc(x.numel() * x.element_size())
    return x.cpu()


def _unstage(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return x
    counter("comm.collective.host_copies").inc()
    counter("comm.collective.host_bytes").inc(x.numel() * x.element_size())
    return x.to(device)


def axis_group(mesh, axis: str):
    """``(size, group)`` of this rank's slice along ``axis``."""
    n = mesh.axis_size(axis) if mesh is not None else 1
    if n <= 1:
        return 1, None
    group = mesh.group(axis)
    if group is None:
        raise RuntimeError(f"mesh axis {axis!r} spans {n} ranks but has no "
                           "process group")
    return n, group


def allreduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM of ``x`` over ``group`` (default: the world), in a new tensor on
    ``x``'s device. gloo reduces a card tensor in place itself."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def allreduce_sum_many(tensors, group) -> list:
    """Each tensor summed over ``group`` (None: unchanged), all in one
    all-reduce of their flattened concatenation."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    flat = allreduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def device_allreduce(x: torch.Tensor, mesh,
                     axis: str = SERVER_AXIS) -> torch.Tensor:
    """Sum of the ranks' ``x`` over ``axis`` (the JAX function's ``psum``:
    ``x`` is this rank's shard of its global input, the result its
    replicated output)."""
    n, group = axis_group(mesh, axis)
    if n == 1:
        return x
    return allreduce_sum(x, group)


def device_allgather(x: torch.Tensor, mesh,
                     axis: str = SERVER_AXIS) -> torch.Tensor:
    """``AllreduceEngine::Allgather`` analog: every rank's ``x`` along dim
    0, concatenated in axis order, on every rank."""
    return all_gather_cat(x, axis_group(mesh, axis)[1])


def device_reduce_scatter(x: torch.Tensor, mesh,
                          axis: str = SERVER_AXIS) -> torch.Tensor:
    """``AllreduceEngine::ReduceScatter`` analog: ``x`` is this rank's
    whole ``[n*k, ...]`` contribution; the result is the SUM of the
    ranks' contributions' k-row slice at this rank's axis index."""
    n, group = axis_group(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    host = _stage(x)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype)
    dist.reduce_scatter(out, list(host.chunk(n)), op=dist.ReduceOp.SUM,
                        group=group)
    return _unstage(out, x.device)


def aggregate(data):
    """``MV_Aggregate`` analog: elementwise SUM across every rank of the
    world (ref ``mpi_net.h:147-151``). A tensor comes back as a tensor on
    its device, anything else as a numpy array. In a one-rank world this
    is the data itself (a copy), the ``mpirun -np 1`` case of
    ``Test/test_allreduce.cpp:11-20``."""
    if isinstance(data, torch.Tensor):
        if world_size() == 1:
            return data.clone()
        return allreduce_sum(data)
    arr = np.array(data, copy=True)
    if world_size() == 1:
        return arr
    out = allreduce_sum(torch.from_numpy(np.ascontiguousarray(arr)))
    return out.numpy()


# ---------------------------------------------------------------------------
# Differentiable collectives over a group of ranks (the LM's sequence,
# data and stage axes).
# ---------------------------------------------------------------------------
_TAGS: dict = {}
_TAG_SPAN = 1 << 29


def next_tag(group) -> int:
    """The next pair of tags of ``group`` for :func:`exchange` (even: a
    forward exchange, odd: its backward), counted in call order: every
    rank of the group must take its tags in the same order."""
    key = id(group)
    n = _TAGS.get(key, 0)
    _TAGS[key] = n + 1
    return 2 * (n % _TAG_SPAN)


def group_rank_size(group):
    """(this rank's index, size) of ``group`` (None: this rank alone)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, index: int) -> int:
    return dist.get_global_rank(group, index) if group is not None \
        and group is not dist.group.WORLD else index


def exchange(sends, recvs, group, tag: int) -> list:
    """One point-to-point step over ``group``: every ``(tensor, index)``
    of ``sends`` goes to that group index and, for every ``(like,
    index)`` of ``recvs``, a tensor shaped like ``like`` comes from that
    index, all in flight at once (``isend``/``irecv`` pairs, never a
    blocking send before a receive), under ``tag``. Card tensors go
    through the host, counted. Returns the received tensors, in order,
    on their ``like``'s device."""
    ops, boxes = [], []
    for x, dst in sends:
        ops.append(dist.P2POp(dist.isend, _stage(x.contiguous()),
                              _global(group, dst), group=group, tag=tag))
    for like, src in recvs:
        box = torch.empty(like.shape, dtype=like.dtype)
        boxes.append((box, like.device))
        ops.append(dist.P2POp(dist.irecv, box, _global(group, src),
                              group=group, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_unstage(box, device) for box, device in boxes]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        rank, n = group_rank_size(group)
        tag = next_tag(group)
        ctx.group, ctx.tag, ctx.step = group, tag, step
        return exchange([(x, (rank + step) % n)], [(x, (rank - step) % n)],
                        group, tag)[0]

    @staticmethod
    def backward(ctx, g):
        rank, n = group_rank_size(ctx.group)
        return (exchange([(g, (rank - ctx.step) % n)],
                         [(g, (rank + ctx.step) % n)], ctx.group,
                         ctx.tag + 1)[0], None, None)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """``ppermute`` around the ring of ``group``: this rank's ``x`` goes
    to index + ``step`` and the result is index - ``step``'s. Its
    gradient shifts the other way. A group of one rank returns ``x``."""
    if group_rank_size(group)[1] == 1:
        return x
    return _RingShift.apply(x, group, step)


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int,
                tag: int) -> torch.Tensor:
    """The tiled all-to-all as point-to-point pairs (gloo's ``alltoall``
    is missing from some torch builds): part j of ``x`` goes to index j,
    this rank's own part stays, all in one exchange."""
    rank, n = group_rank_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    parts = [p.contiguous() for p in _stage(x).chunk(n, dim=split_dim)]
    others = [j for j in range(n) if j != rank]
    got = exchange([(parts[j], j) for j in others],
                   [(parts[j], j) for j in others], group, tag)
    recv = dict(zip(others, got))
    recv[rank] = parts[rank]
    return _unstage(torch.cat([recv[j] for j in range(n)], dim=concat_dim),
                    x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        ctx.tag = next_tag(group)
        return _all_to_all(x, group, split_dim, concat_dim, ctx.tag)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.group, concat_dim, split_dim,
                            ctx.tag + 1), None, None, None)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over ``group``: ``x`` splits into n parts along ``split_dim``, part j
    goes to index j, and the parts received are concatenated along
    ``concat_dim`` in index order. Its gradient is the inverse swap. A
    group of one rank returns ``x``."""
    if group_rank_size(group)[1] == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return allreduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank, whose gradient is the
    identity: for a total that one objective counts once (a loss summed
    over ranks, the global token counts of the MoE block), each rank's
    backward then runs on its own share. A group of one rank returns
    ``x``."""
    if group_rank_size(group)[1] == 1:
        return x
    return _GroupSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every index's ``x`` along dim 0, concatenated in index order, on
    every rank (not differentiable); staged through the host."""
    n = group_rank_size(group)[1]
    if n == 1:
        return x
    host = _stage(x)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return _unstage(torch.cat(parts), x.device)
