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
    n, group = axis_group(mesh, axis)
    if n == 1:
        return x
    host = _stage(x)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return _unstage(torch.cat(parts), x.device)


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
