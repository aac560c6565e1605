"""Whole-block skip-gram / negative-sampling trainer (B5).

Port of ``multiverso_tpu/ops/pallas_sgns.py``. ``build_sgns_grid_step``
returns a step with the JAX function's signature::

    step(w_in, w_out, g_in, g_out, centers2d, contexts2d, negatives3d,
         n_pairs, lr) -> (w_in, w_out, g_in, g_out, loss)

It trains every live chunk of a block (``ceil(n_pairs/chunk)`` of the
``[n, chunk]`` streams from ``pair_gen``), in order, each chunk being
``raw_sg_ns_step``; the tail chunk is masked by ``n_pairs`` and the loss
is summed over the chunks. The tables are updated IN PLACE (the JAX
kernel donated them) and returned.

For CUDA tensors the step launches ONE persistent cooperative kernel per
block (``csrc/sgns.cu``); for CPU tensors it runs the plain PyTorch chunk
loop (:func:`sgns_block_plain`), which is also the kernel's oracle. The
glue around the launch stable-sorts each live chunk's row ids (centers,
and contexts followed by negatives) so the kernel can fold duplicate ids
in lane order. How many chunks are live is known only on the device, so
the glue reads ``n_pairs`` on the host once per block: a block's stream
has room for every pair its sentences could give, and subsampling leaves
about a third of its chunks live at the flagship's settings.

The embeddings ``w_in``/``w_out`` may be float32 or bfloat16, as in the
JAX function; the AdaGrad sums ``g_in``/``g_out`` and all the math stay
float32. With bfloat16 tables the gathered rows widen to float32, each
lane's step is rounded to bfloat16 and added to its row in lane order
with a rounding after every add (the plain version does the same through
``ops/rows.add_rows_lane_order``): the kernel's bfloat16 instance.

On the TPU the kernel kept all four tables in VMEM, so it was only
eligible for small vocabularies. Here the tables stay in HBM, and
:func:`sgns_grid_eligible` reckons device memory.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from multiverso_tpu_torch.core.table import torch_dtype
from multiverso_tpu_torch.ops import _build

#: Kernel launches, counted where the kernel is launched: the float32
#: instance and the bfloat16 one.
LAUNCHES: Dict[str, int] = {"sgns_block": 0, "sgns_block_bf16": 0}

#: csrc/sgns.cu's kLongRun: runs this long are applied by a whole CTA.
#: The kernel refuses a long-run buffer sized with a smaller value
#: (``mv_sgns_block``), and ``chip_smoke.py`` holds this one to the
#: library's (``kernel_long_run``).
LONG_RUN = 32

#: The embedding dtypes the kernel is built for (``csrc/sgns.cu``'s
#: element type); the AdaGrad sums are float32.
EMBEDDING_DTYPES = (torch.float32, torch.bfloat16)

_grid_cache: Dict[tuple, int] = {}


def sgns_grid_bytes(in_rows: int, out_rows: int, dim: int, chunk: int,
                    negative: int, param_dtype) -> int:
    """Device bytes one block step needs: the four tables (embeddings in
    ``param_dtype``, f32 accumulators), the gradient scratch (``grad_u``
    and the snapshot of ``u``, [chunk, dim] each, and one coefficient per
    out-lane) and the sorted id/permutation streams of one chunk."""
    p = torch_dtype(param_dtype).itemsize
    tables = (in_rows + out_rows) * dim * (p + 4)
    scratch = (chunk * 2 * dim + chunk * (1 + negative)) * 4
    streams = chunk * (2 + negative) * 4 * 3
    return tables + scratch + streams


def sgns_grid_eligible(in_rows: int, out_rows: int, dim: int, chunk: int,
                       negative: int, param_dtype,
                       device: torch.device) -> bool:
    """True when the kernel takes this configuration on ``device``: a CUDA
    device, float32 or bfloat16 embeddings (``param_dtype`` read by name),
    at least one negative, and the working set within the device's
    memory."""
    if device.type != "cuda":
        return False
    if torch_dtype(param_dtype) not in EMBEDDING_DTYPES:
        return False
    if negative < 1:
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return sgns_grid_bytes(in_rows, out_rows, dim, chunk, negative,
                           param_dtype) <= total


def _n_live(n_pairs: torch.Tensor, chunk: int, n: int) -> int:
    return min((int(n_pairs) + chunk - 1) // chunk, n)


def sgns_block_plain(w_in, w_out, g_in, g_out, centers2d, contexts2d,
                     negatives3d, n_pairs, lr, adagrad: bool) -> torch.Tensor:
    """The plain version: the chunk loop over ``raw_sg_ns_step``, in place.
    Returns the loss summed over the live chunks (in chunk order)."""
    from multiverso_tpu_torch.models.word2vec.model import (chunk_loop,
                                                            raw_sg_ns_step)
    return chunk_loop(raw_sg_ns_step(adagrad), (w_in, w_out, g_in, g_out),
                      (centers2d, contexts2d), negatives3d, None, n_pairs,
                      lr)


def _lib():
    lib = _build.load("sgns")
    if not getattr(lib, "_mv_typed", False):
        c, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for sfx in ("", "_bf16"):
            fn = getattr(lib, "mv_sgns_block" + sfx)
            fn.argtypes = (
                [c] * 4 + [i64, i64] + [c] * 13 +
                [i64, i32, i32, i32, ctypes.c_float, i32, i32, c, i64, c, c])
            fn.restype = ctypes.c_int
            fn = getattr(lib, "mv_sgns_grid_size" + sfx)
            fn.argtypes = [i32, i32]
            fn.restype = ctypes.c_int
        lib.mv_sgns_long_run.argtypes = []
        lib.mv_sgns_long_run.restype = ctypes.c_int
        lib._mv_typed = True
    return lib


def _suffix(dtype: torch.dtype) -> str:
    """The C entry points' suffix of an embedding dtype's instance."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def grid_size(dim: int, negative: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> int:
    """CTAs of the cooperative grid (every CTA resident on the card) of
    the instance for embeddings of ``dtype``."""
    # csrc/sgns.cu's variants: up to 8 or 16 negatives held at once, or
    # the grouped one beyond 16.
    key = (device.index, dim % 4 == 0, min(2, (negative - 1) // 8), dtype)
    if key not in _grid_cache:
        with torch.cuda.device(device):
            _grid_cache[key] = int(getattr(
                _lib(), "mv_sgns_grid_size" + _suffix(dtype))(dim, negative))
    if _grid_cache[key] < 1:
        raise RuntimeError("the sg-ns kernel fits no CTA on an SM")
    return _grid_cache[key]


def kernel_long_run() -> int:
    """The built kernel's kLongRun."""
    return int(_lib().mv_sgns_long_run())


def _check(w_in, w_out, g_in, g_out, centers2d, contexts2d, negatives3d):
    tensors = (w_in, w_out, g_in, g_out, centers2d, contexts2d, negatives3d)
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the sg-ns kernel takes tensors on one CUDA "
                         f"device; got {sorted(str(d) for d in devs)}")
    for t in (w_in, w_out, g_in, g_out):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("sg-ns tables must be contiguous 2-D tensors")
    if w_in.dtype not in EMBEDDING_DTYPES or w_out.dtype != w_in.dtype or \
            g_in.dtype != torch.float32 or g_out.dtype != torch.float32:
        raise ValueError(f"the sg-ns kernel takes float32 or bfloat16 "
                         f"embeddings of one dtype and float32 AdaGrad sums; "
                         f"got {w_in.dtype}, {w_out.dtype}, {g_in.dtype}, "
                         f"{g_out.dtype}")
    if w_in.shape[1] != w_out.shape[1] or g_in.shape != w_in.shape or \
            g_out.shape != w_out.shape:
        raise ValueError("sg-ns table shapes disagree")
    n, chunk = centers2d.shape
    if contexts2d.shape != (n, chunk) or negatives3d.dim() != 3 or \
            negatives3d.shape[:2] != (n, chunk):
        raise ValueError("sg-ns stream shapes disagree")
    if negatives3d.shape[2] < 1:
        raise ValueError("the sg-ns kernel takes at least one negative")


class SgnsLaunch(NamedTuple):
    """Everything one launch of the block kernel reads and writes."""
    tables: tuple          # w_in, w_out, g_in, g_out (updated in place)
    streams: tuple         # centers, contexts, negatives (int32)
    sorted_streams: tuple  # in_ids, in_perm, out_ids, out_perm (int32)
    n_pairs: torch.Tensor  # [1] int32 on the card
    scratch: tuple         # grad_u, u snapshot, coefficients, loss partials
    long_runs: tuple       # [cap] run starts, [2, n] counters (the kernel's)
    loss: torch.Tensor     # [1] float32
    lr: float
    adagrad: bool
    grid: int


def long_run_capacity(chunk: int, negative: int) -> int:
    """Most runs of at least ``LONG_RUN`` lanes one chunk can hold: its
    ``chunk`` center slots and ``chunk * (1 + negative)`` out slots."""
    return chunk // LONG_RUN + chunk * (1 + negative) // LONG_RUN


def sorted_row_ids(centers, contexts, negatives, n_pairs):
    """The live chunks' row ids stable-sorted, with the lane each came
    from: returns ``(n_live, in_ids, in_perm, out_ids, out_perm)``, where
    ``n_live = ceil(n_pairs / chunk)`` (at most ``n``; one host read of
    ``n_pairs``), ``(in_ids, in_perm)`` [n_live, chunk] sort the centers
    and ``(out_ids, out_perm)`` [n_live, chunk * (1 + K)] the contexts
    followed by the flattened negatives. The dead chunks are not sorted:
    the kernel never reads them. Lanes past ``n_pairs`` (the tail chunk's
    padding) carry exact zero gradients; their keys sort to the end as an
    out-of-range id, which the kernel drops, so they join no real row's
    run."""
    n, chunk = centers.shape
    n_live = _n_live(n_pairs, chunk, n)
    centers, contexts = centers[:n_live], contexts[:n_live]
    negatives = negatives[:n_live]
    k = negatives.shape[2]
    lane = torch.arange(n_live * chunk,
                        device=centers.device).view(n_live, chunk)
    live = lane < n_pairs
    dead = torch.iinfo(torch.int32).max
    in_keys = torch.where(live, centers, dead)
    out_keys = torch.cat([
        torch.where(live, contexts, dead),
        torch.where(live[:, :, None], negatives,
                    dead).reshape(n_live, chunk * k)], 1)
    in_ids, in_perm = torch.sort(in_keys, dim=1, stable=True)
    out_ids, out_perm = torch.sort(out_keys, dim=1, stable=True)
    return (n_live, in_ids.contiguous(), in_perm.to(torch.int32),
            out_ids.contiguous(), out_perm.to(torch.int32))


def prepare_sgns_block(w_in, w_out, g_in, g_out, centers2d, contexts2d,
                       negatives3d, n_pairs, lr, adagrad: bool) -> SgnsLaunch:
    """The glue before the launch: checks, int32 streams, the per-chunk
    stable sort of the live chunks' row ids (which groups duplicate ids
    into runs in lane order) and the scratch buffers. It waits for the
    card once, to read ``n_pairs``; the launch takes the live chunks
    only."""
    _check(w_in, w_out, g_in, g_out, centers2d, contexts2d, negatives3d)
    dev = w_in.device
    chunk = centers2d.shape[1]
    k = negatives3d.shape[2]
    d = w_in.shape[1]
    n_pairs = torch.as_tensor(n_pairs, dtype=torch.int32,
                              device=dev).reshape(1).contiguous()
    centers = centers2d.to(torch.int32).contiguous()
    contexts = contexts2d.to(torch.int32).contiguous()
    negatives = negatives3d.to(torch.int32).contiguous()
    n_live, *sorted_ids = sorted_row_ids(centers, contexts, negatives,
                                         n_pairs)
    grid = grid_size(d, k, dev, w_in.dtype)
    scratch = (torch.empty((chunk, d), dtype=torch.float32, device=dev),
               torch.empty((chunk, d), dtype=torch.float32, device=dev),
               torch.empty(chunk * (1 + k), dtype=torch.float32, device=dev),
               torch.empty(2 * grid, dtype=torch.float32, device=dev))
    long_runs = (torch.empty(long_run_capacity(chunk, k), dtype=torch.int32,
                             device=dev),
                 torch.zeros((2, n_live), dtype=torch.int32, device=dev))
    return SgnsLaunch((w_in, w_out, g_in, g_out),
                      (centers[:n_live], contexts[:n_live],
                       negatives[:n_live]),
                      tuple(sorted_ids), n_pairs, scratch, long_runs,
                      torch.zeros(1, dtype=torch.float32, device=dev),
                      float(lr), bool(adagrad), grid)


def launch_sgns_block(p: SgnsLaunch) -> torch.Tensor:
    """One cooperative launch of the block kernel; returns the loss (0-d)."""
    w_in, w_out, g_in, g_out = p.tables
    n, chunk = p.streams[0].shape
    k = p.streams[2].shape[2]
    runs, counts = p.long_runs
    counts.zero_()                   # the kernel's per-chunk counters
    ptrs = [t.data_ptr() for t in (*p.streams, *p.sorted_streams)]
    err = getattr(_lib(), "mv_sgns_block" + _suffix(w_in.dtype))(
        w_in.data_ptr(), w_out.data_ptr(), g_in.data_ptr(), g_out.data_ptr(),
        w_in.shape[0], w_out.shape[0], *ptrs, p.n_pairs.data_ptr(),
        *[t.data_ptr() for t in p.scratch], p.loss.data_ptr(), n,
        chunk, k, w_in.shape[1], p.lr, int(p.adagrad), p.grid,
        runs.data_ptr(), runs.numel(), counts.data_ptr(),
        _build.stream(w_in))
    name = "sgns_block" + _suffix(w_in.dtype)
    _build.check_launch(err, name)
    LAUNCHES[name] += 1
    return p.loss[0]


def sgns_block_cuda(w_in, w_out, g_in, g_out, centers2d, contexts2d,
                    negatives3d, n_pairs, lr, adagrad: bool) -> torch.Tensor:
    """Glue + one launch of the block kernel; returns the loss (0-d)."""
    return launch_sgns_block(prepare_sgns_block(
        w_in, w_out, g_in, g_out, centers2d, contexts2d, negatives3d,
        n_pairs, lr, adagrad))


def build_sgns_grid_step(chunk: int, negative: int, adagrad: bool):
    """Whole-block sg-ns trainer with the JAX function's signature; tables
    are updated in place and returned."""

    def step(w_in, w_out, g_in, g_out, centers2d, contexts2d, negatives3d,
             n_pairs, lr):
        if centers2d.shape[1] != chunk or negatives3d.shape[2] != negative:
            raise ValueError(f"streams {tuple(negatives3d.shape)} do not "
                             f"match chunk={chunk}, negative={negative}")
        fn = (sgns_block_plain if w_in.device.type == "cpu"
              else sgns_block_cuda)
        loss = fn(w_in, w_out, g_in, g_out, centers2d, contexts2d,
                  negatives3d, n_pairs, lr, adagrad)
        return w_in, w_out, g_in, g_out, loss

    return step
