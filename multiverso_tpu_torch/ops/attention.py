"""Flash block attention (B6), the local block step of ring and Ulysses
attention, and paged decode attention (B7), the serving step's read of
the paged KV pool.

Port of the B6 half of ``multiverso_tpu/ops/pallas_attention.py``
(``flash_block_attn`` and ``supported``). :func:`flash_block_attn`
returns the UN-normalised streaming-softmax result ``(o, m, l)`` of one
(q block, k/v block) pair, as ``_block_attn`` does, so the ring merge of
``parallel/sequence.py`` is unchanged: ``o = exp(s - m) @ v``,
``m = max(rowmax(s), -1e30)``, ``l = rowsum(exp(s - m))``, all float32,
with the causal mask ``k_pos > q_pos`` built from the block offsets and an
optional ``[Sq, Sk]`` additive bias.

For CUDA tensors the wrapper launches the hand-written kernel of
``csrc/attention.cu`` (or raises); for CPU tensors it runs the plain
PyTorch version :func:`flash_block_attn_plain`, which is also the kernel's
oracle in ``chip_smoke.py``. The wrapper has no gradient on either path:
the JAX package cannot differentiate through its ``pallas_call`` either,
and trains through the plain ``_block_attn``. Called directly, the plain
version is that training step: ``parallel/sequence.py`` runs it as the
ring's block step with the flag off, and autograd differentiates it. The
kernel has narrow instances (one warpgroup a 64-row q tile) for heads up
to 128 columns and wide ones (two warpgroups a q tile) above: "wide
d<=256" for heads of 129-256, then 384, 512 and wider. The wrapper counts
its kernel launches in ``LAUNCHES``, and by the instance that the kernel's
entry point reports it took in ``B6_INSTANCES`` (:func:`b6_instance` names
the instance the dispatch should take, for ``describe`` and the checks).

B7 is the port of ``paged_decode_attn`` of the same JAX module:
:func:`paged_decode_attn` attends one decode token per slot over ONE
layer's page pool through a page table, with the serving step's mask
(key ``r`` valid iff ``r < len`` or ``bucket <= r <= bucket + t``), and
returns the normalised float32 output. Pages are float32, bfloat16 or
int8; int8 pages come with their per-row float32 scale planes, which the
TPU kernel does not have (the JAX step gathers int8 pages and then
dequantizes them with ``decode_rows``): here the read dequantizes each
row by its scale inside B7, so every paged read on a card stays in one
kernel. On CUDA tensors it launches the kernel of
``csrc/paged_attention.cu`` (or raises); on CPU tensors it runs
:func:`paged_decode_attn_plain`, the JAX serving step's gather,
dequantization, mask and softmax line for line, which is also the
kernel's oracle. The kernel reads only the pages that the mask admits
some key of (:func:`paged_live_pages`), in tiles of several pages where
pages fit (:func:`paged_tile_pages`: four pages of 16 int8 rows of 64),
split over :func:`paged_splits` CTAs per (slot, head) in whole tiles
(:func:`paged_split_pages`). Its instances: the tiled ones for heads up
to 256 columns; the wide ones for heads of 257-512 (tiles of 10-12 KB of
rows in dynamic shared memory), of 16-byte vectors or, where the rows are
not whole vectors or the pool is off a 16-byte boundary, one value a lane;
and the column-chunked one above 512. The wrapper counts its launches by
page kind in ``LAUNCHES``, by the instance that the kernel's entry point
reports it took in ``B7_INSTANCES``, and by the CTAs a (slot, head) took
in ``B7_SPLITS``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from multiverso_tpu_torch.ops import _build

NEG_INF = -1e30
BLOCK = 128          # the TPU kernel's tile; Sq and Sk must divide by it
#: B7 only: the widest head of its tiled instances; wider heads take its
#: wide instances up to ``PAGED_MAX_WIDE_DIM``, and its column-chunked one
#: above (``csrc/paged_attention.cu``: the output columns split over CTAs
#: in chunks of ``MAX_HEAD_DIM``). B6's instances have bounds of their
#: own, named by :func:`b6_instance`.
MAX_HEAD_DIM = 256
PAGED_MAX_WIDE_DIM = 512
PAGED_MAX_TICKETS = 1 << 16   # csrc/paged_attention.cu kMaxTickets
#: B7's grid aims at this many CTAs an SM (``paged_splits``).
PAGED_CTAS_PER_SM = 4
#: Bytes of K rows a B7 tile holds (as many of V), and the most rows of an
#: int8 tile (its scales' room): ``csrc/paged_attention.cu`` kTileBytes
#: and kMaxScaleRows.
PAGED_TILE_BYTES = 4096
PAGED_MAX_SCALE_ROWS = 256
#: Bytes of K rows a tile of B7's wide instances holds, by the bytes of a
#: page element (``csrc/paged_attention.cu``'s ``WideRing``): float32
#: 12 KB, bfloat16 and int8 10 KB.
PAGED_WIDE_TILE_BYTES = {4: 12288, 2: 10240, 1: 10240}

#: Kernel launches, counted where the kernel is launched (B7's int8
#: instance apart from its float32 and bfloat16 ones).
LAUNCHES: Dict[str, int] = {"flash_block_attn": 0, "paged_decode_attn": 0,
                            "paged_decode_attn_int8": 0}

#: B6's instances in ``csrc/attention.cu`` (its ``with_instance``): the
#: narrow ones (one warpgroup a q tile, O of 64 NC columns in registers)
#: by the widest head each takes, the wide ones (two warpgroups a q tile,
#: O of 2, 3 or 4 chunks of 64 columns a warpgroup) likewise, Q streamed
#: past 512.
B6_INSTANCE_NAMES = ("narrow d<=64", "narrow d<=128", "wide d<=256",
                     "wide d<=384", "wide d<=512", "wide d>512")
#: B6's launches by the instance that the entry point reports it took
#: (the instance's ``kIndex`` in ``csrc/attention.cu``, an index into
#: ``B6_INSTANCE_NAMES``); each is also counted in
#: ``LAUNCHES["flash_block_attn"]``.
B6_INSTANCES: Dict[str, int] = dict.fromkeys(B6_INSTANCE_NAMES, 0)

#: B7's page types, by the code of their instance in
#: ``csrc/paged_attention.cu``.
PAGE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: B7's instances in ``csrc/paged_attention.cu``: the tiled ones (heads up
#: to ``MAX_HEAD_DIM``, ``paged_decode_kernel``), the wide ones (up to
#: ``PAGED_MAX_WIDE_DIM``, ``paged_wide_kernel``) with rows of 16-byte
#: vectors or one value a lane, and the column-chunked one above
#: (``paged_decode_chunked_kernel``).
B7_INSTANCE_NAMES = ("tiled", "wide d<=512 vec", "wide d<=512 narrow-row",
                     "wide d>512")
#: B7's launches by the instance that served them, float32, bfloat16 and
#: int8 pages alike; each is also counted in ``LAUNCHES`` by page kind.
B7_INSTANCES: Dict[str, int] = dict.fromkeys(B7_INSTANCE_NAMES, 0)
#: B7's launches by the CTAs that took each (slot, head): {splits: count}.
B7_SPLITS: Dict[int, int] = {}

NO_BACKWARD = (
    "flash_block_attn has no backward: the JAX package cannot "
    "differentiate through its pallas_call either, and trains through the "
    "plain block attention. Train with -flash_attention=false.")

Offsets = Union[None, Sequence[int], torch.Tensor]


def supported(q: torch.Tensor, k: torch.Tensor, block_q: int = BLOCK,
              block_k: int = BLOCK) -> bool:
    """The JAX call site's shape gate: the tiles divide and the head dim
    is a multiple of 8."""
    return (q.shape[2] % block_q == 0 and k.shape[2] % block_k == 0
            and q.shape[3] % 8 == 0)


def b6_instance(d: int) -> str:
    """The name of B6's instance that takes heads of width ``d``."""
    chunks = -(-d // 64)
    if chunks <= 2:
        return B6_INSTANCE_NAMES[chunks - 1]
    return B6_INSTANCE_NAMES[2 if chunks <= 4 else 3 if chunks <= 6
                             else 4 if chunks <= 8 else 5]


def _offsets(offsets: Offsets) -> Tuple[int, int]:
    if offsets is None:
        return 0, 0
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()          # one read to the host
    q_off, k_off = (int(x) for x in offsets)
    return q_off, k_off


def causal_mask(sq: int, sk: int, q_off: int, k_off: int,
                device: torch.device) -> torch.Tensor:
    """``[Sq, Sk]`` float32: ``-1e30`` where ``k_pos > q_pos``, else 0."""
    q_pos = q_off + torch.arange(sq, device=device)[:, None]
    k_pos = k_off + torch.arange(sk, device=device)[None, :]
    return torch.where(k_pos > q_pos, NEG_INF, 0.0).to(torch.float32)


def flash_block_attn_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, *,
                           scale: float, causal: bool = False,
                           offsets: Offsets = None):
    """The plain version: ``_block_attn``'s math in float32, the causal
    mask from ``offsets`` added first and ``bias`` after it. ``m`` is
    floored at -1e30, where the kernel's running max starts, so a row whose
    every score lies below it gives the kernel's answer too."""
    q_off, k_off = _offsets(offsets)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        s = s + causal_mask(q.shape[2], k.shape[2], q_off, k_off, q.device)
    if bias is not None:
        s = s + bias.float()
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return o, m, l


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_mv_typed", False):
        c, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.mv_flash_block_attn.argtypes = [
            c, c, c, c, c, c, c, i64, i32, i32, i32, ctypes.c_float, i32,
            i64, i64, i32, c, ctypes.POINTER(ctypes.c_int)]
        lib.mv_flash_block_attn.restype = ctypes.c_int
        lib.mv_flash_block_attn_describe.argtypes = [
            i32, i32, ctypes.POINTER(ctypes.c_int)]
        lib.mv_flash_block_attn_describe.restype = ctypes.c_int
        lib._mv_typed = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, bias) -> bool:
    """Validate; True when the tensors lie on one CUDA device (launch the
    kernel), False when all lie on the CPU (run the plain version)."""
    tensors = [t for t in (q, k, v, bias) if t is not None]
    devs = {t.device for t in tensors}
    on_card = len(devs) == 1 and next(iter(devs)).type == "cuda"
    if not on_card and {d.type for d in devs} != {"cpu"}:
        raise ValueError("flash_block_attn takes tensors on one CUDA device "
                         f"or all on the CPU; got {sorted(map(str, devs))}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_block_attn takes q [B,H,Sq,D] and k, v "
                         f"[B,H,Sk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("flash_block_attn takes q, k, v all float32 or all "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    if sq % BLOCK or sk % BLOCK or d % 8:
        raise ValueError(f"flash_block_attn needs Sq % {BLOCK} == 0, "
                         f"Sk % {BLOCK} == 0 and D % 8 == 0; got Sq={sq}, "
                         f"Sk={sk}, D={d}")
    if bias is not None and tuple(bias.shape) != (sq, sk):
        raise ValueError(f"bias must be [Sq, Sk] = [{sq}, {sk}]; got "
                         f"{tuple(bias.shape)}")
    return on_card


def _launch(q, k, v, bias, scale: float, causal: bool, q_off: int,
            k_off: int):
    B, H, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    o = torch.empty((B, H, sq, d), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, sq, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, sq, 1), dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return o, m, l
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if bias is not None:
        bias = _aligned(bias.to(torch.float32))
    instance = ctypes.c_int(-1)
    err = _lib().mv_flash_block_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), m.data_ptr(), l.data_ptr(), B * H, sq, sk, d,
        float(scale), int(bool(causal)), q_off, k_off,
        int(q.dtype == torch.bfloat16), _build.stream(q),
        ctypes.byref(instance))
    _build.check_launch(err, "flash_block_attn")
    LAUNCHES["flash_block_attn"] += 1
    B6_INSTANCES[B6_INSTANCE_NAMES[instance.value]] += 1
    return o, m, l


def describe(d: int, dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """The launch shape and resources of B6's instance for heads of width
    ``d`` on the current card, as the CUDA runtime reports them: threads
    a CTA, dynamic shared memory bytes, registers and local (spill) bytes
    a thread, CTAs an SM. Card only."""
    out = (ctypes.c_int * 5)()
    _build.check_launch(_lib().mv_flash_block_attn_describe(
        int(d), int(dtype == torch.bfloat16), out), "flash_block_attn")
    keys = ("threads", "smem_bytes", "registers", "local_bytes",
            "ctas_per_sm")
    return {"instance": b6_instance(d), **dict(zip(keys, out))}


class _FlashBlockAttn(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) as an autograd node
    with no backward: the error is raised where a gradient is needed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, q_off, k_off, on_card):
        if on_card:
            return _launch(q, k, v, bias, scale, causal, q_off, k_off)
        return flash_block_attn_plain(q, k, v, bias, scale=scale,
                                      causal=causal, offsets=(q_off, k_off))

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(NO_BACKWARD)


def flash_block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, scale: float,
                     causal: bool = False, offsets: Offsets = None):
    """Streaming-softmax block attention.

    ``q`` [B,H,Sq,D]; ``k``, ``v`` [B,H,Sk,D], all float32 or all bfloat16;
    ``bias`` an optional float32 ``[Sq, Sk]`` additive mask; ``offsets``
    ``(q_off, k_off)``, the global positions of the block's first query
    and key (host ints, or a 2-element tensor read to the host), used by
    ``causal``. Returns float32 ``(o [B,H,Sq,D], m [B,H,Sq,1],
    l [B,H,Sq,1])``, un-normalised. Needs ``Sq % 128 == 0``,
    ``Sk % 128 == 0`` and ``D % 8 == 0`` (the JAX wrapper's assertion)."""
    on_card = _check(q, k, v, bias)
    q_off, k_off = _offsets(offsets)
    return _FlashBlockAttn.apply(q, k, v, bias, float(scale), bool(causal),
                                 q_off, k_off, on_card)


# ---------------------------------------------------------------------------
# B7: paged single-token decode attention.
# ---------------------------------------------------------------------------
def paged_decode_attn_plain(q: torch.Tensor, kp: torch.Tensor,
                            vp: torch.Tensor, ptab: torch.Tensor,
                            lengths: torch.Tensor, t: torch.Tensor, *,
                            bucket: int, page: int, scale: float,
                            ks: Optional[torch.Tensor] = None,
                            vs: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The JAX serving step's read (``serving/continuous.py:442-454,
    472-477``): gather every slot's pages into a ``[B, H, G*P, dh]``
    logical cache (page ids clipped into the pool, as ``mode="clip"``),
    dequantize int8 pages by their gathered scales as ``decode_rows``
    does (``payload.float() * scale``), mask, softmax with ``-inf``,
    product with V. Float32 out."""
    B, H, dh = q.shape
    G = ptab.shape[1]
    idx = ptab.long().clamp(0, kp.shape[0] - 1).reshape(-1)

    def logical(pool, width):
        g = pool.index_select(0, idx).reshape(B, G, H, page, width)
        return g.transpose(1, 2).reshape(B, H, G * page, width)

    def gather(pool, sc):
        g = logical(pool, dh).float()
        return g * logical(sc, 1) if pool.dtype == torch.int8 else g

    kf, vf = gather(kp, ks), gather(vp, vs)
    key_slot = torch.arange(G * page, device=q.device)[None, :]
    lengths = lengths.to(key_slot.dtype)[:, None]
    t = t.to(key_slot.dtype)[:, None]
    mask = (key_slot < lengths) | ((key_slot >= bucket)
                                   & (key_slot <= bucket + t))
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kf) * scale
    probs = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")),
                          dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, vf)


def paged_live_pages(lengths: torch.Tensor, t: torch.Tensor, *,
                     bucket: int, page: int, n_pages: int) -> torch.Tensor:
    """``[B, G]`` bool: the logical pages the kernel reads. Page ``j`` of
    slot ``b`` is live iff ``j*P < lengths[b]`` or ``[j*P, j*P + P - 1]``
    meets ``[bucket, bucket + t[b]]``; every other page holds only keys
    the mask excludes, whose weight is exactly 0. A slot with no live
    page reads all of them (``csrc/paged_attention.cu::live_runs``)."""
    j = torch.arange(n_pages, device=lengths.device)[None, :] * page
    lengths = lengths.long()[:, None]
    hi = bucket + t.long()[:, None]
    live = (j < lengths) | ((j <= hi) & (j + page - 1 >= bucket)
                            & (hi >= bucket))
    return live | ~live.any(dim=1, keepdim=True)


_SMS: Dict[int, int] = {}


def paged_tile_pages(dh: int, elem_bytes: int, page: int) -> int:
    """Whole pages one tile of B7 holds for heads of ``dh`` elements of
    ``elem_bytes`` bytes (``csrc/paged_attention.cu``'s ``launch`` and
    ``launch_wide``). A tiled instance's tile takes up to
    ``PAGED_TILE_BYTES`` of K rows (an int8 tile at most
    ``PAGED_MAX_SCALE_ROWS`` rows), as many whole pages as fit, or one
    page's rows in several tiles where none fits (1); a float32 tile
    stays one page (its instance keeps the single-page code: at dh 64 one
    page of 16 rows already fills a tile). A wide instance's tile takes up
    to ``PAGED_WIDE_TILE_BYTES[elem_bytes]``; the column-chunked
    instance's unit is one page. The kernel splits a slot's
    live pages over CTAs in units of this many pages, so no tile crosses a
    split."""
    if dh > PAGED_MAX_WIDE_DIM:
        return 1
    if dh > MAX_HEAD_DIM:
        return max(1, PAGED_WIDE_TILE_BYTES[elem_bytes]
                   // (page * dh * elem_bytes))
    if elem_bytes >= 4:
        return 1
    rows = max(1, PAGED_TILE_BYTES // (dh * elem_bytes))
    if elem_bytes == 1:
        rows = min(rows, PAGED_MAX_SCALE_ROWS)
    return max(1, rows // page)


def paged_split_pages(n_live: int, tile_pages: int,
                      splits: int) -> list:
    """The live pages ``[p0, p1)`` each of a slot's ``splits`` CTAs takes
    (``csrc/paged_attention.cu``): whole units of ``tile_pages`` live
    pages (a tile where pages fit it; the last unit may be short), split
    as evenly as units allow."""
    units = -(-n_live // tile_pages)
    return [(min(s * units // splits * tile_pages, n_live),
             min((s + 1) * units // splits * tile_pages, n_live))
            for s in range(splits)]


def paged_splits(bh: int, n_units: int, sms: int) -> int:
    """CTAs per (slot, head) of one B7 launch: enough that ``bh`` x splits
    CTAs make ``PAGED_CTAS_PER_SM`` an SM, at most one per unit of work
    the table can hold (``n_units``: its pages, or its tiles of
    :func:`paged_tile_pages` pages; the live count of a slot is known only
    on the card). One where ``bh`` already fills the card or passes the
    kernel's ticket counters. ``bh`` counts the (slot, head) pairs times
    the column chunks of a head wider than ``PAGED_MAX_WIDE_DIM``."""
    if bh > PAGED_MAX_TICKETS:
        return 1
    return max(1, min(n_units, -(-PAGED_CTAS_PER_SM * sms // bh)))


def paged_launch_splits(q: torch.Tensor, kp: torch.Tensor,
                        n_pages: int, page: int, sms: int) -> int:
    """The splits :func:`paged_decode_attn` launches with for these
    inputs: a head wider than ``PAGED_MAX_WIDE_DIM`` splits its columns
    into chunks (the column-chunked instance, whose unit is a page); a
    narrower one splits the table's tiles."""
    B, H, dh = q.shape
    chunks = paged_chunks(dh)
    tp = paged_tile_pages(dh, kp.element_size(), page)
    return paged_splits(B * H * chunks, -(-n_pages // tp), sms)


def paged_chunks(dh: int) -> int:
    """The column chunks of a B7 launch: ``ceil(dh / MAX_HEAD_DIM)`` for
    the column-chunked instance (heads wider than ``PAGED_MAX_WIDE_DIM``),
    else 1. A split's merge scratch is ``dh + 2 * chunks`` floats."""
    return -(-dh // MAX_HEAD_DIM) if dh > PAGED_MAX_WIDE_DIM else 1


def b7_instance(dh: int, vec: bool = True) -> str:
    """The name of B7's instance that takes heads of width ``dh``, with
    rows of 16-byte vectors on 16-byte boundaries (``vec``) or not. A
    launch is counted under the instance its entry point reports."""
    if dh <= MAX_HEAD_DIM:
        return B7_INSTANCE_NAMES[0]
    if dh > PAGED_MAX_WIDE_DIM:
        return B7_INSTANCE_NAMES[3]
    return B7_INSTANCE_NAMES[1 if vec else 2]


def _sm_count(dev: torch.device) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _paged_lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_mv_typed", False):
        c, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.mv_paged_decode_attn.argtypes = [
            c, c, c, c, c, c, c, c, c, c, i32, i32, i32, i32, i32, i64, i64,
            i32, i32, ctypes.c_float, i32, i32, c,
            ctypes.POINTER(ctypes.c_int)]
        lib.mv_paged_decode_attn.restype = ctypes.c_int
        lib.mv_paged_decode_describe.argtypes = [
            i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        lib.mv_paged_decode_describe.restype = ctypes.c_int
        lib._mv_typed = True
    return lib


def paged_describe(dh: int, dtype: torch.dtype = torch.float32,
                   vec: bool = True) -> Dict[str, int]:
    """The launch shape and resources of B7's wide instance for heads of
    width ``dh`` (257-512) and pages of ``dtype`` on the current card, as
    the CUDA runtime reports them: threads a CTA, shared memory bytes a
    CTA (dynamic and static), registers and local (spill) bytes a thread,
    CTAs an SM. Card only."""
    out = (ctypes.c_int * 5)()
    _build.check_launch(_paged_lib().mv_paged_decode_describe(
        int(dh), PAGE_KINDS[dtype], int(bool(vec)), out),
        "paged_decode_attn")
    keys = ("threads", "smem_bytes", "registers", "local_bytes",
            "ctas_per_sm")
    return {"instance": b7_instance(dh, vec), **dict(zip(keys, out))}


def _check_paged(q, kp, vp, ptab, lengths, t, page: int, ks, vs) -> bool:
    """Validate; True when the tensors lie on one CUDA device (launch the
    kernel), False when all lie on the CPU (run the plain version). Every
    test reads tensor attributes directly: this runs on every decode step
    of every layer."""
    dev = q.device
    quant = kp.dtype == torch.int8
    scales = (ks, vs) if quant else ()
    if not (kp.device == dev and vp.device == dev and ptab.device == dev
            and lengths.device == dev and t.device == dev
            and all(x is not None and x.device == dev for x in scales)) \
            or dev.type not in ("cuda", "cpu"):
        devs = {str(x.device) if x is not None else "None"
                for x in (q, kp, vp, ptab, lengths, t, *scales)}
        raise ValueError("paged_decode_attn takes tensors on one CUDA "
                         "device or all on the CPU (int8 pages with their "
                         f"scale planes ks, vs); got {sorted(devs)}")
    qs, kshape = q.shape, kp.shape
    if len(qs) != 3 or len(kshape) != 4 or vp.shape != kshape or \
            kshape[1] != qs[1] or kshape[3] != qs[2] or kshape[2] != page:
        raise ValueError(
            "paged_decode_attn takes q [B,H,dh] and kp, vp [n_phys,H,page,"
            f"dh] with page={page}; got {tuple(qs)}, {tuple(kshape)}, "
            f"{tuple(vp.shape)}")
    sshape = kshape[:3] + (1,)
    for x in scales:
        if x.shape != sshape or x.dtype != torch.float32:
            raise ValueError(
                f"paged_decode_attn takes int8 pages' scales ks, vs "
                f"{tuple(sshape)} float32; got {tuple(x.shape)} {x.dtype}")
    B = qs[0]
    if ptab.dim() != 2 or ptab.shape[0] != B or lengths.shape != (B,) or \
            t.shape != (B,):
        raise ValueError(
            f"paged_decode_attn takes ptab [B,G] and lengths, t [B] with "
            f"B={B}; got {tuple(ptab.shape)}, {tuple(lengths.shape)}, "
            f"{tuple(t.shape)}")
    if q.dtype != torch.float32 or kp.dtype != vp.dtype or \
            kp.dtype not in PAGE_KINDS:
        raise ValueError("paged_decode_attn takes float32 q and float32, "
                         f"bfloat16 or int8 pages; got {q.dtype}, "
                         f"{kp.dtype}, {vp.dtype}")
    for x in (ptab, lengths, t):
        if x.dtype.is_floating_point or x.dtype == torch.bool:
            raise ValueError("ptab, lengths and t must be integer tensors")
    if dev.type == "cpu":
        return False
    dh = qs[2]
    stride = kp.stride()
    if stride[1:] != (page * dh, dh, 1) or stride != vp.stride():
        raise ValueError(
            "paged_decode_attn on a card needs each page's [H, page, "
            "dh] block contiguous and kp, vp with equal strides; got "
            f"{stride}, {vp.stride()}")
    if quant and (ks.stride()[1:3] != (page, 1)
                  or ks.stride()[:3] != vs.stride()[:3]):
        raise ValueError(
            "paged_decode_attn on a card needs each page's [H, page, 1] "
            "scale block contiguous and ks, vs with equal strides; got "
            f"{ks.stride()}, {vs.stride()}")
    return True


# Scratch of the split launches' partials, one buffer per card, grown as
# needed. Launches on one card run in stream order (the serving path has
# one stream), so one buffer serves them all, as one set of ticket
# counters does in the kernel. An outgrown buffer is kept: a CUDA graph
# captured with it may still replay.
_SCRATCH: Dict[int, torch.Tensor] = {}
_SCRATCH_KEPT = []


def _paged_scratch(dev: torch.device, n: int) -> int:
    buf = _SCRATCH.get(dev.index)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _SCRATCH_KEPT.append(buf)
        buf = _SCRATCH[dev.index] = torch.empty(n, dtype=torch.float32,
                                                device=dev)
    return buf.data_ptr()


def _int32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def _launch_paged(q, kp, vp, ptab, lengths, t, bucket: int, page: int,
                  scale: float, ks, vs) -> torch.Tensor:
    B, H, dh = q.shape
    G = ptab.shape[1]
    dev = q.device
    o = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    if B * H * dh == 0:
        return o
    splits = paged_launch_splits(q, kp, G, page, _sm_count(dev))
    part = (_paged_scratch(dev, B * H * splits * (dh + 2 * paged_chunks(dh)))
            if splits > 1 else None)
    if not q.is_contiguous():
        q = q.contiguous()
    ptab, lengths, t = _int32(ptab), _int32(lengths), _int32(t)
    kind = PAGE_KINDS[kp.dtype]
    quant = kind == PAGE_KINDS[torch.int8]
    instance = ctypes.c_int(-1)
    err = _paged_lib().mv_paged_decode_attn(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        ptab.data_ptr(), lengths.data_ptr(), t.data_ptr(), o.data_ptr(),
        part, B, H, G, page, dh, kp.stride(0),
        ks.stride(0) if quant else 0, kp.shape[0], int(bucket),
        float(scale), kind, splits, _build.stream(q), ctypes.byref(instance))
    _build.check_launch(err, "paged_decode_attn")
    LAUNCHES["paged_decode_attn_int8" if quant else "paged_decode_attn"] += 1
    B7_INSTANCES[B7_INSTANCE_NAMES[instance.value]] += 1
    B7_SPLITS[splits] = B7_SPLITS.get(splits, 0) + 1
    return o


def paged_decode_attn(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      ptab: torch.Tensor, lengths: torch.Tensor,
                      t: torch.Tensor, *, bucket: int, page: int,
                      scale: float, ks: Optional[torch.Tensor] = None,
                      vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step of attention over paged KV storage.

    ``q`` [B, H, dh] float32, this step's queries (one token per slot);
    ``kp``/``vp`` [n_phys, H, page, dh] float32, bfloat16 or int8, ONE
    layer of the pool (``pool.kp[:, i]``: a strided view, each page's
    block contiguous); ``ks``/``vs`` [n_phys, H, page, 1] float32, the
    same layer's scale planes (``pool.ks[:, i]``), read for int8 pages
    only (each row dequantized as ``float(k8) * scale``); ``ptab`` [B, G]
    the logical-to-physical page table; ``lengths``/``t`` [B] the prompt
    lengths and per-slot step counters. Returns the normalised attention
    output [B, H, dh] float32: a softmax over each slot's valid keys
    (prompt, then generated so far)."""
    if _check_paged(q, kp, vp, ptab, lengths, t, page, ks, vs):
        return _launch_paged(q, kp, vp, ptab, lengths, t, bucket, page,
                             scale, ks, vs)
    return paged_decode_attn_plain(q, kp, vp, ptab, lengths, t,
                                   bucket=bucket, page=page, scale=scale,
                                   ks=ks, vs=vs)
