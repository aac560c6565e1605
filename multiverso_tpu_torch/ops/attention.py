"""Flash block attention (B6): the local block step of ring and Ulysses
attention.

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
wrapper counts its kernel launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from multiverso_tpu_torch.ops import _build

NEG_INF = -1e30
BLOCK = 128          # the TPU kernel's tile; Sq and Sk must divide by it
MAX_HEAD_DIM = 256   # csrc/attention.cu kMaxD

#: Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"flash_block_attn": 0}

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
            i64, i64, i32, c]
        lib.mv_flash_block_attn.restype = ctypes.c_int
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
    if on_card and d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_block_attn on a card takes D <= {MAX_HEAD_DIM}; got "
            f"D={d} (ROADMAP B6)")
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
    err = _lib().mv_flash_block_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), m.data_ptr(), l.data_ptr(), B * H, sq, sk, d,
        float(scale), int(bool(causal)), q_off, k_off,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "flash_block_attn")
    LAUNCHES["flash_block_attn"] += 1
    return o, m, l


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
    ``Sk % 128 == 0`` and ``D % 8 == 0`` (the JAX wrapper's assertion);
    on a card also ``D <= 256``."""
    on_card = _check(q, k, v, bias)
    q_off, k_off = _offsets(offsets)
    return _FlashBlockAttn.apply(q, k, v, bias, float(scale), bool(causal),
                                 q_off, k_off, on_card)
