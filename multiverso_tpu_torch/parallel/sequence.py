"""Sequence parallelism: causal ring attention and Ulysses attention.

Port of ``multiverso_tpu/parallel/sequence.py``. The JAX package runs both
as ``shard_map`` programs over a ``"seq"`` mesh axis: ring attention
rotates K/V shards around the ring (``ppermute``) and merges each step's
streaming-softmax block, Ulysses swaps sequence-sharded activations to
head-sharded ones with two ``all_to_all`` hops.

Here the sequence group is a ``torch.distributed`` process group (the
``"seq"`` axis of ``parallel/mesh.py``'s rank mesh), one rank a sequence
block, and each function takes and returns this rank's block. The ring's
rotation is :func:`~multiverso_tpu_torch.parallel.collectives.ring_shift`
of K and V packed into one tensor (one exchange a ring step); Ulysses'
swaps are :func:`~multiverso_tpu_torch.parallel.collectives.all_to_all`.
Both are differentiable, so training runs through them. ``group=None`` is
this rank alone (every rotation and swap the identity).

``-flash_attention`` (default false, as in the JAX package) routes the
ring's local block step and Ulysses' attention through B6
(``ops/attention.py``) when the shapes pass the kernel's gate; B6 has no
backward, as in the JAX package. With the flag off the ring's block step
is B6's plain version, the JAX package's ``_block_attn`` math, which
autograd differentiates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch.ops.attention import (flash_block_attn,
                                                flash_block_attn_plain)
from multiverso_tpu_torch.parallel.collectives import (all_to_all,
                                                       group_rank_size,
                                                       ring_shift)


def _group(group):
    """(rank, size) of the sequence group: ``None`` is this rank alone;
    a group of more than one rank needs a ``torch.distributed`` world."""
    if group is None:
        return 0, 1
    n = int(group.size())
    if n > 1 and not (torch.distributed.is_available()
                      and torch.distributed.is_initialized()):
        raise RuntimeError(
            f"a sequence group of {n} ranks needs a torch.distributed "
            "process group (mv.init with -coordinator)")
    return (group_rank_size(group) if n > 1 else (0, 1))


def _resolve_flash(use_flash, sq: int, sk: int, d: int) -> bool:
    """The one flash-kernel gate: the flag (read when ``use_flash`` is
    None) and the kernel's tile shapes."""
    if use_flash is None:
        from multiverso_tpu_torch.utils.configure import get_flag
        use_flash = get_flag("flash_attention")
    return bool(use_flash) and sq % 128 == 0 and sk % 128 == 0 and d % 8 == 0


def ring_attention_block(q_blk: torch.Tensor, k_blk: torch.Tensor,
                         v_blk: torch.Tensor, rank: int, n: int,
                         causal: bool = False,
                         use_flash: Optional[bool] = None,
                         group=None) -> torch.Tensor:
    """The per-rank ring-attention body. ``q_blk/k_blk/v_blk``: this
    rank's [B, H, S/n, D] sequence block, ``rank`` its index in ``group``
    (the ring of ``n`` ranks; ``None`` with ``n`` 1). ``use_flash`` routes
    the local block step through B6; ``None`` reads the
    ``-flash_attention`` flag."""
    if n > 1 and group is None:
        raise RuntimeError(f"a ring of {n} ranks needs its process group")
    use_flash = _resolve_flash(use_flash, q_blk.shape[2], k_blk.shape[2],
                               q_blk.shape[3])
    scale = 1.0 / np.sqrt(q_blk.shape[-1])
    B, H, Sq, D = q_blk.shape
    o_acc = torch.zeros((B, H, Sq, D), dtype=q_blk.dtype,
                        device=q_blk.device)
    m_acc = torch.full((B, H, Sq, 1), -float("inf"), dtype=q_blk.dtype,
                       device=q_blk.device)
    l_acc = torch.zeros((B, H, Sq, 1), dtype=q_blk.dtype,
                        device=q_blk.device)
    # The causal mask adds -1e30 from the blocks' global offsets: finite
    # (not -inf), since a fully masked row would otherwise give
    # exp(-inf - -inf) = nan; -1e30 underflows cleanly and the merge's
    # beta zeroes the block.
    block_attn = flash_block_attn if use_flash else flash_block_attn_plain
    kv = torch.stack([k_blk, v_blk]) if n > 1 else None
    k_cur, v_cur = k_blk, v_blk
    for step in range(n):
        # After `step` rotations this rank holds the K/V block that
        # started on rank (rank - step) mod n.
        k_blk_idx = (rank - step) % n
        o, m, l = block_attn(q_blk, k_cur, v_cur, scale=float(scale),
                             causal=causal,
                             offsets=(rank * Sq, k_blk_idx * Sq))
        o, m, l = (t.to(q_blk.dtype) for t in (o, m, l))
        m_new = torch.maximum(m_acc, m)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m - m_new)
        o_acc = o_acc * alpha + o * beta
        l_acc = l_acc * alpha + l * beta
        m_acc = m_new
        # K and V travel as one tensor, one exchange a step. The JAX scan
        # also rotates after the last step; that block is never read, so
        # it is not sent.
        if step + 1 < n:
            kv = ring_shift(kv, group)
            k_cur, v_cur = kv[0], kv[1]
    return o_acc / torch.clamp(l_acc, min=1e-20)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False) -> torch.Tensor:
    """Attention over a sequence split across the ranks of ``group``
    (``None``: this rank alone). Inputs are this rank's [B, H, S/n, D]
    block; each of the n steps attends the local queries against the K/V
    block held, then rotates K/V one rank around the ring, with the
    streaming-softmax merge keeping exact softmax semantics. With
    ``causal`` the global position mask comes from the block indices."""
    rank, n = _group(group)
    use_flash = _resolve_flash(None, q.shape[2], k.shape[2], q.shape[3])
    return ring_attention_block(q, k, v, rank, n, causal=causal,
                                use_flash=use_flash,
                                group=group if n > 1 else None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism (the Ulysses layout swap): this
    rank's [B, H, S/n, D] blocks become head-split full sequences
    [B, H/n, S, D] (H must divide by n), dense attention runs on them
    (the causal mask is the plain lower triangle) and the result is
    swapped back. With one rank both swaps are the identity."""
    _, n = _group(group)
    grp = group if n > 1 else None
    if q.shape[1] % n:
        raise ValueError(f"Ulysses attention splits {q.shape[1]} heads "
                         f"over {n} ranks")

    def seq_to_head(x):                    # [B,H,S/n,D] -> [B,H/n,S,D]
        return all_to_all(x, grp, split_dim=1, concat_dim=2)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    scale = 1.0 / np.sqrt(q.shape[-1])
    S = qh.shape[2]
    if _resolve_flash(None, S, S, q.shape[3]):
        # Causal mask computed in the kernel (offsets zero: full sequence).
        o, _, l = flash_block_attn(qh, kh, vh, scale=float(scale),
                                   causal=causal)
        o = (o / torch.clamp(l, min=1e-20)).to(q.dtype)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                         device=q.device))
            s = torch.where(mask[None, None], s,
                            torch.tensor(torch.finfo(s.dtype).min,
                                         dtype=s.dtype, device=s.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return all_to_all(o, grp, split_dim=2, concat_dim=1)


def reference_attention(q, k, v):
    """Dense single-device reference for testing."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
