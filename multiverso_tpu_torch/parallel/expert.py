"""Expert parallelism: the top-1 routed MoE block.

Port of ``multiverso_tpu/parallel/expert.py``: the capacity-bounded
dense-dispatch formulation. Tokens are routed top-1, each expert takes at
most ``capacity`` tokens (overflow drops), and dispatch and combine are
one-hot einsums. The JAX package shards the expert weights over the mesh's
``"expert"`` axis; here the weights live whole on each rank's device
(sharding them over cards is ROADMAP A10's sharded-state half).

Under the long-context LM's data x sequence parallelism each rank holds
a block of the ``[B, S]`` tokens (a :class:`TokenShard`), and
:func:`top1_moe` gives the JAX package's global-view result: the
capacity and each token's slot in its expert's queue follow the whole
batch's token order, so each rank adds the per-expert counts of the
tokens before its block (an exclusive prefix over an all-gather of every
block's per-row counts), and the load-balancing term uses the global
means.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch.parallel.collectives import (all_gather_cat,
                                                       group_sum)


@dataclasses.dataclass
class TokenShard:
    """Where this rank's block of a ``[B, S]`` batch sits: batch slice
    ``data_index`` of ``data_parallel`` and sequence block ``seq_index``
    of ``seq_parallel``, on a mesh laid out row-major as
    ``data:dp,seq:sp`` (mesh rank ``data_index * sp + seq_index``).
    ``group`` spans every rank of the mesh, ``seq_group`` this rank's
    sequence axis (None: one rank)."""
    data_index: int = 0
    data_parallel: int = 1
    seq_index: int = 0
    seq_parallel: int = 1
    group: object = None
    seq_group: object = None

    @property
    def ranks(self) -> int:
        return self.data_parallel * self.seq_parallel


@dataclasses.dataclass
class MoEParams:
    router: torch.Tensor   # [D, E]
    w1: torch.Tensor       # [E, D, H]
    w2: torch.Tensor       # [E, H, D]


def init_moe(generator: torch.Generator, dim: int, hidden: int,
             num_experts: int,
             device: Optional[torch.device] = None) -> MoEParams:
    """Normal weights scaled by ``dim ** -0.5``, drawn from ``generator``
    (a CPU generator, so a seed gives the same weights on any device)."""
    scale = dim ** -0.5

    def normal(*shape):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    router = normal(dim, num_experts)
    w1 = normal(num_experts, dim, hidden)
    w2 = normal(num_experts, hidden, dim)
    return MoEParams(router, w1, w2)


def _queue_positions(onehot: torch.Tensor, B: int, S: int,
                     shard: TokenShard) -> torch.Tensor:
    """[T, E]: each local token's place in its expert's queue over the
    whole batch in [B, S] order (0 where it is not routed): the tokens of
    the batch rows before this block's, and of this row's earlier
    sequence blocks, come first."""
    E = onehot.shape[1]
    dp, sp = shard.data_parallel, shard.seq_parallel
    per_row = onehot.reshape(B, S, E)
    counts = all_gather_cat(per_row.sum(dim=1)[None], shard.group)
    # [dp, sp, B, E] by mesh rank -> [dp, B, sp, E]: the batch's (row,
    # block) order.
    order = counts.reshape(dp, sp, B, E).transpose(1, 2).reshape(-1, E)
    before = torch.cumsum(order, dim=0) - order                   # exclusive
    mine = before.reshape(dp, B, sp, E)[shard.data_index, :,
                                        shard.seq_index]          # [B, E]
    inside = torch.cumsum(per_row, dim=1) - per_row               # [B, S, E]
    return ((mine[:, None, :] + inside) * per_row).reshape(B * S, E)


def top1_moe(params: MoEParams, x: torch.Tensor,
             capacity_factor: float = 1.25,
             shard: Optional[TokenShard] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss).

    aux_loss is the standard load-balancing term (mean fraction * mean
    router prob per expert, scaled by E). With a ``shard`` of several
    ranks, ``x`` is this rank's block of the batch and both are the
    whole batch's (the aux term the same on every rank; its sums pass
    their gradient to each rank's own share)."""
    B, S, D = x.shape
    E = params.router.shape[1]
    T = B * S
    n = shard.ranks if shard is not None else 1
    xt = x.reshape(T, D)
    logits = xt @ params.router                                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                         # [T]
    gate = probs.amax(dim=-1)                                    # [T]

    capacity = max(int(capacity_factor * T * n / E), 1)
    onehot = F.one_hot(expert, E).to(x.dtype)                    # [T, E]
    # position of each token within its expert's queue
    if n == 1:
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot       # [T, E]
    else:
        pos = _queue_positions(onehot, B, S, shard)
    keep = (pos < capacity).to(x.dtype) * onehot
    # jax.nn.one_hot gives a zero row for pos >= capacity, where
    # F.one_hot raises: clamp, and let `keep` zero those rows.
    slot = F.one_hot(pos.long().clamp(0, capacity - 1),
                     capacity).to(x.dtype) * keep[..., None]     # [T,E,C]

    expert_in = torch.einsum("tec,td->ecd", slot, xt)            # [E,C,D]
    h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, params.w1),
               approximate="tanh")
    expert_out = torch.einsum("ech,ehd->ecd", h, params.w2)      # [E,C,D]
    y = torch.einsum("tec,ecd->td", slot, expert_out) * gate[:, None]

    # load-balancing auxiliary (Shazeer-style)
    if n == 1:
        frac_tokens = onehot.mean(dim=0)                         # [E]
        frac_probs = probs.mean(dim=0)                           # [E]
    else:
        frac_tokens = group_sum(onehot.sum(dim=0), shard.group) / (T * n)
        frac_probs = group_sum(probs.sum(dim=0), shard.group) / (T * n)
    aux = (frac_tokens * frac_probs).sum() * E
    return y.reshape(B, S, D), aux


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def reference_top1_moe(params: MoEParams, x,
                       capacity_factor: float = 1.25) -> np.ndarray:
    """Per-token loop reference (numpy) for testing."""
    xt = _np(x)
    B, S, D = xt.shape
    router = _np(params.router)
    E = router.shape[1]
    T = B * S
    xt = xt.reshape(T, D)
    logits = xt @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    expert = probs.argmax(-1)
    gate = probs.max(-1)
    capacity = max(int(capacity_factor * T / E), 1)
    counts = np.zeros(E, dtype=int)
    out = np.zeros_like(xt)
    w1 = _np(params.w1)
    w2 = _np(params.w2)

    def gelu(v):
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))

    for t in range(T):
        e = expert[t]
        if counts[e] >= capacity:
            continue                     # dropped token
        counts[e] += 1
        h = gelu(xt[t] @ w1[e])
        out[t] = (h @ w2[e]) * gate[t]
    return out.reshape(B, S, D)
