"""Decoder-only LM over causal ring (or Ulysses) attention.

Port of ``multiverso_tpu/models/attention_lm.py`` (the flat, non-pipelined
model). The block is the JAX package's own: no biases, LayerNorm without
affine parameters, sinusoidal positions, a tanh-GELU MLP of 4 x dim (or
the top-1 MoE block of ``parallel/expert.py``), and attention through
``parallel/sequence.py``, whose local block step runs B6
(``ops/attention.py``) when ``-flash_attention`` is on.

Parameters keep the JAX names and the JAX ``[in, out]`` layout
(``x @ W``), so ``interop.load_attention_lm_params`` carries them over
as they are. Training is Adam with optax's constants. This slice runs the
sequence on ONE rank, the card: ``seq_parallel > 1``, ``data_parallel >
1`` and the 1F1B pipeline (``pipeline_stages > 0``) raise
``NotImplementedError`` naming their ROADMAP items, and so does the
gradient through B6, which the JAX package does not have either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.parallel.expert import MoEParams, init_moe, top1_moe
from multiverso_tpu_torch.parallel.sequence import (ring_attention,
                                                    ulysses_attention)
from multiverso_tpu_torch.utils.configure import get_flag
from multiverso_tpu_torch.utils.log import check

Params = Dict[str, torch.Tensor]

# optax.adam's defaults (b1, b2, eps).
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class LMConfig:
    vocab: int = 256
    dim: int = 64
    heads: int = 4
    layers: int = 2
    seq: int = 128
    learning_rate: float = 1e-3
    data_parallel: Optional[int] = None   # None -> 1 (one card)
    seq_parallel: Optional[int] = None
    moe_experts: int = 0                  # >0: MoE MLP
    moe_aux_weight: float = 0.01
    # "ring": streaming-softmax K/V ring (default); "ulysses": the
    # all-to-all head<->seq layout swap, dense attention per head.
    sp_mode: str = "ring"
    remat: bool = False                   # recompute each layer block
    # >0: the 1F1B layer pipeline (not ported: ROADMAP A10, which adds
    # pipeline_microbatches with it).
    pipeline_stages: int = 0
    seed: int = 0


def init_params(cfg: LMConfig, device: Optional[torch.device] = None
                ) -> Params:
    """Normal weights scaled by ``dim ** -0.5``, drawn in a fixed order
    from a CPU ``torch.Generator`` seeded with ``cfg.seed`` (so a seed
    gives the same weights on any device)."""
    g = torch.Generator().manual_seed(cfg.seed)
    scale = cfg.dim ** -0.5

    def normal(*shape):
        return (torch.randn(shape, generator=g) * scale).to(device)

    params: Params = {"embed": normal(cfg.vocab, cfg.dim),
                      "out": normal(cfg.dim, cfg.vocab)}
    for i in range(cfg.layers):
        params[f"qkv_{i}"] = normal(cfg.dim, 3 * cfg.dim)
        params[f"attn_out_{i}"] = normal(cfg.dim, cfg.dim)
        if cfg.moe_experts > 0:
            moe = init_moe(g, cfg.dim, 4 * cfg.dim, cfg.moe_experts, device)
            params[f"moe_router_{i}"] = moe.router
            params[f"moe_w1_{i}"] = moe.w1
            params[f"moe_w2_{i}"] = moe.w2
        else:
            params[f"mlp_in_{i}"] = normal(cfg.dim, 4 * cfg.dim)
            params[f"mlp_out_{i}"] = normal(4 * cfg.dim, cfg.dim)
    return params


def dense_param_shapes(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the flat dense layout's parameters (the ones
    :func:`init_params` draws without MoE), without drawing them."""
    shapes = {"embed": (cfg.vocab, cfg.dim), "out": (cfg.dim, cfg.vocab)}
    for i in range(cfg.layers):
        shapes[f"qkv_{i}"] = (cfg.dim, 3 * cfg.dim)
        shapes[f"attn_out_{i}"] = (cfg.dim, cfg.dim)
        shapes[f"mlp_in_{i}"] = (cfg.dim, 4 * cfg.dim)
        shapes[f"mlp_out_{i}"] = (4 * cfg.dim, cfg.dim)
    return shapes


def _ln(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def _posenc(S: int, D: int, device=None) -> torch.Tensor:
    """The JAX package's table as written: ``pos / 10000 ** (j / D)``
    (not ``2j / D``), sin on even and cos on odd columns, float32."""
    j = torch.arange(D, dtype=torch.float32, device=device)
    pos = (torch.arange(S, dtype=torch.float32, device=device)[:, None]
           / torch.pow(10000.0, j[None, :] / D))
    return torch.where(j[None, :].long() % 2 == 0, torch.sin(pos),
                       torch.cos(pos))


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab], moe aux loss). ``group``
    is the sequence group (``None``: this rank alone)."""
    B, S = tokens.shape
    H, D = cfg.heads, cfg.dim
    dh = D // H
    x = params["embed"][tokens] + _posenc(S, D, tokens.device)[None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    attn = ulysses_attention if cfg.sp_mode == "ulysses" else ring_attention

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    def layer_block(x, i):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = _ln(x)
        q, k, v = torch.split(h @ params[f"qkv_{i}"], D, dim=-1)
        o = attn(heads(q), heads(k), heads(v), group,
                 causal=True)                                 # [B,H,S,dh]
        o = o.transpose(1, 2).reshape(B, S, D)
        x = x + o @ params[f"attn_out_{i}"]
        h = _ln(x)
        if cfg.moe_experts > 0:
            moe = MoEParams(params[f"moe_router_{i}"],
                            params[f"moe_w1_{i}"], params[f"moe_w2_{i}"])
            y, aux = top1_moe(moe, h)
            x = x + y
        else:
            x = x + F.gelu(h @ params[f"mlp_in_{i}"],
                           approximate="tanh") @ params[f"mlp_out_{i}"]
        return x, aux

    for i in range(cfg.layers):
        if cfg.remat:
            x, aux = checkpoint(layer_block, x, i, use_reentrant=False)
        else:
            x, aux = layer_block(x, i)
        aux_total = aux_total + aux
    return _ln(x) @ params["out"], aux_total


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                    group=None) -> torch.Tensor:
    logits, aux = forward(params, tokens, cfg, group)
    logp = torch.log_softmax(logits, dim=-1)
    # predict token[t+1] from position t; the wrap-around position masked
    targets = torch.roll(tokens, -1, dims=1)
    picked = torch.gather(logp, -1, targets[..., None])[..., 0]
    S = tokens.shape[1]
    valid = (torch.arange(S, device=tokens.device) < S - 1) \
        .to(picked.dtype)[None, :]
    xent = -(picked * valid).sum() / valid.sum() / tokens.shape[0]
    return xent + cfg.moe_aux_weight * aux


class AttentionLM(nn.Module):
    """The LM on one device: ``fit`` trains on batches of int tokens
    [B, S] and ``loss`` evaluates one. The device is the card unless
    ``device`` (or ``-platform=cpu``) says otherwise."""

    def __init__(self, cfg: LMConfig, device: Optional[torch.device] = None):
        super().__init__()
        check(cfg.dim % cfg.heads == 0, "dim must divide by heads")
        if cfg.pipeline_stages > 0:
            raise NotImplementedError(
                "the 1F1B layer pipeline (pipeline_stages > 0) is not "
                "ported yet: ROADMAP A10 (parallel/pipeline.py)")
        for name in ("seq_parallel", "data_parallel"):
            if (getattr(cfg, name) or 1) > 1:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)}: this slice runs the LM on "
                    "one rank; sequence and data parallelism over "
                    "torch.distributed wait for ROADMAP A7/A10")
        check(cfg.sp_mode in ("ring", "ulysses"),
              f"unknown sp_mode {cfg.sp_mode!r} (want ring or ulysses)")
        self.cfg = cfg
        self.device = resolve_device(get_flag("platform"), device)
        for name, value in init_params(cfg, self.device).items():
            self.register_parameter(name, nn.Parameter(value))
        self._opt = torch.optim.Adam(self.parameters(),
                                     lr=cfg.learning_rate, betas=ADAM_BETAS,
                                     eps=ADAM_EPS)

    @property
    def params(self) -> Params:
        return dict(self.named_parameters())

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                               device=self.device)

    def fit(self, batches: Iterable[np.ndarray]) -> List[float]:
        """One Adam step per batch of int tokens [B, S]; returns the
        per-batch losses, read to the host once, after the last step."""
        losses = []
        for tokens in batches:
            loss = next_token_loss(self.params, self._tokens(tokens),
                                   self.cfg)
            self._opt.zero_grad(set_to_none=True)
            loss.backward()
            self._opt.step()
            losses.append(loss.detach())
        if not losses:
            return []
        return [float(x) for x in torch.stack(losses).cpu()]

    def loss(self, tokens: np.ndarray) -> float:
        with torch.no_grad():
            return float(next_token_loss(self.params, self._tokens(tokens),
                                         self.cfg))
