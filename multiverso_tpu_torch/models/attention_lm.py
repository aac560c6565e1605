"""Decoder-only LM over causal ring (or Ulysses) attention, across ranks.

Port of ``multiverso_tpu/models/attention_lm.py``. The block is the JAX
package's own: no biases, LayerNorm without affine parameters, sinusoidal
positions, a tanh-GELU MLP of 4 x dim (or the top-1 MoE block of
``parallel/expert.py``), and attention through ``parallel/sequence.py``,
whose local block step runs B6 (``ops/attention.py``) when
``-flash_attention`` is on.

The LM shards the sequence over ranks, as the JAX model shards it over
devices: ``AttentionLM(cfg, mesh=...)`` takes a rank mesh
(``parallel/mesh.py``, ``build_lm_mesh``) with the axes
``("data", "seq")``: each rank takes batch slice ``data_index`` and
sequence block ``seq_index`` of every ``[B, S]`` batch (which every rank
is given whole), attention runs over the ``"seq"`` group (the ring's K/V
rotation or Ulysses' swaps), the loss is summed over the mesh, and the
gradients are summed over it before each Adam step, so every rank's
parameters stay equal. With ``pipeline_stages > 0`` the mesh's axes are
``("stage", "seq")`` and training runs the 1F1B layer pipeline of
``parallel/pipeline.py`` (PP x SP): stage-stacked parameters
(:func:`init_pipeline_params`), each stage a rank of the ``"stage"``
axis whose blocks run the ring over its ``"seq"`` group. Without a mesh
the LM runs on this rank alone.

Parameters keep the JAX names and the JAX ``[in, out]`` layout
(``x @ W``), so ``interop.load_attention_lm_params`` carries them over
as they are, flat or stage-stacked. Training is Adam with optax's
constants. The gradient through B6 raises ``NotImplementedError``, which
the JAX package does not have either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiverso_tpu_torch.parallel.collectives import (allreduce_sum_many,
                                                       group_sum)
from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.parallel.expert import (MoEParams, TokenShard,
                                                  init_moe, top1_moe)
from multiverso_tpu_torch.parallel.mesh import (DATA_AXIS, SEQ_AXIS,
                                                STAGE_AXIS, lm_axes)
from multiverso_tpu_torch.parallel.sequence import (ring_attention,
                                                    ring_attention_block,
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
    data_parallel: Optional[int] = None   # None -> from the mesh's ranks
    seq_parallel: Optional[int] = None
    moe_experts: int = 0                  # >0: MoE MLP
    moe_aux_weight: float = 0.01
    # "ring": streaming-softmax K/V ring (default); "ulysses": the
    # all-to-all head<->seq layout swap, dense attention per head.
    sp_mode: str = "ring"
    remat: bool = False                   # recompute each layer block
    # >0: train with the 1F1B layer pipeline over a ("stage", "seq") mesh
    # (PP x SP); layers must divide by it. Batches fed to fit() are split
    # into `pipeline_microbatches` microbatches.
    pipeline_stages: int = 0
    pipeline_microbatches: int = 4
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


def _attention(cfg: LMConfig, q, k, v, shard: Optional[TokenShard]):
    group = shard.seq_group if shard is not None else None
    attn = ulysses_attention if cfg.sp_mode == "ulysses" else ring_attention
    return attn(q, k, v, group, causal=True)


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            shard: Optional[TokenShard] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab], moe aux loss). With a
    ``shard`` of several ranks, ``tokens`` is this rank's block of the
    batch (its rows and sequence block), positions are the block's global
    ones, attention runs over the shard's sequence group and the MoE
    block takes the whole batch's view; the logits are the block's."""
    B, Sb = tokens.shape
    H, D = cfg.heads, cfg.dim
    dh = D // H
    sp = shard.seq_parallel if shard is not None else 1
    p0 = shard.seq_index * Sb if shard is not None else 0
    pos = _posenc(Sb * sp, D, tokens.device)[p0:p0 + Sb]
    x = params["embed"][tokens] + pos[None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    moe_shard = shard if shard is not None and shard.ranks > 1 else None

    def heads(t):
        return t.reshape(B, Sb, H, dh).transpose(1, 2)

    def layer_block(x, i):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = _ln(x)
        q, k, v = torch.split(h @ params[f"qkv_{i}"], D, dim=-1)
        o = _attention(cfg, heads(q), heads(k), heads(v),
                       shard)                                 # [B,H,Sb,dh]
        o = o.transpose(1, 2).reshape(B, Sb, D)
        x = x + o @ params[f"attn_out_{i}"]
        h = _ln(x)
        if cfg.moe_experts > 0:
            moe = MoEParams(params[f"moe_router_{i}"],
                            params[f"moe_w1_{i}"], params[f"moe_w2_{i}"])
            y, aux = top1_moe(moe, h, shard=moe_shard)
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


def shard_tokens(tokens: torch.Tensor, shard: Optional[TokenShard]):
    """This rank's block of the whole batch ``tokens`` [B, S]: (its
    tokens [B/dp, S/sp], their next tokens taken from the whole rows, the
    wrap-around position masked in ``valid`` [S/sp])."""
    B, S = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)
    valid = torch.arange(S, device=tokens.device) < S - 1
    if shard is None or shard.ranks == 1:
        return tokens, targets, valid
    check(B % shard.data_parallel == 0,
          f"batch {B} does not split over {shard.data_parallel} data ranks")
    bl, sb = B // shard.data_parallel, S // shard.seq_parallel
    rows = slice(shard.data_index * bl, (shard.data_index + 1) * bl)
    cols = slice(shard.seq_index * sb, (shard.seq_index + 1) * sb)
    return tokens[rows, cols], targets[rows, cols], valid[cols]


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                    shard: Optional[TokenShard] = None) -> torch.Tensor:
    """The mean next-token cross-entropy of the whole batch ``tokens``
    [B, S] (the wrap-around position masked) plus the MoE aux term. With
    a ``shard`` of several ranks every rank passes the whole batch and
    computes its block; the result is the whole batch's loss on every
    rank, summed over the mesh so that each rank's backward runs on its
    own share (the aux term, the same on every rank, counts once)."""
    B, S = tokens.shape
    tok, targets, valid = shard_tokens(tokens, shard)
    logits, aux = forward(params, tok, cfg, shard)
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, targets[..., None])[..., 0]
    valid = valid.to(picked.dtype)[None, :]
    share = -(picked * valid).sum() / (S - 1) / B
    if shard is not None and shard.ranks > 1:
        share = group_sum(share, shard.group)
    return share + cfg.moe_aux_weight * aux


# ---------------------------------------------------------------------------
# 1F1B pipelined training (PP x SP): transformer blocks stacked over the
# "stage" axis, the sequence over "seq" (parallel/pipeline.py).
# ---------------------------------------------------------------------------
STAGE_KEYS = ("qkv", "attn_out", "mlp_in", "mlp_out")


def init_pipeline_params(cfg: LMConfig,
                         device: Optional[torch.device] = None) -> Params:
    """Stage-stacked parameters: every per-block tensor gets leading axes
    [stages, blocks_per_stage]; embed and out stay unstacked. Block ``i``
    = ``s * blocks_per_stage + j`` is the flat model's block ``i`` of the
    same seed (:func:`init_params`), so :func:`pipeline_params_to_flat`
    of these is that model's parameters."""
    flat = init_params(dataclasses.replace(cfg, moe_experts=0), device)
    P_, bps = cfg.pipeline_stages, cfg.layers // cfg.pipeline_stages
    out = {"embed": flat["embed"], "out": flat["out"]}
    for key in STAGE_KEYS:
        out[key] = torch.stack([torch.stack([flat[f"{key}_{s * bps + j}"]
                                             for j in range(bps)])
                                for s in range(P_)])
    return out


def pipeline_param_shapes(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the stage-stacked layout."""
    lead = (cfg.pipeline_stages, cfg.layers // cfg.pipeline_stages)
    flat = dense_param_shapes(dataclasses.replace(cfg, layers=1))
    return {"embed": flat["embed"], "out": flat["out"],
            **{key: lead + flat[f"{key}_0"] for key in STAGE_KEYS}}


def pipeline_params_to_flat(cfg: LMConfig, params: Params) -> Params:
    """Unstack pipeline parameters into the flat layout :func:`forward`
    reads (for eval, and to hold the pipelined LM against the flat one)."""
    bps = cfg.layers // cfg.pipeline_stages
    flat: Params = {"embed": params["embed"], "out": params["out"]}
    for s in range(cfg.pipeline_stages):
        for j in range(bps):
            for key in STAGE_KEYS:
                flat[f"{key}_{s * bps + j}"] = params[key][s, j]
    return flat


def _pipeline_stage_fn(cfg: LMConfig, shard: TokenShard):
    """One pipeline stage = blocks_per_stage transformer blocks. ``x`` is
    this rank's [mb, S/sp, D] sequence block; attention runs the ring
    body over the shard's ``"seq"`` group."""
    H, D = cfg.heads, cfg.dim
    dh = D // H
    bps = cfg.layers // cfg.pipeline_stages
    sp, si = shard.seq_parallel, shard.seq_index
    group = shard.seq_group if sp > 1 else None

    def block(bp, x):
        mb, Sb, _ = x.shape
        h = _ln(x)
        q, k, v = torch.split(h @ bp["qkv"], D, dim=-1)

        def heads(t):
            return t.reshape(mb, Sb, H, dh).transpose(1, 2)

        o = ring_attention_block(heads(q), heads(k), heads(v), si, sp,
                                 causal=True, group=group)
        o = o.transpose(1, 2).reshape(mb, Sb, D)
        x = x + o @ bp["attn_out"]
        h = _ln(x)
        return x + F.gelu(h @ bp["mlp_in"], approximate="tanh") \
            @ bp["mlp_out"]

    def stage_fn(stage_params, x):
        for j in range(bps):
            x = block({k: p[j] for k, p in stage_params.items()}, x)
        return x

    return stage_fn


def _pipeline_loss_fn(S: int, shard: TokenShard):
    """Sum (not mean) next-token xent over this rank's sequence block; the
    global wrap-around position is masked from the block's index."""
    def loss_fn(head, y, tgt):
        logits = _ln(y) @ head["out"]
        logp = torch.log_softmax(logits, dim=-1)
        picked = torch.gather(logp, -1, tgt[..., None])[..., 0]
        Sb = y.shape[1]
        gpos = shard.seq_index * Sb + torch.arange(Sb, device=y.device)
        valid = (gpos < S - 1).to(picked.dtype)[None, :]
        return -(picked * valid).sum()
    return loss_fn


class AttentionLM(nn.Module):
    """The LM: ``fit`` trains on batches of int tokens [B, S] and ``loss``
    evaluates one. The device is the card unless ``device`` (or
    ``-platform=cpu``) says otherwise; ``mesh`` (a rank mesh of the
    axes ``data``/``seq``, or ``stage``/``seq`` for the pipeline; None:
    this rank alone) spreads it over ranks, every rank of which builds
    the model and is fed the same batches."""

    def __init__(self, cfg: LMConfig, device: Optional[torch.device] = None,
                 mesh=None):
        super().__init__()
        check(cfg.dim % cfg.heads == 0, "dim must divide by heads")
        check(cfg.sp_mode in ("ring", "ulysses"),
              f"unknown sp_mode {cfg.sp_mode!r} (want ring or ulysses)")
        self.cfg = cfg
        self.mesh = mesh
        n = mesh.size if mesh is not None else 1
        self.device = resolve_device(get_flag("platform"), device)
        axes = lm_axes(n, cfg.seq_parallel, cfg.data_parallel,
                       cfg.pipeline_stages)
        if cfg.pipeline_stages > 0:
            params = self._init_pipelined(n, axes)
        else:
            dp, sp = axes[DATA_AXIS], axes[SEQ_AXIS]
            check(dp * sp <= n, f"mesh {dp}x{sp} exceeds {n} ranks")
            check(cfg.seq % sp == 0, "seq must divide by seq_parallel")
            self._mesh_axes(n, axes)
            if cfg.sp_mode == "ulysses":
                check(cfg.heads % sp == 0,
                      f"ulysses splits {cfg.heads} heads over {sp} ranks")
            self.shard = self._shard(DATA_AXIS, dp, sp)
            params = init_params(cfg, self.device)
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))
        self._opt = torch.optim.Adam(self.parameters(),
                                     lr=cfg.learning_rate, betas=ADAM_BETAS,
                                     eps=ADAM_EPS)

    def _mesh_axes(self, n: int, axes: Dict[str, int]) -> None:
        """A mesh of more than one rank must be exactly these axes."""
        if n == 1:
            return
        got = {a: self.mesh.axis_size(a) for a in self.mesh.axis_names}
        check(got == {a: k for a, k in axes.items() if k > 1}
              or got == axes,
              f"the LM's mesh must have the axes {axes} over its {n} ranks "
              f"(parallel/mesh.py::build_lm_mesh); got {got}")

    def _shard(self, outer: str, outer_n: int, sp: int) -> TokenShard:
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return TokenShard()
        return TokenShard(
            data_index=mesh.axis_index(outer) if outer == DATA_AXIS else 0,
            data_parallel=outer_n if outer == DATA_AXIS else 1,
            seq_index=mesh.axis_index(SEQ_AXIS), seq_parallel=sp,
            group=mesh.world_group,
            seq_group=mesh.group(SEQ_AXIS) if sp > 1 else None)

    # -- 1F1B pipelined mode (PP x SP) ------------------------------------
    def _init_pipelined(self, n: int, axes: Dict[str, int]) -> Params:
        cfg = self.cfg
        P_ = cfg.pipeline_stages
        check(cfg.layers % P_ == 0, "layers must divide by pipeline_stages")
        check(cfg.moe_experts == 0,
              "pipeline mode does not compose with MoE yet")
        check(cfg.data_parallel in (None, 1),
              "pipeline mode has no data axis (microbatching covers it); "
              "unset data_parallel")
        check(cfg.sp_mode == "ring",
              "pipeline mode runs the ring body over the seq axis")
        sp = axes[SEQ_AXIS]
        check(cfg.seq % sp == 0, "seq must divide by seq_parallel")
        check(P_ * sp <= n, f"mesh {P_}x{sp} exceeds {n} ranks")
        self._mesh_axes(n, axes)
        self.shard = self._shard(STAGE_AXIS, P_, sp)
        self.stage = (self.mesh.axis_index(STAGE_AXIS)
                      if self.mesh is not None else 0)
        self._stage_fn = _pipeline_stage_fn(cfg, self.shard)
        self._loss_fn = _pipeline_loss_fn(cfg.seq, self.shard)
        return init_pipeline_params(cfg, self.device)

    @property
    def params(self) -> Params:
        return dict(self.named_parameters())

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                               device=self.device)

    @staticmethod
    def _sum_over(grads, group) -> None:
        """Sum the gradients ``grads`` over ``group``, in place."""
        for g, total in zip(grads, allreduce_sum_many(grads, group)):
            if total is not g:
                g.copy_(total)

    def _sum_grads(self, group) -> None:
        """Sum every parameter's gradient over ``group``."""
        self._sum_over([p.grad for p in self.parameters()], group)

    def fit(self, batches: Iterable[np.ndarray]) -> List[float]:
        """One Adam step per batch of int tokens [B, S] (every rank of the
        mesh passes the same batches); returns the per-batch losses, read
        to the host once, after the last step."""
        losses = []
        for tokens in batches:
            tokens = self._tokens(tokens)
            if self.cfg.pipeline_stages > 0:
                loss = self._pipelined_grads(tokens)
            else:
                loss = next_token_loss(self.params, tokens, self.cfg,
                                       self.shard)
                self._opt.zero_grad(set_to_none=True)
                loss.backward()
                self._sum_grads(self.shard.group)
            self._opt.step()
            losses.append(loss.detach())
        if not losses:
            return []
        return [float(x) for x in torch.stack(losses).cpu()]

    def _pipelined_grads(self, tokens: torch.Tensor) -> torch.Tensor:
        """One 1F1B step's gradients (JAX ``_init_pipelined``'s
        ``train_step``): the stage ranks run the schedule on this rank's
        sequence block of the microbatches; each stage's gradients land in
        its slice of the stacked parameters and are summed over the stage
        axis, the embedding's from the stream's gradients over the
        sequence axis, so every rank holds the whole gradient. Returns the
        loss, the mean over every position as in eval."""
        from multiverso_tpu_torch.parallel.pipeline import \
            pipeline_train_1f1b
        cfg, shard = self.cfg, self.shard
        # The stage gradients are added into slices of the stacked
        # parameters' gradients, so every gradient starts as zeros.
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        M = cfg.pipeline_microbatches
        B, S = tokens.shape
        check(B % M == 0,
              f"batch {B} must divide into {M} pipeline microbatches")
        tok = tokens.reshape(M, B // M, S)
        Sb = S // shard.seq_parallel
        cols = slice(shard.seq_index * Sb, (shard.seq_index + 1) * Sb)
        tgts = torch.roll(tok, -1, dims=-1)[..., cols]
        tok = tok[..., cols]
        x = self.embed[tok] + _posenc(S, cfg.dim, tok.device)[cols]
        stage_params = {k: getattr(self, k)[self.stage] for k in STAGE_KEYS}
        loss_sum, sgrads, hgrads, dxs = pipeline_train_1f1b(
            self._stage_fn, self._loss_fn, stage_params, x.detach(), tgts,
            self.mesh, reduce_axes=(SEQ_AXIS,) if shard.seq_parallel > 1
            else (), head_params={"out": self.out},
            return_input_grads=True)
        x.backward(dxs)
        for k in STAGE_KEYS:
            getattr(self, k).grad[self.stage] += sgrads[k]
        self.out.grad += hgrads["out"]
        stage_group = (self.mesh.group(STAGE_AXIS)
                       if cfg.pipeline_stages > 1 else None)
        self._sum_over([getattr(self, k).grad for k in STAGE_KEYS],
                       stage_group)
        self._sum_over([self.embed.grad], shard.seq_group)
        denom = M * (B // M) * (S - 1)       # mean-per-position, as eval
        for p in self.parameters():
            p.grad.div_(denom)
        return loss_sum / denom

    def loss(self, tokens: np.ndarray) -> float:
        tokens = self._tokens(tokens)
        with torch.no_grad():
            if self.cfg.pipeline_stages > 0:
                # eval through the flat forward, on this rank alone
                return float(next_token_loss(
                    pipeline_params_to_flat(self.cfg, self.params), tokens,
                    self.cfg))
            return float(next_token_loss(self.params, tokens, self.cfg,
                                         self.shard))
