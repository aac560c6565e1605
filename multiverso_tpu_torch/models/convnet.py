"""Small CNN trained with ASGD parameter-manager sync: the binding
benchmark workload (port of ``multiverso_tpu/models/convnet.py``).

The reference's published headline numbers are ResNet/CIFAR-10 trained by N
processes syncing through ``MVModelParamManager`` every few batches
(``binding/python/docs/BENCHMARK.md``). This module keeps that workload's
shape: a convnet step per worker on the Zoo's device, with workers syncing
their parameters through ONE ArrayTable via :class:`PyTreeParamManager`:
push the local delta, pull the merged global model (the theano_ext
``mv_sync`` cycle).

The layouts are the JAX package's: NHWC input, HWIO filters, the dense
weights ``[in, out]``, flattened in NHWC order, so
:func:`params_from_jax` carries a JAX parameter dict across as it is. The
convolutions run as ``conv2d`` on NCHW views of the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch.binding.param_manager import (PyTreeParamManager,
                                                        SyncCallback)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ConvNetConfig:
    image_size: int = 16
    channels: int = 1
    num_classes: int = 2
    widths: Tuple[int, ...] = (16, 32)
    dense: int = 64
    learning_rate: float = 0.05
    seed: int = 0


def init_params(cfg: ConvNetConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """He-normal parameters drawn from ``generator`` (on the CPU, then
    moved to ``device``): the JAX package's shapes and scales."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator)
                * np.sqrt(2.0 / fan_in)).to(device or "cpu")

    params: Params = {}
    cin = cfg.channels
    for i, w in enumerate(cfg.widths):
        params[f"conv_{i}"] = normal((3, 3, cin, w), 9 * cin)
        cin = w
    spatial = cfg.image_size // (2 ** len(cfg.widths))
    flat = spatial * spatial * cin
    params["dense"] = normal((flat, cfg.dense), flat)
    params["out"] = normal((cfg.dense, cfg.num_classes), cfg.dense)
    return params


def params_from_jax(params, device: Optional[torch.device] = None
                    ) -> Params:
    """A JAX convnet's parameter dict (arrays in its layouts) as the
    port's: the same values, as float32 tensors on ``device``."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32),
                            device=device or "cpu")
            for k, v in params.items()}


def forward(params: Params, x: torch.Tensor, cfg: ConvNetConfig
            ) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, classes]."""
    h = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for i in range(len(cfg.widths)):
        w = params[f"conv_{i}"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = F.max_pool2d(F.relu(F.conv2d(h, w, padding="same")), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
    h = F.relu(h @ params["dense"])
    return h @ params["out"]


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor,
            cfg: ConvNetConfig) -> torch.Tensor:
    logp = F.log_softmax(forward(params, x, cfg), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def sgd_step(params: Params, x: torch.Tensor, y: torch.Tensor,
             cfg: ConvNetConfig) -> Tuple[Params, torch.Tensor]:
    """One SGD step: ``p - lr * grad`` for every parameter (new tensors)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, x, y, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - cfg.learning_rate * g).detach()
           for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


class ConvNet(torch.nn.Module):
    """The convnet as an ``nn.Module``: two 3x3 convolutions (``conv2d``,
    relu, 2x2 max-pool) and two dense layers, its parameters in the JAX
    layouts (HWIO filters, ``[in, out]`` dense weights)."""

    def __init__(self, cfg: ConvNetConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.weights = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v.detach().clone())
             for k, v in params.items()})

    def params(self) -> Params:
        return {k: v for k, v in self.weights.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), x, self.cfg)


class ASGDConvNetWorker:
    """One worker: local SGD steps + periodic param-manager sync
    (``MVCallback`` semantics: sync every ``sync_freq`` batches)."""

    def __init__(self, cfg: ConvNetConfig, manager: PyTreeParamManager,
                 sync_freq: int = 4):
        self.cfg = cfg
        self.manager = manager
        self._callback = SyncCallback(manager, freq=sync_freq)
        self.params = manager.get()
        self.device = next(iter(self.params.values())).device

    def train(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]]
              ) -> List[float]:
        losses = []
        for x, y in batches:
            self.params, loss = sgd_step(
                self.params, torch.as_tensor(x, device=self.device),
                torch.as_tensor(y, dtype=torch.int64, device=self.device),
                self.cfg)
            losses.append(float(loss))
            merged = self._callback.on_batch_end(self.params)
            if merged is not None:
                self.params = merged
        self.params = self.manager.sync(self.params)   # epoch boundary
        return losses

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        with torch.no_grad():
            logits = forward(self.params,
                             torch.as_tensor(x, device=self.device),
                             self.cfg)
        pred = logits.argmax(-1).cpu().numpy()
        return float((pred == y).mean())
