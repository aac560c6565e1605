"""Objectives for logistic regression as torch functions.

Port of ``multiverso_tpu/models/logreg/objective.py``. Parity with
``Applications/LogisticRegression/src/objective/*.h``: linear / sigmoid /
softmax / (FTRL = sigmoid loss with the FTRL updater).

Each objective is a pure ``(weights, X, y) -> (loss, grad)`` and
``predict`` over **dense minibatches**, so ``X @ W`` is one batched matrix
product on the card (the reference's per-sample sparse dot-product loops
would leave it idle). The ops and their order are the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


def _linear(weights: torch.Tensor, X: torch.Tensor, y: torch.Tensor):
    """Squared loss; weights [F, C] (C==1 collapses to a vector)."""
    pred = X @ weights
    err = pred - y
    loss = 0.5 * torch.mean(torch.sum(err * err, dim=-1))
    grad = X.T @ err / X.shape[0]
    return loss, grad


def _sigmoid(weights: torch.Tensor, X: torch.Tensor, y: torch.Tensor):
    """Binary logistic; y in {0,1}, weights [F, 1]."""
    logits = (X @ weights).squeeze(-1)
    y = y.squeeze(-1) if y.dim() > 1 else y
    loss = torch.mean(torch.logaddexp(torch.zeros_like(logits), logits)
                      - y * logits)
    p = torch.sigmoid(logits)
    grad = X.T @ (p - y)[:, None] / X.shape[0]
    return loss, grad


def _softmax(weights: torch.Tensor, X: torch.Tensor, y: torch.Tensor):
    """Multinomial; y integer labels, weights [F, C]."""
    logits = X @ weights
    logp = torch.log_softmax(logits, dim=-1)
    y = y.to(torch.int64)
    loss = -torch.mean(torch.take_along_dim(logp, y[:, None], dim=1))
    p = torch.exp(logp)
    onehot = torch.nn.functional.one_hot(y, weights.shape[1]).to(p.dtype)
    grad = X.T @ (p - onehot) / X.shape[0]
    return loss, grad


def _predict_linear(weights, X):
    return X @ weights


def _predict_sigmoid(weights, X):
    return torch.sigmoid((X @ weights).squeeze(-1))


def _predict_softmax(weights, X):
    return torch.softmax(X @ weights, dim=-1)


_OBJECTIVES: Dict[str, Tuple[Callable, Callable]] = {
    "linear": (_linear, _predict_linear),
    "sigmoid": (_sigmoid, _predict_sigmoid),
    "softmax": (_softmax, _predict_softmax),
    "ftrl": (_sigmoid, _predict_sigmoid),  # FTRL = sigmoid loss + ftrl updater
}


def get_objective(name: str) -> Tuple[Callable, Callable]:
    """Returns (loss_and_grad, predict)."""
    try:
        return _OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown objective '{name}'; "
                         f"have {sorted(_OBJECTIVES)}") from None


def correct_count(objective: str, probs, labels) -> int:
    """Test-time accuracy counting (ref logreg.cpp:121-173)."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    if objective in ("sigmoid", "ftrl"):
        return int(((probs > 0.5) == (labels > 0.5)).sum())
    if objective == "softmax":
        return int((probs.argmax(axis=-1) == labels).sum())
    return int((np.abs(probs.squeeze() - labels) < 0.5).sum())
