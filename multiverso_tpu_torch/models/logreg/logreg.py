"""LogReg driver: epoch loop, test/predict.

Port of ``multiverso_tpu/models/logreg/logreg.py``. Parity with
``Applications/LogisticRegression/src/logreg.cpp``: ``Train`` = epoch
loop over async reader buffers -> ``model.update`` per minibatch
(``logreg.cpp:41-87``); ``Test`` computes accuracy and writes predictions
(``logreg.cpp:121-173``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.models.logreg.model import (LogRegConfig,
                                                      make_model,
                                                      model_device)
from multiverso_tpu_torch.models.logreg.objective import (correct_count,
                                                          get_objective)
from multiverso_tpu_torch.utils.log import log


class LogReg:
    def __init__(self, cfg: LogRegConfig, model=None):
        """``model``: inject a pre-built model; default builds from cfg."""
        self.cfg = cfg
        self.model = model if model is not None else make_model(cfg)
        _, self._predict = get_objective(cfg.objective)
        self.device = getattr(self.model, "device", None) or model_device()
        if cfg.init_model_file:
            self.load_model(cfg.init_model_file)

    # -- model file IO (ref configure.h:53,77: init_model_file /
    # output_model_file; format is .npy instead of the reference's raw
    # binary dump) -------------------------------------------------------
    def save_model(self, path: str) -> None:
        with open(path, "wb") as f:
            np.save(f, self.model.get_weights())

    def load_model(self, path: str) -> None:
        with open(path, "rb") as f:
            self.model.set_weights(np.load(f))

    def train(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
              epochs: Optional[int] = None) -> List[float]:
        """Returns per-epoch mean losses."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        epoch_losses: List[float] = []
        for epoch in range(epochs):
            losses = []
            for X, y in batches:
                # update returns a device scalar; the host reads the losses
                # at the epoch boundary, so the step loop never waits.
                losses.append(self.model.update(X, y))
            sync = getattr(self.model, "sync", None)
            if sync:
                sync()      # epoch barrier + fresh model (ref logreg.cpp:81)
            mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy()
                                       .astype(np.float64)))
                         if losses else 0.0)
            epoch_losses.append(mean_loss)
            log.debug("epoch %d: loss=%.5f", epoch, mean_loss)
        return epoch_losses

    def predict(self, X: np.ndarray) -> np.ndarray:
        w = torch.as_tensor(np.asarray(self.model.get_weights(), np.float32),
                            device=self.device)
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return self._predict(w, X).cpu().numpy()

    def test(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
             output_path: Optional[str] = None) -> float:
        """Accuracy over batches; optionally writes predictions
        (ref logreg.cpp:121-173)."""
        total = 0
        correct = 0
        out = open(output_path, "w") if output_path else None
        try:
            for X, y in batches:
                probs = self.predict(X)
                correct += correct_count(self.cfg.objective, probs, y)
                total += len(y)
                if out is not None:
                    for p in np.atleast_1d(probs):
                        out.write(f"{np.asarray(p).ravel()[0]:.6f}\n")
        finally:
            if out is not None:
                out.close()
        return correct / max(total, 1)
