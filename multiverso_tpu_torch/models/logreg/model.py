"""LogReg models: local and parameter-server modes.

Port of ``multiverso_tpu/models/logreg/model.py``. Parity with
``Applications/LogisticRegression/src/model/``:

* ``LocalModel``: weights on the device, one step per minibatch.
* ``PSModel`` (``ps_model.cpp``): weights in an :class:`ArrayTable`; each
  minibatch computes the gradient against the worker's local copy and pushes
  a **client-side lr-scaled delta** (ref ``updater/updater.cpp:12-60``);
  the model is pulled every ``sync_frequency`` minibatches
  (``ps_model.cpp:172-182``), optionally **pipelined** with a double-buffered
  async Get so the pull overlaps compute (``ps_model.cpp:236-271``).

* ``AllreduceModel`` (``comm_policy=allreduce``): weights on the device,
  the gradient merged by an all-reduce over a data-parallel rank mesh
  axis (``dp_mesh``/``dp_axis``); the table is written once a sync.
* ``ModelAverageModel`` (``comm_policy=model_average``): local replicas
  averaged over the world's ranks at every sync (the reference's "ma").

FTRL mode pushes raw gradients; the server-side FTRL updater owns {z, n}
and recomputes weights (the reference's FTRL table), so FTRL stays on the
ps plane. The steps run on the Zoo's device (the card unless
``-platform=cpu``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.core.options import AddOption, ArrayTableOption
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.models.logreg.objective import get_objective
from multiverso_tpu_torch.parallel import collectives
from multiverso_tpu_torch.parallel import comm_policy as cp
from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.utils.configure import get_flag
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.utils.log import check, log


@dataclasses.dataclass
class LogRegConfig:
    """Key=value config (ref LR ``configure.h:9-115`` surface)."""
    objective: str = "sigmoid"          # linear|sigmoid|softmax|ftrl
    num_feature: int = 0
    num_class: int = 1
    learning_rate: float = 0.1
    minibatch_size: int = 20
    epochs: int = 1
    sync_frequency: int = 1
    pipeline: bool = False
    use_ps: bool = True
    # Weight-table communication policy (parallel/comm_policy.py): "" or
    # "ps" is the PSModel path; "allreduce", "model_average", or "auto"
    # (resolve_logreg_comm_policy's decision).
    comm_policy: str = ""
    regular: str = "none"               # none|l1|l2
    regular_coef: float = 0.0
    bias: bool = True
    input_format: str = "libsvm"
    # FTRL hyperparams (mapped onto AddOption fields)
    ftrl_alpha: float = 0.1
    ftrl_beta: float = 1.0
    ftrl_l1: float = 1.0
    ftrl_l2: float = 1.0
    # IO surface carried in the config file (ref configure.h:53-79)
    train_file: str = ""
    test_file: str = ""
    output_file: str = ""
    init_model_file: str = ""
    output_model_file: str = ""

    # Reference key names (configure.h:19-96) -> our field names.
    KEY_ALIASES: ClassVar[dict] = {
        "input_size": "num_feature",
        "output_size": "num_class",
        "train_epoch": "epochs",
        "objective_type": "objective",
        "regular_type": "regular",
        "alpha": "ftrl_alpha",
        "beta": "ftrl_beta",
        "lambda1": "ftrl_l1",
        "lambda2": "ftrl_l2",
    }
    VALUE_ALIASES: ClassVar[dict] = {
        "objective": {"default": "linear"},
        "regular": {"default": "none", "L1": "l1", "L2": "l2"},
    }

    @property
    def width(self) -> int:
        return self.num_feature + (1 if self.bias else 0)

    @classmethod
    def from_file(cls, path: str) -> "LogRegConfig":
        """Parse the reference's ``key=value`` config-file format, accepting
        both our field names and the reference's key spellings."""
        cfg = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key = cls.KEY_ALIASES.get(key.strip(), key.strip())
                val = val.strip()
                val = cls.VALUE_ALIASES.get(key, {}).get(val, val)
                if hasattr(cfg, key):
                    field_type = type(getattr(cfg, key))
                    if field_type is bool:
                        setattr(cfg, key, val.lower() in ("true", "1"))
                    else:
                        setattr(cfg, key, field_type(val))
        return cfg


def model_device() -> torch.device:
    """The device a model's steps run on: the started Zoo's, else the
    ``-platform`` flag's (the card unless ``cpu``)."""
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        return zoo.device
    return resolve_device(get_flag("platform"))


def make_step(cfg: LogRegConfig):
    """``(weights, X, y) -> (loss, grad)`` with the regularizer: the one
    objective math every model shares."""
    loss_grad, _ = get_objective(cfg.objective)
    coef = cfg.regular_coef
    regular = cfg.regular

    def step(weights, X, y):
        loss, grad = loss_grad(weights, X, y)
        if regular == "l2" and coef:
            grad = grad + coef * weights
        elif regular == "l1" and coef:
            grad = grad + coef * torch.sign(weights)
        return loss, grad

    return step


class LocalModel:
    """Non-PS mode: weights stay on the device."""

    def __init__(self, cfg: LogRegConfig):
        self.cfg = cfg
        self.device = model_device()
        self.weights = torch.zeros((cfg.width, cfg.num_class),
                                   dtype=torch.float32, device=self.device)
        self._step = make_step(cfg)

    def update(self, X: np.ndarray, y: np.ndarray) -> torch.Tensor:
        """Returns the loss as a device scalar (no host sync)."""
        loss, grad = self._step(self.weights, _dev(X, self.device),
                                _dev(y, self.device))
        self.weights = self.weights - self.cfg.learning_rate * grad
        return loss

    def get_weights(self) -> np.ndarray:
        return self.weights.cpu().numpy()

    def set_weights(self, w: np.ndarray) -> None:
        self.weights = torch.as_tensor(
            np.asarray(w, dtype=np.float32).reshape(
                self.cfg.width, self.cfg.num_class).copy(),
            device=self.device)


def _dev(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


class PSModel:
    """PS mode: weights live in an ArrayTable (or any injected table with
    the same get/add surface)."""

    def __init__(self, cfg: LogRegConfig, table=None):
        self.cfg = cfg
        is_ftrl = cfg.objective == "ftrl"
        updater = "ftrl" if is_ftrl else "sgd"
        self.table = table if table is not None else mv.create_table(
            ArrayTableOption(
                size=cfg.width * cfg.num_class, updater=updater,
                name="logreg_weights"))
        self.device = model_device()
        self.is_ftrl = is_ftrl
        self._step = make_step(cfg)
        self.local_weights = np.zeros((cfg.width, cfg.num_class),
                                      dtype=np.float32)
        self._minibatches_since_sync = 0
        self._pending_get: Optional[int] = None
        self._dirty = False     # True once this instance has pushed grads
        # In sync mode the BSP vector clocks are per worker, so every
        # worker's adds tick its OWN clock.
        wid = max(mv.worker_id(), 0)
        if is_ftrl:
            self._add_option = AddOption(
                worker_id=wid, learning_rate=cfg.ftrl_alpha,
                rho=cfg.ftrl_beta, lambda_=cfg.ftrl_l1,
                momentum=cfg.ftrl_l2)
        else:
            self._add_option = AddOption(worker_id=wid,
                                         learning_rate=cfg.learning_rate)

    def update(self, X: np.ndarray, y: np.ndarray) -> torch.Tensor:
        """Returns the loss as a device scalar (no host sync)."""
        loss, grad = self._step(_dev(self.local_weights, self.device),
                                _dev(X, self.device), _dev(y, self.device))
        if self.is_ftrl:
            delta = grad          # raw gradient; server FTRL owns the step
        else:
            delta = self.cfg.learning_rate * grad  # client-side lr scaling
        with monitor("LOGREG_PUSH"):
            self.table.add_async(delta.reshape(-1), self._add_option)
        self._dirty = True
        self._minibatches_since_sync += 1
        if self._needs_sync():
            self._pull()
        return loss

    def _needs_sync(self) -> bool:
        # ref ps_model.cpp:172-182
        return self._minibatches_since_sync >= self.cfg.sync_frequency

    def _pull(self) -> None:
        cfg = self.cfg
        with monitor("LOGREG_PULL"):
            if cfg.pipeline:
                # Double buffer (ref ps_model.cpp:236-271): wait on the get
                # issued LAST sync, then immediately issue the next.
                if self._pending_get is not None:
                    data = self.table.wait(self._pending_get)
                    self.local_weights = data.reshape(cfg.width,
                                                      cfg.num_class)
                self._pending_get = self.table.get_async()
            else:
                self.local_weights = self.table.get().reshape(
                    cfg.width, cfg.num_class)
        self._minibatches_since_sync = 0

    def sync(self) -> None:
        """Blocking pull — epoch boundaries / before test
        (ref ps_model.cpp:206-233)."""
        if self._pending_get is not None:
            self.table.wait(self._pending_get)
            self._pending_get = None
        self.local_weights = self.table.get().reshape(
            self.cfg.width, self.cfg.num_class)
        self._minibatches_since_sync = 0

    def get_weights(self) -> np.ndarray:
        return self.local_weights

    def set_weights(self, w: np.ndarray) -> None:
        """Warm start (ref ``init_model_file``) on a FRESH (zero) table via
        the reference binding's master-init trick
        (``binding/python/multiverso/tables.py:38-68``): the master worker
        adds the init value, every other worker adds zeros — one symmetric
        add per worker, so it is BSP-safe. FTRL keeps server-side {z,n}
        state that a raw weight file cannot reconstruct, so warm start is
        rejected there."""
        if self.is_ftrl:
            log.error("init_model_file ignored: ftrl server state cannot be "
                      "reconstructed from a weight vector")
            return
        check(not self._dirty,
              "warm start requires a fresh (zero) PS table — construct a "
              "new LogReg with init_model_file instead of calling "
              "load_model on a trained one")
        check(not np.any(self.table.get()),
              "warm start requires a fresh (zero) PS table — the shared "
              "table already holds trained weights")
        w = np.asarray(w, dtype=np.float32).reshape(self.cfg.width,
                                                    self.cfg.num_class)
        # sgd updater applies data -= delta, so the master pushes -w.
        delta = -w if mv.is_master_worker() else np.zeros_like(w)
        self.table.add(delta.reshape(-1), self._add_option)
        self.local_weights = w.copy()


class AllreduceModel:
    """``comm_policy=allreduce``: the weights stay on the device and the
    gradient is merged by a collective inside the step — no PS round trip
    per minibatch. With a data-parallel mesh axis (``dp_mesh``,
    ``dp_axis``) each rank computes its shard's batch-mean gradient and
    loss and the merge is an all-reduce of both divided by the axis size;
    with one contributor it is the local update. The PS table stays the
    checkpoint/serving surface: :meth:`sync` publishes the replica once
    (counted under ``comm.allreduce.*``) where PSModel pushes a delta every
    minibatch.

    The update is ``w - lr * grad`` with ``lr * grad`` an op of its own,
    the rounding points of the PS path (the client scales the delta, the
    server's sgd updater subtracts it), so both planes give the same
    weights bitwise. The JAX package pins those points with
    ``optimization_barrier`` and two dispatches; torch's eager ops keep
    them apart by construction."""

    def __init__(self, cfg: LogRegConfig, table=None, dp_mesh=None,
                 dp_axis: Optional[str] = None):
        check(cfg.objective != "ftrl",
              "ftrl keeps server-side {z, n} state — comm_policy=allreduce "
              "cannot reconstruct it; use ps")
        self.cfg = cfg
        self.table = table if table is not None else mv.create_table(
            ArrayTableOption(size=cfg.width * cfg.num_class, updater="sgd",
                             name="logreg_weights",
                             comm_policy="allreduce"))
        self.device = model_device()
        self._step = make_step(cfg)
        self._n_axis, self._group = (
            collectives.axis_group(dp_mesh, dp_axis)
            if dp_mesh is not None and dp_axis else (1, None))
        self._grad_bytes = cfg.width * cfg.num_class * 4
        self.weights = self.table.raw().reshape(
            cfg.width, cfg.num_class).to(self.device)

    def update(self, X: np.ndarray, y: np.ndarray) -> torch.Tensor:
        """Returns the loss as a device scalar (no host sync)."""
        loss, grad = self._step(self.weights, _dev(X, self.device),
                                _dev(y, self.device))
        if self._n_axis > 1:
            # Per-shard batch means -> the global mean: the collective
            # this policy exists for.
            grad = collectives.allreduce_sum(grad, self._group) / \
                self._n_axis
            loss = collectives.allreduce_sum(loss, self._group) / \
                self._n_axis
        delta = self.cfg.learning_rate * grad
        self.weights = self.weights - delta
        cp.record(cp.ALLREDUCE, self._grad_bytes)
        return loss

    def sync(self) -> None:
        """Publish the device replica to the PS table (epoch boundaries /
        before test) — one dense write where PSModel pushed a delta per
        minibatch."""
        self.table.publish(self.get_weights().reshape(-1))

    def get_weights(self) -> np.ndarray:
        return self.weights.cpu().numpy()

    def set_weights(self, w: np.ndarray) -> None:
        self.weights = torch.as_tensor(
            np.asarray(w, dtype=np.float32).reshape(
                self.cfg.width, self.cfg.num_class).copy(),
            device=self.device)
        self.sync()


class ModelAverageModel(LocalModel):
    """``comm_policy=model_average`` — the reference's "ma" mode for LR
    (``-ma``, src/zoo.cpp:24): each rank trains a local replica with the
    local step; :meth:`sync` averages the replicas over the world's ranks
    (:func:`~multiverso_tpu_torch.parallel.comm_policy.model_average_arrays`)
    and publishes the merged weights to the PS table. Convergence trades
    a staleness window (the averaging period) for no per-step
    communication — loss-trajectory parity with PS, not bitwise."""

    def __init__(self, cfg: LogRegConfig, table=None):
        super().__init__(cfg)
        self.table = table if table is not None else mv.create_table(
            ArrayTableOption(size=cfg.width * cfg.num_class, updater="sgd",
                             name="logreg_weights",
                             comm_policy="model_average"))

    def sync(self) -> None:
        self.weights = cp.model_average_arrays([self.weights])[0]
        self.table.publish(self.get_weights().reshape(-1))


def resolve_logreg_comm_policy(cfg: LogRegConfig) -> str:
    """The LR weight table's policy: ""/ps keeps the PSModel path without
    probing; "auto" resolves on the weight shape (dense, small ->
    whichever plane the probe measures faster); FTRL is pinned to ps."""
    explicit = (cfg.comm_policy or "").strip().lower()
    if cfg.objective == "ftrl":
        check(explicit in ("", "ps", "auto"),
              "ftrl keeps server-side {z, n} updater state — its "
              f"comm_policy must stay ps (got '{explicit}')")
        return cp.PS
    if explicit in ("", cp.PS):
        return cp.PS
    zoo = Zoo._instance
    mesh = zoo.mesh if zoo is not None and zoo.started else None
    return cp.resolve_comm_policy(
        (cfg.width, cfg.num_class), np.float32, sparse=False,
        explicit=None if explicit == "auto" else explicit, mesh=mesh,
        table="logreg_weights")


def make_model(cfg: LogRegConfig):
    if not cfg.use_ps:
        return LocalModel(cfg)
    policy = resolve_logreg_comm_policy(cfg)
    if policy == cp.ALLREDUCE:
        return AllreduceModel(cfg)
    if policy == cp.MODEL_AVERAGE:
        return ModelAverageModel(cfg)
    return PSModel(cfg)
