"""DLRM-shaped click-through model over the PS embedding plane.

Port of ``multiverso_tpu/models/dlrm/model.py``:

* **Embedding tables** — one PS-backed :class:`MatrixTable` per
  categorical field (``comm_policy='ps'``), updated by the server-side
  ``adagrad`` updater. Clients push lr-prescaled row deltas
  (``AddOption.learning_rate`` reconstructs the raw gradient server-side,
  the PSModel contract of ``models/logreg``).
* **Dense bottom/top MLP** — on the device, trained by the hybrid step:
  the gradients of one torch autograd pass, each scaled by ``lr`` as an
  op of its own, merged through
  :func:`~multiverso_tpu_torch.parallel.comm_policy.build_dense_sync`
  over the ``dp_axis`` of a data-parallel rank mesh (``dp_mesh``: the
  mean of the ranks' deltas; without a mesh, or at one rank, the
  identity), then applied as ``w - d``. The JAX package
  pins the same rounding points with ``optimization_barrier``; torch's
  eager ops keep them apart by construction.
* **Bitwise parity between the planes** — the LOCAL twin
  (``mode='local'``) runs the identical dense step and applies embedding
  deltas through the function the server's store calls for an adagrad
  table without the row kernels (``AdaGradUpdater.update_rows``: the
  duplicate combine, whose fold is a kernel on a card, then the adagrad
  row math), so PS and local are bitwise equal on the CPU and on a card.

Model shape (DLRM): the bottom MLP embeds the dense features into the
embedding space, the interaction layer takes all pairwise dot products of
the (bottom output + per-field embedding) vectors, and the top MLP maps
[bottom output ++ interactions] to one click logit. Float32 products run
in full float32 (torch's default: TF32 off), as the tolerances against the
CPU assume.

Not ported: ``-state_sharding=on`` of the embedding tables' state, which
needs more than one card (the tables raise, ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.core.options import AddOption, MatrixTableOption
from multiverso_tpu_torch.core.updater import get_updater
from multiverso_tpu_torch.parallel import comm_policy as cp
from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.telemetry import span
from multiverso_tpu_torch.utils.configure import flag_or
from multiverso_tpu_torch.utils.log import check

__all__ = ["DLRMConfig", "DLRMModel", "SnapshotScorer", "dense_param_count",
           "flatten_dense", "unflatten_dense", "init_dense_params",
           "make_forward"]

Params = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class DLRMConfig:
    """Model + optimizer shape. ``vocab`` rows per field table; the
    stream config's (fields, vocab, dense_dim) must match."""
    fields: int = 4
    vocab: int = 2048
    embed_dim: int = 16
    dense_dim: int = 8
    bottom_mlp: Tuple[int, ...] = (32,)
    top_mlp: Tuple[int, ...] = (32,)
    #: Client-side delta prescale for embedding pushes AND the dense
    #: plane's SGD step (the server reconstructs grad = delta / lr).
    learning_rate: float = 0.05
    #: Server-side adagrad step scale (AddOption.rho).
    adagrad_step: float = 0.05
    seed: int = 0
    table_prefix: str = "dlrm_emb"
    #: Embedding-table policy: the PS plane is the point of this model.
    comm_policy: str = "ps"

    @property
    def interaction_dim(self) -> int:
        # Pairwise dots among (bottom output + fields) vectors, i < j.
        n = self.fields + 1
        return (n * (n - 1)) // 2

    @property
    def top_in_dim(self) -> int:
        return self.embed_dim + self.interaction_dim

    def layer_dims(self) -> List[Tuple[int, int]]:
        """(in, out) of every dense layer, bottom then top."""
        dims = []
        prev = self.dense_dim
        for h in tuple(self.bottom_mlp) + (self.embed_dim,):
            dims.append((prev, h))
            prev = h
        prev = self.top_in_dim
        for h in tuple(self.top_mlp) + (1,):
            dims.append((prev, h))
            prev = h
        return dims

    @property
    def dense_table_name(self) -> str:
        return f"{self.table_prefix}_dense"

    def table_name(self, field: int) -> str:
        return f"{self.table_prefix}{field}"


def dense_param_count(cfg: DLRMConfig) -> int:
    return sum(i * o + o for i, o in cfg.layer_dims())


def init_dense_params(cfg: DLRMConfig,
                      device: Optional[torch.device] = None) -> Params:
    """Deterministic He-style init: the JAX package's numpy draws, so
    both packages (and the PS model and its local twin) start from the
    same bytes."""
    rng = np.random.default_rng(cfg.seed)
    params = []
    for fan_in, fan_out in cfg.layer_dims():
        W = (rng.standard_normal((fan_in, fan_out))
             * np.sqrt(2.0 / max(1, fan_in))).astype(np.float32)
        b = np.zeros(fan_out, dtype=np.float32)
        params.append((torch.tensor(W, device=device),
                       torch.tensor(b, device=device)))
    return params


def flatten_dense(params: Params) -> np.ndarray:
    """Pack the MLP params into one row vector — the payload the
    ``{prefix}_dense`` publish table (and so every checkpoint and serving
    snapshot) carries."""
    return np.concatenate([leaf.detach().cpu().numpy().reshape(-1)
                           for W, b in params for leaf in (W, b)])


def unflatten_dense(cfg: DLRMConfig, vec,
                    device: Optional[torch.device] = None) -> Params:
    if torch.is_tensor(vec):
        vec = vec.detach().cpu().numpy()
    vec = np.asarray(vec, dtype=np.float32).reshape(-1)
    if vec.size != dense_param_count(cfg):
        raise ValueError(f"dense vector has {vec.size} params, config "
                         f"needs {dense_param_count(cfg)}")
    params, off = [], 0
    for fan_in, fan_out in cfg.layer_dims():
        W = vec[off:off + fan_in * fan_out].reshape(fan_in, fan_out)
        off += fan_in * fan_out
        b = vec[off:off + fan_out]
        off += fan_out
        params.append((torch.tensor(W, device=device),
                       torch.tensor(b, device=device)))
    return params


def make_forward(cfg: DLRMConfig):
    """``(params, emb[B,F,D], dense_x[B,dd]) -> logits[B]`` — the one
    forward both the train step and every serving lane share, so lane
    parity is structural (same ops, same order)."""
    n_bottom = len(cfg.bottom_mlp) + 1
    iu = np.triu_indices(cfg.fields + 1, k=1)
    n = cfg.fields + 1
    flat_iu = torch.as_tensor(iu[0] * n + iu[1], dtype=torch.int64)

    def forward(params, emb, dense_x):
        h = dense_x
        for W, b in params[:n_bottom]:
            h = torch.relu(h @ W + b)
        z = torch.cat([h[:, None, :], emb], dim=1)          # [B, F+1, D]
        prods = torch.bmm(z, z.transpose(1, 2))             # [B, F+1, F+1]
        inter = prods.reshape(prods.shape[0], -1).index_select(
            1, flat_iu.to(prods.device))                    # [B, F(F+1)/2]
        t = torch.cat([h, inter], dim=1)
        for W, b in params[n_bottom:-1]:
            t = torch.relu(t @ W + b)
        W, b = params[-1]
        return (t @ W + b)[:, 0]

    return forward


def _make_loss(cfg: DLRMConfig):
    forward = make_forward(cfg)

    def loss_fn(params, emb, dense_x, y):
        logits = forward(params, emb, dense_x)
        # Numerically stable BCE-with-logits (the JAX package's formula).
        loss = torch.mean(torch.clamp(logits, min=0.0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        return loss, torch.sigmoid(logits)

    return loss_fn


class DLRMModel:
    """The train-side model. ``mode='ps'`` keeps embeddings in PS tables
    (requires ``mv.init``; the Zoo's device); ``mode='local'`` is the
    single-worker reference twin — the same dense step, embeddings in
    tensors the model owns, updated through the server's own adagrad row
    path (on ``device``, else the ``-platform`` flag's: the card unless
    ``cpu``)."""

    def __init__(self, cfg: DLRMConfig, mode: str = "ps", dp_mesh=None,
                 dp_axis: Optional[str] = None, num_workers: int = 1,
                 device: Optional[torch.device] = None):
        check(mode in ("ps", "local"), f"bad DLRM mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        if mode == "ps":
            from multiverso_tpu_torch.core.zoo import Zoo
            zoo = Zoo.get()
            check(zoo.started, "call mv.init() before a PS DLRMModel")
            self.device = zoo.device
        else:
            self.device = resolve_device(str(flag_or("platform", "")),
                                         device)
        self.dense_params = init_dense_params(cfg, self.device)
        self._loss_fn = _make_loss(cfg)
        self._forward = make_forward(cfg)
        # The hybrid step's dense-plane merge over the data-parallel
        # axis (the identity at one rank).
        self._dense_sync = cp.build_dense_sync(dp_mesh, dp_axis)
        self._grad_bytes = dense_param_count(cfg) * 4
        self.steps = 0
        lr = cfg.learning_rate

        if mode == "ps":
            import multiverso_tpu_torch as mv
            wid = max(mv.worker_id(), 0)
            self._add_option = AddOption(worker_id=wid, learning_rate=lr,
                                         rho=cfg.adagrad_step)
            self.tables = [
                mv.create_table(MatrixTableOption(
                    num_row=cfg.vocab, num_col=cfg.embed_dim,
                    random_init=True, seed=cfg.seed + 101 + f,
                    updater="adagrad", name=cfg.table_name(f),
                    comm_policy=cfg.comm_policy or "ps"))
                for f in range(cfg.fields)]
            # Dense params ride the allreduce plane's publish surface so
            # checkpoints (and serving snapshots) carry the whole model.
            self.dense_table = mv.create_table(MatrixTableOption(
                num_row=1, num_col=dense_param_count(cfg),
                updater="sgd", name=cfg.dense_table_name,
                comm_policy="allreduce"))
            self.sync()
        else:
            self._opt_scalars = AddOption(
                worker_id=0, learning_rate=lr,
                rho=cfg.adagrad_step).scalars()
            self._updater = get_updater(np.float32, "adagrad")
            self._emb: List[torch.Tensor] = []
            self._emb_state: List[dict] = []
            for f in range(cfg.fields):
                # Bitwise the PS table's random_init (same rng, bounds,
                # dtype: tables/matrix_table.py).
                rng = np.random.default_rng(cfg.seed + 101 + f)
                self._emb.append(torch.tensor(
                    rng.uniform(-0.5, 0.5, size=(cfg.vocab, cfg.embed_dim)
                                ).astype(np.float32), device=self.device))
                self._emb_state.append(self._updater.init_state(
                    (cfg.vocab, cfg.embed_dim), torch.float32,
                    max(1, num_workers), self.device))

    # -- embedding plane ---------------------------------------------------
    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device)

    def _pull(self, field: int, ids: torch.Tensor) -> torch.Tensor:
        """Rows of one field on the device (ids clipped into range, as
        the store's Get and JAX's ``take(mode="clip")`` do)."""
        if self.mode == "ps":
            return self.tables[field].raw_rows(ids)
        clipped = ids.clamp(0, self.cfg.vocab - 1)
        return self._emb[field].index_select(0, clipped)

    def pull_rows(self, field: int, ids: np.ndarray) -> np.ndarray:
        """Current embedding rows for ``ids`` of one field — the train
        path's pull; serving lanes use runners/snapshots instead."""
        return self._pull(field, self._ids(ids)).cpu().numpy()

    def _push_rows(self, field: int, ids: torch.Tensor,
                   delta: torch.Tensor) -> None:
        if self.mode == "ps":
            self.tables[field].add_rows(ids, delta, self._add_option)
            return
        self._emb[field], self._emb_state[field] = \
            self._updater.update_rows(self._emb[field],
                                      self._emb_state[field], ids, delta,
                                      self._opt_scalars)

    def _gather(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.stack([self._pull(f, ids[:, f])
                            for f in range(self.cfg.fields)], dim=1)

    def gather_emb(self, ids: np.ndarray) -> np.ndarray:
        """[B, fields, embed_dim] rows for one batch's id matrix."""
        return self._gather(self._ids(ids)).cpu().numpy()

    # -- training ----------------------------------------------------------
    def _delta(self, emb: torch.Tensor, dense_x: torch.Tensor,
               y: torch.Tensor):
        """One autograd pass: the dense deltas ``lr * grad`` (each its
        own op), the embedding deltas, the loss and the scores."""
        lr = self.cfg.learning_rate
        leaves = [t.detach().requires_grad_(True)
                  for W, b in self.dense_params for t in (W, b)]
        emb = emb.detach().requires_grad_(True)
        params = list(zip(leaves[0::2], leaves[1::2]))
        loss, scores = self._loss_fn(params, emb, dense_x, y)
        grads = torch.autograd.grad(loss, leaves + [emb])
        deltas = [lr * g for g in grads[:-1]]
        return deltas, lr * grads[-1], loss.detach(), scores.detach()

    def step(self, ids: np.ndarray, dense_x: np.ndarray,
             labels: np.ndarray) -> Tuple[float, np.ndarray]:
        """One minibatch: pull touched rows, run the hybrid step, push
        per-field row deltas. Returns (loss, predicted scores) — the
        scores feed the streaming train AUC for free."""
        ids_t = self._ids(ids)
        with span("recsys.pull", fields=self.cfg.fields):
            emb = self._gather(ids_t)
        with span("recsys.compute", batch=len(labels)):
            deltas, demb, loss, scores = self._delta(
                emb, torch.as_tensor(np.asarray(dense_x, np.float32),
                                     device=self.device),
                torch.as_tensor(np.asarray(labels, np.float32),
                                device=self.device))
            merged = [self._dense_sync(d) for d in deltas]
            self.dense_params = [(W - merged[2 * i], b - merged[2 * i + 1])
                                 for i, (W, b) in
                                 enumerate(self.dense_params)]
            cp.record(cp.ALLREDUCE, self._grad_bytes)
        with span("recsys.push", fields=self.cfg.fields):
            for f in range(self.cfg.fields):
                # Duplicate ids within the batch are exact: the updater's
                # combine sums co-keyed deltas before the row math,
                # identically on both planes.
                self._push_rows(f, ids_t[:, f].contiguous(),
                                demb[:, f, :].contiguous())
        self.steps += 1
        return float(loss), scores.cpu().numpy()

    # -- inference ---------------------------------------------------------
    def predict(self, ids: np.ndarray, dense_x: np.ndarray) -> np.ndarray:
        """Fresh-table scores (the staleness-0 lane)."""
        return self._scores(self._gather(self._ids(ids)), dense_x)

    def scores(self, emb: np.ndarray, dense_x: np.ndarray) -> np.ndarray:
        """Scores from pre-gathered rows — the serving lanes feed rows
        from whatever plane (live runner, frozen replica) they own."""
        return self._scores(torch.as_tensor(np.asarray(emb, np.float32),
                                            device=self.device), dense_x)

    def _scores(self, emb: torch.Tensor, dense_x) -> np.ndarray:
        with torch.no_grad():
            logits = self._forward(
                self.dense_params, emb,
                torch.as_tensor(np.asarray(dense_x, np.float32),
                                device=self.device))
            return torch.sigmoid(logits).cpu().numpy()

    # -- checkpoint / publish surface --------------------------------------
    def sync(self) -> None:
        """Publish the dense replica to its PS table (ps mode) — the
        checkpoint/serving reconcile point, one dense write."""
        if self.mode == "ps":
            self.dense_table.publish(
                flatten_dense(self.dense_params)[None, :])

    def local_rows(self, field: int) -> np.ndarray:
        """Whole-table snapshot of one local-twin field (parity tests)."""
        if self.mode != "local":
            raise ValueError("local_rows is the local twin's surface")
        return self._emb[field].cpu().numpy()


class SnapshotScorer:
    """Frozen-lane scorer: dense params + embedding gather both come
    from one serving snapshot (a :class:`CheckpointReplica`'s tables),
    so a lane's predictions are wholly as-of its publish step — dense
    and sparse halves can never mix generations."""

    def __init__(self, cfg: DLRMConfig, dense_vec, row_lookup,
                 forward=None, device: Optional[torch.device] = None):
        """``row_lookup(field, ids) -> [n, embed_dim]`` rows (a tensor or
        an array). ``device`` defaults to ``dense_vec``'s when it is a
        tensor, else the ``-platform`` flag's."""
        if device is None and torch.is_tensor(dense_vec):
            device = dense_vec.device
        self.device = resolve_device(str(flag_or("platform", "")), device)
        self.cfg = cfg
        self._params = unflatten_dense(cfg, dense_vec, self.device)
        self._lookup = row_lookup
        self._forward = forward if forward is not None \
            else make_forward(cfg)

    @classmethod
    def from_snapshot(cls, cfg: DLRMConfig, snap, forward=None
                      ) -> "SnapshotScorer":
        """A scorer over one replica snapshot (``serving/replica.py``):
        the dense row and every field's table, read at f32 on the
        snapshot's device."""
        def lookup(f, ids):
            tab = snap.table(cfg.table_name(f))
            return tab.index_select(0, torch.as_tensor(
                ids, dtype=torch.int64, device=tab.device))

        return cls(cfg, snap.table(cfg.dense_table_name)[0], lookup,
                   forward=forward)

    def scores(self, ids: np.ndarray, dense_x: np.ndarray) -> np.ndarray:
        emb = torch.stack([
            torch.as_tensor(self._lookup(f, ids[:, f]), device=self.device)
            for f in range(self.cfg.fields)], dim=1)
        with torch.no_grad():
            logits = self._forward(
                self._params, emb.to(torch.float32),
                torch.as_tensor(np.asarray(dense_x, np.float32),
                                device=self.device))
            return torch.sigmoid(logits).cpu().numpy()
