"""Synthetic-but-principled impression stream for the online recommender.

Port of ``multiverso_tpu/models/dlrm/stream.py`` (numpy only, copied so
that the port imports nothing of the JAX package): a given
:class:`StreamConfig` yields the same batches in both packages.

Real CTR traffic has two properties the serving/training stack must be
exercised against, and this generator reproduces both with controllable
knobs instead of a fixed dataset file:

* **Zipfian categorical ids** — each field draws ids with the same
  ``(zipf(alpha) - 1) % vocab`` fold serve_bench's ``--zipf`` traffic
  uses, so head rows absorb most updates AND most lookups (the hot-row
  cache / hot-key sketch see the same skew the serving plane was built
  for).
* **A drifting click model** — the ground-truth click probability is a
  logistic model over per-id latent affinities plus a dense-feature
  term, and the affinities random-walk every ``drift_every``
  impressions. Under drift, a frozen table's AUC decays while the
  online learner tracks — which is exactly what makes the
  freshness-vs-staleness curve a *measurement* instead of a tautology.

Ids, labels, and drift all come from one seeded ``default_rng``: a given
``StreamConfig`` replays the identical impression sequence, which is what
makes a run replayable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["StreamConfig", "Impressions", "ImpressionStream", "zipf_ids"]


def zipf_ids(rng: np.random.Generator, alpha: float, n: int,
             vocab: int) -> np.ndarray:
    """The serve_bench ``--zipf`` id fold: unbounded Zipf draws wrapped
    into ``[0, vocab)`` so id 0 is the hottest row. ``alpha <= 1`` (the
    distribution needs a finite normalizer only for alpha > 1) falls
    back to uniform — same contract as the bench's key sampler."""
    if alpha > 1.0:
        return ((rng.zipf(alpha, n) - 1) % vocab).astype(np.int32)
    return rng.integers(0, vocab, size=n, dtype=np.int32)


@dataclasses.dataclass
class StreamConfig:
    """Shape + dynamics of the synthetic impression stream."""
    fields: int = 4             # categorical feature fields
    vocab: int = 2048           # ids per field (== embedding rows)
    dense_dim: int = 8          # continuous features per impression
    zipf: float = 1.2           # id skew (<=1.0 -> uniform)
    drift_every: int = 2048     # impressions between affinity drift steps
    drift_scale: float = 0.25   # stddev of each random-walk step
    affinity_scale: float = 1.0  # initial per-id affinity stddev (summed
    #                              over fields the logit keeps O(1) scale)
    click_bias: float = -0.5    # base-rate logit (negative: clicks rare-ish)
    seed: int = 0


@dataclasses.dataclass
class Impressions:
    """One batch: ``ids[n, fields]`` int32, ``dense[n, dense_dim]`` f32,
    ``labels[n]`` f32 in {0, 1}, and the generator's true click
    probability ``p[n]`` (the oracle — useful for debugging, never shown
    to the model)."""
    ids: np.ndarray
    dense: np.ndarray
    labels: np.ndarray
    p: np.ndarray


class ImpressionStream:
    """Seeded generator of :class:`Impressions` batches with drift.

    NOT thread-safe: one stream per driving thread (the bench's serve
    loader owns its own instance — same config, different seed — so the
    trainer's replayable sequence is never perturbed by lookup traffic).
    """

    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        scale = cfg.affinity_scale / np.sqrt(max(1, cfg.fields))
        self._theta = scale * self._rng.standard_normal(
            (cfg.fields, cfg.vocab))
        self._w_dense = self._rng.standard_normal(cfg.dense_dim) \
            / np.sqrt(max(1, cfg.dense_dim))
        self._since_drift = 0
        self.drifts = 0             # drift steps taken so far
        self.impressions = 0        # total impressions emitted

    def batch(self, n: int) -> Impressions:
        cfg = self.cfg
        rng = self._rng
        ids = np.stack([zipf_ids(rng, cfg.zipf, n, cfg.vocab)
                        for _ in range(cfg.fields)], axis=1)
        dense = rng.standard_normal((n, cfg.dense_dim)).astype(np.float32)
        logit = cfg.click_bias \
            + self._theta[np.arange(cfg.fields), ids].sum(axis=1) \
            + dense @ self._w_dense
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(n) < p).astype(np.float32)
        self.impressions += n
        self._since_drift += n
        while self._since_drift >= cfg.drift_every > 0:
            self._since_drift -= cfg.drift_every
            self._drift()
        return Impressions(ids=ids.astype(np.int32), dense=dense,
                           labels=labels, p=p)

    def _drift(self) -> None:
        """One random-walk step of every id's latent affinity. The head
        ids drift with everyone else, so the hottest (= most-served)
        rows are also the ones whose ground truth moves — staleness
        costs AUC where traffic actually lands."""
        self._theta += self.cfg.drift_scale * self._rng.standard_normal(
            self._theta.shape)
        self.drifts += 1

    def key_batch(self, n: int, field: int = 0) -> np.ndarray:
        """Lookup keys only (no labels, no drift tick) — the serve-load
        sampler, drawing from the same skew the trainer writes under."""
        return zipf_ids(self._rng, self.cfg.zipf, n, self.cfg.vocab)
