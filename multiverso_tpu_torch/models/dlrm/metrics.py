"""Streaming binary-classification metrics for the online recommender.

Port of ``multiverso_tpu/models/dlrm/metrics.py`` (numpy only, copied so
that the port imports nothing of the JAX package).

AUC is *the* recsys quality number (click-through ranking quality), but
the online loop never holds the full prediction stream — it sees batches
and throws them away. :class:`StreamingAUC` keeps two fixed-size score
histograms (positives / negatives over ``[0, 1]``) and computes the
rank-statistic AUC from them: every (positive, negative) pair where the
positive outscores the negative counts 1, same-bin ties count 1/2 — the
Mann-Whitney U estimator quantized to ``bins`` score buckets. Memory is
O(bins) regardless of stream length, the update is one ``bincount`` per
batch, and the quantization error vanishes as bins grow (the tier-1 test
pins it against the exact pairwise statistic on a known distribution).

Used three ways by the online loop: the train-side quality trace, the
per-staleness-lane freshness curve (one accumulator per lane), and the
int8-vs-f32 table AUC delta of a serving lane.
"""

from __future__ import annotations

import numpy as np

__all__ = ["StreamingAUC", "exact_auc"]


class StreamingAUC:
    """Histogram-based streaming AUC over scores in ``[0, 1]``.

    Scores outside the unit interval are clipped (callers feed sigmoid
    outputs, so clipping only touches float dust at the ends).
    """

    def __init__(self, bins: int = 1024):
        if bins < 2:
            raise ValueError(f"StreamingAUC needs >= 2 bins, got {bins}")
        self.bins = int(bins)
        self._pos = np.zeros(self.bins, dtype=np.int64)
        self._neg = np.zeros(self.bins, dtype=np.int64)

    def update(self, scores, labels) -> None:
        """Fold one batch of ``(score, binary label)`` pairs in."""
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        if scores.shape != labels.shape:
            raise ValueError(
                f"scores {scores.shape} vs labels {labels.shape}")
        idx = np.clip((scores * self.bins).astype(np.int64), 0,
                      self.bins - 1)
        pos = labels > 0.5
        self._pos += np.bincount(idx[pos], minlength=self.bins)
        self._neg += np.bincount(idx[~pos], minlength=self.bins)

    @property
    def positives(self) -> int:
        return int(self._pos.sum())

    @property
    def negatives(self) -> int:
        return int(self._neg.sum())

    def value(self) -> float:
        """The AUC estimate, or ``nan`` until both classes were seen."""
        P = self._pos.sum()
        N = self._neg.sum()
        if P == 0 or N == 0:
            return float("nan")
        # Negatives strictly below each bin + half of the same-bin ties.
        neg_below = np.cumsum(self._neg) - self._neg
        wins = float(np.sum(self._pos * (neg_below + 0.5 * self._neg)))
        return wins / (float(P) * float(N))

    def merge(self, other: "StreamingAUC") -> "StreamingAUC":
        """Fold another accumulator in (same binning required)."""
        if other.bins != self.bins:
            raise ValueError(f"bin mismatch {self.bins} vs {other.bins}")
        self._pos += other._pos
        self._neg += other._neg
        return self

    def reset(self) -> None:
        self._pos[:] = 0
        self._neg[:] = 0


def exact_auc(scores, labels) -> float:
    """Reference O(n log n) Mann-Whitney AUC with exact tie handling —
    the ground truth the streaming estimator is tested against (and the
    oracle the bench uses on its final held-out batch)."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1) > 0.5
    P = int(labels.sum())
    N = int(labels.size - P)
    if P == 0 or N == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    sorted_scores = scores[order]
    # Average ranks over tie groups (1-based ranks).
    i = 0
    while i < sorted_scores.size:
        j = i
        while j + 1 < sorted_scores.size \
                and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum = float(ranks[labels].sum())
    return (rank_sum - P * (P + 1) / 2.0) / (float(P) * float(N))
