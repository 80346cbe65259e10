"""Evaluation metrics on the host: exact AUC, logloss, accuracy,
``recall_at_n`` and the histogram ``StreamingAUC``.

Numpy copies of ``recommender_system_tpu/utils/metrics.py``, bit-exact with
it (``tests/test_torch_deepfm_training.py``). The JAX package builds
``StreamingAUC``'s per-batch histogram with a jitted float32 scatter-add that
drops the bin ``n_bins`` (a score that rounds to 1.0 in float32); the copy
does the same in numpy.
"""
from __future__ import annotations

import numpy as np


def auc(labels, scores) -> float:
    """Exact AUC via the rank-sum (Mann-Whitney U) formulation, with tie handling."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[i: j + 1] = 0.5 * (i + j) + 1.0  # average rank for ties
        i = j + 1
    pos_rank_sum = ranks[np.argsort(order)][labels == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def logloss(labels, probs, eps: float = 1e-7) -> float:
    labels = np.asarray(labels, np.float64).ravel()
    p = np.clip(np.asarray(probs, np.float64).ravel(), eps, 1 - eps)
    return float(-(labels * np.log(p) + (1 - labels) * np.log(1 - p)).mean())


def accuracy(labels, probs, threshold: float = 0.5) -> float:
    labels = np.asarray(labels).ravel()
    pred = (np.asarray(probs).ravel() >= threshold).astype(labels.dtype)
    return float((pred == labels).mean())


def recall_at_n(pred_item_lists, true_items) -> float:
    """Fraction of rows whose true item appears in the predicted top-N list."""
    hits = sum(1 for preds, t in zip(pred_item_lists, true_items) if t in preds)
    return hits / max(len(true_items), 1)


class StreamingAUC:
    """Histogram-binned streaming AUC.

    Scores (assumed in [0,1], e.g. sigmoid outputs) are bucketed into
    ``n_bins``; ``result()`` computes the trapezoidal AUC over the
    accumulated histograms. Error is O(1/n_bins).
    """

    def __init__(self, n_bins: int = 8192):
        self.n_bins = n_bins
        self.pos = np.zeros(n_bins, np.float64)
        self.neg = np.zeros(n_bins, np.float64)

    @staticmethod
    def _histogram(labels, scores, n_bins: int):
        scores = np.clip(np.asarray(scores, np.float32).ravel(),
                         np.float32(0.0), np.float32(1.0 - 1e-9))
        idx = (scores * np.float32(n_bins)).astype(np.int32)
        labels = np.asarray(labels).ravel().astype(np.float32)
        keep = idx < n_bins  # JAX drops out-of-range scatter updates
        pos = np.zeros(n_bins, np.float32)
        neg = np.zeros(n_bins, np.float32)
        np.add.at(pos, idx[keep], labels[keep])
        np.add.at(neg, idx[keep], np.float32(1.0) - labels[keep])
        return pos, neg

    def update(self, labels, scores, weights=None):
        if weights is not None:
            labels = np.asarray(labels)[np.asarray(weights, bool)]
            scores = np.asarray(scores)[np.asarray(weights, bool)]
        pos, neg = self._histogram(labels, scores, self.n_bins)
        self.pos += pos.astype(np.float64)
        self.neg += neg.astype(np.float64)

    def result(self) -> float:
        n_pos, n_neg = self.pos.sum(), self.neg.sum()
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        # Within a bin, positives and negatives tie -> 0.5 credit (trapezoid).
        neg_below = np.concatenate([[0.0], np.cumsum(self.neg)[:-1]])
        u = (self.pos * (neg_below + 0.5 * self.neg)).sum()
        return float(u / (n_pos * n_neg))
