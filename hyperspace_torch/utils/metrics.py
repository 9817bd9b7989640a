"""Evaluation metrics (counterpart of ``hyperspace_tpu/utils/metrics.py``):
ROC-AUC, rank-based (Mann–Whitney U) with tie-averaged ranks, and
accuracy."""

from __future__ import annotations

import numpy as np


def roc_auc(scores_pos: np.ndarray, scores_neg: np.ndarray) -> float:
    """AUC = P(score_pos > score_neg), ties counted half."""
    s = np.concatenate([np.asarray(scores_pos),
                        np.asarray(scores_neg)]).astype(np.float64)
    n_pos, n_neg = len(scores_pos), len(scores_neg)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(s)
    ranks[order] = np.arange(1, len(s) + 1, dtype=np.float64)
    sorted_s = s[order]
    uniq, inv, counts = np.unique(sorted_s, return_inverse=True,
                                  return_counts=True)
    if len(uniq) != len(s):
        cum = np.cumsum(counts)
        avg = (cum - (counts - 1) / 2.0).astype(np.float64)
        ranks[order] = avg[inv]
    r_pos = ranks[:n_pos].sum()
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def accuracy(logits: np.ndarray, labels: np.ndarray,
             mask: np.ndarray | None = None) -> float:
    """Share of rows whose arg-max logit is the label (over ``mask``'s
    rows when given)."""
    pred = np.asarray(logits).argmax(-1)
    correct = (pred == np.asarray(labels)).astype(np.float64)
    if mask is not None:
        mask = np.asarray(mask, np.float64)
        return float((correct * mask).sum() / np.maximum(mask.sum(), 1.0))
    return float(correct.mean())
