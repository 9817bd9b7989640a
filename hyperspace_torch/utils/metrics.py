"""Evaluation metrics (counterpart of ``hyperspace_tpu/utils/metrics.py``):
ROC-AUC, rank-based (Mann–Whitney U) with tie-averaged ranks, accuracy
and macro-F1."""

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


def f1_macro(logits: np.ndarray, labels: np.ndarray, num_classes: int,
             mask: np.ndarray | None = None) -> float:
    """Mean F1 over the classes that occur as a label or a prediction
    (over ``mask``'s rows when given); 0 when none does."""
    pred = np.asarray(logits).argmax(-1)
    labels = np.asarray(labels)
    if mask is not None:
        keep = np.asarray(mask, bool)
        pred, labels = pred[keep], labels[keep]
    f1s = []
    for k in range(num_classes):
        tp = float(((pred == k) & (labels == k)).sum())
        fp = float(((pred == k) & (labels != k)).sum())
        fn = float(((pred != k) & (labels == k)).sum())
        denom = 2 * tp + fp + fn
        if denom > 0:
            f1s.append(2 * tp / denom)
    return float(np.mean(f1s)) if f1s else 0.0
