"""Detection metrics: AUC (rank statistic) and F1 at an FPR-derived
threshold (paper Appendix B).  numpy copy of ``repro.detection.metrics``."""
from __future__ import annotations

import numpy as np


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under ROC via the Mann-Whitney U statistic (ties handled)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def threshold_at_fpr(scores_benign: np.ndarray, fpr: float) -> float:
    """Score threshold with the given false-positive rate on benign scores."""
    return float(np.quantile(np.asarray(scores_benign, np.float64), 1.0 - fpr))


def f1_at_fpr(scores: np.ndarray, labels: np.ndarray, fpr: float) -> float:
    """F1 of ``scores > threshold_at_fpr(benign scores, fpr)``: NaN when
    every record is an attack (no benign score to set the threshold), 0.0
    when none is."""
    scores = np.asarray(scores)
    labels = np.asarray(labels).astype(bool)
    if labels.all():
        return float("nan")
    thr = threshold_at_fpr(scores[~labels], fpr)
    pred = scores > thr
    tp = int((pred & labels).sum())
    fp = int((pred & ~labels).sum())
    fn = int((~pred & labels).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    if prec + rec == 0:
        return 0.0
    return float(2 * prec * rec / (prec + rec))
