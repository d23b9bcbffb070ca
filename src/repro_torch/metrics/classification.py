"""Classification metrics in pure numpy (a copy of ``auroc`` and
``auprc`` from ``src/repro/metrics/classification.py``).

For multilabel / multiclass tasks, scores are macro-averaged over label
columns, matching the paper's per-task reporting. BlendAvg scores its
candidates with these on the host.
"""
from __future__ import annotations

import numpy as np


def _binary_auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUROC via the Mann-Whitney U statistic (handles ties by mid-ranks)."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    n_pos = float(y_true.sum())
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    sorted_scores = y_score[order]
    # vectorized mid-ranks for ties: group equal scores, assign each group
    # the mean of its 1-based rank range (the hot path of BlendAvg scoring
    # — a Python tie loop here dominated the aggregation wall time)
    n = len(sorted_scores)
    new_group = np.r_[True, sorted_scores[1:] != sorted_scores[:-1]]
    grp = np.cumsum(new_group) - 1
    counts = np.bincount(grp)
    ends = np.cumsum(counts).astype(np.float64)
    mid = ends - (counts - 1) / 2.0
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = mid[grp]
    rank_sum_pos = ranks[y_true == 1].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _binary_auprc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision (step-wise interpolation, sklearn-compatible)."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    n_pos = y_true.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    precision = tp / (tp + fp)
    recall = tp / n_pos
    # AP = sum over thresholds of (R_k - R_{k-1}) * P_k
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_recall) * precision))


def _macro(metric_fn, y_true, y_score) -> float:
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    if y_true.ndim == 1:
        return metric_fn(y_true, y_score)
    vals = [metric_fn(y_true[:, c], y_score[:, c]) for c in range(y_true.shape[1])]
    vals = [v for v in vals if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float("nan")


def auroc(y_true, y_score) -> float:
    """Binary or macro-averaged multilabel AUROC."""
    return _macro(_binary_auroc, y_true, y_score)


def auprc(y_true, y_score) -> float:
    """Binary or macro-averaged multilabel average precision."""
    return _macro(_binary_auprc, y_true, y_score)
