"""Binary evaluation metrics — counterpart of the binary panel of
`embiggen_tpu/ops/metrics.py` (`binary_auroc`, `binary_auprc`,
`all_binary_metrics`). Host numpy: AUROC is the Mann-Whitney U statistic
with midrank ties, AUPRC the step integral of sklearn's
`average_precision_score`; both share one stable sort of the scores."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def binary_auroc(
    labels: np.ndarray, scores: np.ndarray, order: Optional[np.ndarray] = None
) -> float:
    """Area under ROC. `order` may supply an ascending stable argsort of
    `scores`."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    if order is None:
        order = np.argsort(scores, kind="stable")
    sorted_scores = scores[order]
    grp = np.concatenate([[0], np.cumsum(sorted_scores[1:] != sorted_scores[:-1])])
    counts = np.bincount(grp)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # A tie group at sorted positions [a, a + c) has midrank a + (c + 1) / 2.
    mid = starts[grp] + (counts[grp] + 1) / 2.0
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = mid
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


def binary_auprc(
    labels: np.ndarray, scores: np.ndarray, order: Optional[np.ndarray] = None
) -> float:
    """Area under precision-recall by step integration. `order` may supply
    a descending argsort of `scores` (tied thresholds collapse, so the order
    inside a tie does not matter)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    if n_pos == 0:
        return float("nan")
    if order is None:
        order = np.argsort(-scores, kind="stable")
    sorted_labels = labels[order].astype(np.float64)
    sorted_scores = scores[order]
    tp = np.cumsum(sorted_labels)
    fp = np.cumsum(1.0 - sorted_labels)
    distinct = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.concatenate([distinct, [len(sorted_scores) - 1]])
    tp, fp = tp[idx], fp[idx]
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def all_binary_metrics(
    labels: np.ndarray, scores: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """The binary panel at `threshold`, with AUROC and AUPRC."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores)
    preds = scores > threshold
    tp = float((preds & labels).sum())
    tn = float((~preds & ~labels).sum())
    fp = float((preds & ~labels).sum())
    fn = float((~preds & labels).sum())
    n = tp + tn + fp + fn

    def safe(a, b):
        return a / b if b > 0 else 0.0

    precision = safe(tp, tp + fp)
    recall = safe(tp, tp + fn)
    specificity = safe(tn, tn + fp)
    mcc_den = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    order = np.argsort(scores, kind="stable")
    scores64 = scores.astype(np.float64, copy=False)
    return {
        "accuracy": safe(tp + tn, n),
        "balanced_accuracy": (recall + specificity) / 2,
        "precision": precision,
        "recall": recall,
        "specificity": specificity,
        "f1_score": safe(2 * precision * recall, precision + recall),
        "matthews_correlation_coefficient": (
            float((tp * tn - fp * fn) / mcc_den) if mcc_den > 0 else 0.0
        ),
        "auroc": binary_auroc(labels, scores64, order=order),
        "auprc": binary_auprc(labels, scores64, order=order[::-1]),
        "true_positives": tp,
        "true_negatives": tn,
        "false_positives": fp,
        "false_negatives": fn,
    }
