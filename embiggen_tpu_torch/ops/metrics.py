"""Binary evaluation metrics — counterpart of the binary panel of
`embiggen_tpu/ops/metrics.py` (`binary_auroc`, `binary_auprc`,
`all_binary_metrics`). AUROC is the Mann-Whitney U statistic with midrank
ties, AUPRC the step integral of sklearn's `average_precision_score`; as in
the reference, both come from one stable radix argsort of the scores
(`native.radix_argsort` over an order-preserving bit transform: 4 byte
passes for float32) and one sweep over the sorted scores
(`native.ranking_metrics_sorted`)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import native


def _stable_argsort(x: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of float scores, the order of
    `np.argsort(x, kind="stable")`: -0.0 and every NaN are made +0.0 and
    one NaN first, then the bits are flipped so that unsigned order is
    float order (float32 keys in 32 bits, so the radix takes 4 passes)."""
    x = np.asarray(x)
    if x.dtype != np.float32:
        x = x.astype(np.float64, copy=False)
    x = x + x.dtype.type(0)            # -0.0 + 0.0 is +0.0
    nan = np.isnan(x)
    if nan.any():
        x[nan] = np.nan
    if x.dtype == np.float32:
        bits = x.view(np.uint32)
        flip = np.where(bits >> np.uint32(31) != 0, np.uint32(0xFFFFFFFF),
                        np.uint32(0x80000000))
        keys = (bits ^ flip).astype(np.uint64)
    else:
        bits = x.view(np.uint64)
        keys = bits ^ np.where(bits >> np.uint64(63) != 0, np.uint64(0xFFFFFFFFFFFFFFFF),
                               np.uint64(0x8000000000000000))
    return native.radix_argsort(keys)


def _sweep(labels: np.ndarray, scores: np.ndarray, ascending: np.ndarray):
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    return native.ranking_metrics_sorted(scores[ascending], labels[ascending])


def binary_auroc(
    labels: np.ndarray, scores: np.ndarray, order: Optional[np.ndarray] = None
) -> float:
    """Area under ROC. `order` may supply an ascending stable argsort of
    `scores`."""
    return _sweep(labels, scores, _stable_argsort(scores) if order is None else order)[0]


def binary_auprc(
    labels: np.ndarray, scores: np.ndarray, order: Optional[np.ndarray] = None
) -> float:
    """Area under precision-recall by step integration. `order` may supply
    a descending argsort of `scores` (tied thresholds collapse, so the order
    inside a tie does not matter)."""
    ascending = _stable_argsort(scores) if order is None else np.asarray(order)[::-1]
    return _sweep(labels, scores, ascending)[1]


def _ranking_pair(labels: np.ndarray, scores: np.ndarray) -> Dict[str, float]:
    """AUROC and AUPRC from one sort and one sweep."""
    auroc, auprc = _sweep(labels, scores, _stable_argsort(scores))
    return {"auroc": auroc, "auprc": auprc}


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
    ranking = _ranking_pair(labels, scores)
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
        "auroc": ranking["auroc"],
        "auprc": ranking["auprc"],
        "true_positives": tp,
        "true_negatives": tn,
        "false_positives": fp,
        "false_negatives": fn,
    }
