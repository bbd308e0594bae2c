"""Evaluation metrics — counterpart of `embiggen_tpu/ops/metrics.py`
(`binary_auroc`, `binary_auprc`, `all_binary_metrics`,
`multiclass_metrics`). AUROC is the Mann-Whitney U statistic with midrank
ties, AUPRC the step integral of sklearn's `average_precision_score`; as in
the reference, both come from one stable radix argsort of the scores
(`native.radix_argsort` over an order-preserving bit transform: 4 byte
passes for float32) and one sweep over the sorted scores
(`native.ranking_metrics_sorted`). The multiclass and multilabel panel is
numpy with the numbers of the reference's sklearn calls, its one-vs-rest
AUROC the binary AUROC one class at a time."""
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


def _safe_divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (sklearn's zero_division=0)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _class_counts(labels: np.ndarray, preds: np.ndarray):
    """(true positives, predicted, true) counts per class, over the sorted
    classes that occur in the labels or the predictions."""
    classes = np.union1d(labels, preds)
    label_ids = np.searchsorted(classes, labels)
    true = np.bincount(label_ids, minlength=len(classes))
    pred = np.bincount(np.searchsorted(classes, preds), minlength=len(classes))
    tp = np.bincount(label_ids[labels == preds], minlength=len(classes))
    return tp, pred, true


def _macro_scores(tp, pred, true) -> Dict[str, float]:
    """Macro F1, precision and recall from per-class true positive,
    predicted and true counts, as sklearn's precision_recall_fscore_support
    with zero_division=0 (F1 = 2 tp / (true + pred))."""
    return {"f1_score": float(np.mean(_safe_divide(2.0 * tp, true + pred))),
            "precision": float(np.mean(_safe_divide(tp, pred))),
            "recall": float(np.mean(_safe_divide(tp, true)))}


def _ovr_auroc(onehot: np.ndarray, scores: np.ndarray) -> float:
    """Mean over the columns of the binary AUROC of column c's scores
    against column c's labels; nan when a column holds one class."""
    onehot = onehot.astype(bool)
    counts = onehot.sum(axis=0)
    if ((counts == 0) | (counts == len(onehot))).any():
        return float("nan")
    return float(np.mean([binary_auroc(onehot[:, c], scores[:, c])
                          for c in range(onehot.shape[1])]))


def multiclass_metrics(
    labels: np.ndarray, probabilities: np.ndarray, multilabel: bool = False,
) -> Dict[str, float]:
    """The multiclass panel (labels [n] class ids, probabilities [n, C],
    predictions their argmax): accuracy, balanced accuracy (the mean recall
    over the classes present in the labels), macro F1, precision and recall
    over the classes in the labels or the predictions (0 for a zero
    denominator), and the macro one-vs-rest AUROC, nan unless the labels
    hold exactly C > 2 classes, the probabilities are finite and each row
    sums to 1 within `np.allclose`. The multilabel panel (labels and
    probabilities [n, C], predictions probability > 0.5): subset accuracy,
    hamming loss, macro and micro F1, and the macro AUROC over the columns,
    nan where a column holds one class or a probability is not finite. A
    one-column multilabel panel is sklearn's binary one: its F1 scores
    average over the values 0 and 1 where they occur."""
    probabilities = np.asarray(probabilities)
    labels = np.asarray(labels)
    finite = bool(np.isfinite(probabilities).all())
    if multilabel:
        truth = labels != 0
        preds = probabilities > 0.5
        if truth.shape[1] == 1:
            tp, pred, true = _class_counts(truth[:, 0], preds[:, 0])
        else:
            tp = (truth & preds).sum(axis=0)
            pred, true = preds.sum(axis=0), truth.sum(axis=0)
        return {
            "accuracy": float(np.mean((truth == preds).all(axis=1))),
            "hamming_loss": float(np.count_nonzero(truth != preds) / truth.size),
            "f1_score_macro": _macro_scores(tp, pred, true)["f1_score"],
            "f1_score_micro": float(_safe_divide(2.0 * tp.sum(), true.sum() + pred.sum())),
            "auroc_macro_ovr": (_ovr_auroc(truth, probabilities) if finite
                                else float("nan")),
        }
    preds = probabilities.argmax(axis=1)
    tp, pred, true = _class_counts(labels, preds)
    out = {"accuracy": float(np.mean(labels == preds)),
           "balanced_accuracy": float(np.mean(tp[true > 0] / true[true > 0]))}
    out.update({f"{k}_macro": v for k, v in _macro_scores(tp, pred, true).items()})
    present = np.unique(labels)
    auroc = float("nan")
    if (len(present) == probabilities.shape[1] and len(present) > 2 and finite
            and np.allclose(1, probabilities.sum(axis=1))):
        # Column j scores the j-th class present, in sorted order.
        auroc = _ovr_auroc(labels[:, None] == present[None, :], probabilities)
    out["auroc_macro_ovr"] = auroc
    return out
