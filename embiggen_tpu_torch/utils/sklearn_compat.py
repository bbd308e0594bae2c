"""Probability surface of sklearn-style classifiers — counterpart of
`embiggen_tpu/utils/sklearn_compat.py`: `predict_proba` where the model has
it, else its `decision_function` margins squashed (logistic for one column,
softmax for one-vs-rest columns). numpy only."""
from __future__ import annotations

import numpy as np


def predict_proba_compat(model, x: np.ndarray) -> np.ndarray:
    """Return an ``[N, n_classes]`` probability-like matrix for any sklearn
    classifier, falling back to squashed decision margins."""
    if hasattr(model, "predict_proba"):
        return np.asarray(model.predict_proba(x))
    if hasattr(model, "decision_function"):
        margin = np.asarray(model.decision_function(x), dtype=np.float64)
        if margin.ndim == 1:
            pos = 1.0 / (1.0 + np.exp(-margin))
            return np.stack([1.0 - pos, pos], axis=1)
        # multiclass one-vs-rest margins -> softmax
        margin = margin - margin.max(axis=1, keepdims=True)
        e = np.exp(margin)
        return e / e.sum(axis=1, keepdims=True)
    raise AttributeError(
        f"{type(model).__name__} exposes neither predict_proba nor "
        "decision_function."
    )
