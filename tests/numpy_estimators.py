"""Two estimators in numpy alone, with sklearn's fit / predict_proba /
decision_function surface, for the sklearn-like adapters' tests on hosts
without sklearn (the card's has none)."""
import numpy as np


def _with_bias(x):
    x = np.asarray(x, dtype=np.float64)
    return np.hstack([x, np.ones((len(x), 1))])


class LeastSquaresClassifier:
    """Linear least squares to +-1 targets (one-vs-rest for more than two
    classes); exposes `decision_function` only, as sklearn's
    RidgeClassifier does."""

    def fit(self, x, y):
        self.classes_ = np.unique(y)
        targets = (np.asarray(y)[:, None] == self.classes_[None, :]) * 2.0 - 1.0
        if len(self.classes_) == 2:
            targets = targets[:, 1]
        self.coef_ = np.linalg.lstsq(_with_bias(x), targets, rcond=None)[0]
        return self

    def decision_function(self, x):
        return _with_bias(x) @ self.coef_


class CentroidClassifier:
    """Softmax over minus the squared distances to the class means (scaled
    by the width), with `predict_proba` and `classes_`."""

    def fit(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        self.classes_ = np.unique(y)
        self.centroids_ = np.stack([x[y == c].mean(axis=0) for c in self.classes_])
        return self

    def predict_proba(self, x):
        x = np.asarray(x, dtype=np.float64)
        d2 = ((x * x).sum(axis=1)[:, None] - 2.0 * x @ self.centroids_.T
              + (self.centroids_ ** 2).sum(axis=1)[None, :])
        logits = -d2 / x.shape[1]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
