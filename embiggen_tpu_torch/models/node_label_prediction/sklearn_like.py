"""Sklearn-like node-label prediction adapters — counterpart of
`embiggen_tpu/models/node_label_prediction/sklearn_like.py`: any classifier
with `fit` and `predict_proba` (or `decision_function`) over the node
features of the labelled nodes, a multilabel task wrapped in sklearn's
`MultiOutputClassifier` (which needs sklearn), and the probabilities mapped
from the estimator's `classes_` back onto the graph's full class space;
plus the 18 named rows over sklearn's classifiers, "MLP Regression" among
them.

The training rows are gathered on the model's `device` and downloaded once.
A named row imports sklearn when it is built and raises ModuleNotFoundError
where sklearn is not installed; an estimator passed as `model_instance`
runs anywhere. `device` never reaches the estimator.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ...graph.graph import Graph
from ...transformers.tasks import NodeLabelPredictionTransformer
from ...utils.sklearn_compat import predict_proba_compat
from ..registry import register_model
from ..sklearn_backend import sklearn_estimator
from .model import AbstractNodeLabelPredictionModel


class SklearnNodeLabelPredictionAdapter(AbstractNodeLabelPredictionModel):
    def __init__(
        self,
        model_instance=None,
        random_state: int = 42,
        device: Union[str, torch.device] = "cuda",
        **model_kwargs,
    ):
        if model_instance is None:
            model_instance = self._default_model_instance(
                random_state=random_state, **model_kwargs
            )
        self._model_instance = model_instance
        self._model_kwargs = model_kwargs
        super().__init__(random_state=random_state, device=device)

    def _default_model_instance(self, random_state: int, **kwargs):
        raise ValueError(
            "SklearnNodeLabelPredictionAdapter requires a model_instance."
        )

    @classmethod
    def model_name(cls) -> str:
        return "Sklearn-like Node Label Prediction Adapter"

    @classmethod
    def library_name(cls) -> str:
        return "scikit-learn"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), **self._model_kwargs}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {}

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        if not node_features:
            raise ValueError(
                f"{self.model_name()} requires node features."
            )
        feats = self.concatenate_features(node_features)
        self._transformer = NodeLabelPredictionTransformer(
            aligned_mapping=True, device=self.device
        )
        self._transformer.fit(feats)
        self._feats = feats
        x, y = self._transformer.transform(graph)
        self._multilabel = graph.has_multilabel_node_types()
        self._n_classes = graph.number_of_node_types
        if self._multilabel:
            from sklearn.multioutput import MultiOutputClassifier

            self._model_instance = MultiOutputClassifier(self._model_instance)
        self._model_instance.fit(x, y)

    def is_multilabel_prediction_task(self) -> bool:
        return self._multilabel

    def is_binary_prediction_task(self) -> bool:
        return self._n_classes == 2 and not self._multilabel

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        x = self._feats
        proba = (
            self._model_instance.predict_proba(x)
            if self._multilabel
            else predict_proba_compat(self._model_instance, x)
        )
        if self._multilabel:
            # list of [N, 2] per class -> [N, n_classes] positive-class prob
            return np.stack([p[:, -1] for p in proba], axis=1)
        # Map trained-class columns back onto the full class space.
        classes = self._model_instance.classes_
        out = np.zeros((x.shape[0], self._n_classes), dtype=np.float64)
        out[:, np.asarray(classes, int)] = proba
        return out


def _make_wrapper(name: str, factory_path: str, defaults: dict):
    def _default_model_instance(self, random_state: int, **kwargs):
        return sklearn_estimator(name, "Node Label Prediction", factory_path,
                                 defaults, random_state, kwargs)

    wrapper = type(
        name.replace(" ", "").replace("-", "") + "NodeLabelPrediction",
        (SklearnNodeLabelPredictionAdapter,),
        {
            "_default_model_instance": _default_model_instance,
            "model_name": classmethod(lambda cls: name),
            "__doc__": f"{name} over node features (sklearn backend).",
        },
    )
    return register_model(wrapper)


SKLEARN_NODE_LABEL_MODELS = {
    "Random Forest Classifier": (
        "sklearn.ensemble.RandomForestClassifier", {"n_estimators": 100}
    ),
    "Extra Trees Classifier": (
        "sklearn.ensemble.ExtraTreesClassifier", {"n_estimators": 100}
    ),
    "Decision Tree Classifier": ("sklearn.tree.DecisionTreeClassifier", {}),
    "Logistic Regression Classifier": (
        "sklearn.linear_model.LogisticRegression", {"max_iter": 1000}
    ),
    "Gradient Boosting Classifier": (
        "sklearn.ensemble.GradientBoostingClassifier", {}
    ),
    "AdaBoost Classifier": ("sklearn.ensemble.AdaBoostClassifier", {}),
    "Bagging Classifier": ("sklearn.ensemble.BaggingClassifier", {}),
    "K-Neighbour Classifier": ("sklearn.neighbors.KNeighborsClassifier", {}),
    "Gaussian Naive Bayes": ("sklearn.naive_bayes.GaussianNB", {}),
    "MLP Classifier": (
        "sklearn.neural_network.MLPClassifier", {"max_iter": 500}
    ),
    # A second MLPClassifier row, for node-label prediction only.
    "MLP Regression": (
        "sklearn.neural_network.MLPClassifier", {"max_iter": 200}
    ),
    "Hist Gradient Boosting Classifier": (
        "sklearn.ensemble.HistGradientBoostingClassifier", {}
    ),
    "Linear Support Vector Classifier": (
        "sklearn.svm.LinearSVC",
        {"class_weight": "balanced", "max_iter": 1000, "dual": "auto"},
    ),
    "Nu Support Vector Classifier": ("sklearn.svm.NuSVC", {}),
    "Radius Neighbour Classifier": (
        "sklearn.neighbors.RadiusNeighborsClassifier",
        {"outlier_label": "most_frequent"},
    ),
    "Logistic Regression Cross Validator": (
        "sklearn.linear_model.LogisticRegressionCV", {"max_iter": 1000}
    ),
    "Ridge Classifier": ("sklearn.linear_model.RidgeClassifier", {}),
    "Ridge Classifier Cross Validator": (
        "sklearn.linear_model.RidgeClassifierCV", {}
    ),
}

_WRAPPERS = {
    name: _make_wrapper(name, path, defaults)
    for name, (path, defaults) in SKLEARN_NODE_LABEL_MODELS.items()
}
globals().update({cls.__name__: cls for cls in _WRAPPERS.values()})
