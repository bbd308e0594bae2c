"""Sklearn-like edge-label prediction adapters — counterpart of
`embiggen_tpu/models/edge_label_prediction/sklearn_like.py`: any classifier
with `fit` and `predict_proba` (or `decision_function`) over edge
embeddings of the typed arcs (with the support graph's metric columns when
`use_edge_metrics`), the probabilities mapped from the estimator's
`classes_` back onto the graph's full class space; plus the 17 named rows
over sklearn's classifiers.

The features are built on the model's `device` and downloaded once per
call; on a CUDA device the metric columns come from K8 at a cap of the
support's largest degree. A named row imports sklearn when it is built and
raises ModuleNotFoundError where sklearn is not installed; an estimator
passed as `model_instance` runs anywhere. `device` never reaches the
estimator.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ...graph.graph import Graph
from ...transformers.tasks import EdgeLabelPredictionTransformer
from ...utils.sklearn_compat import predict_proba_compat
from ..registry import register_model
from ..sklearn_backend import edge_metric_columns, sklearn_estimator
from .model import AbstractEdgeLabelPredictionModel


class SklearnEdgeLabelPredictionAdapter(AbstractEdgeLabelPredictionModel):
    def __init__(
        self,
        model_instance=None,
        edge_embedding_methods: Union[List[str], str] = "Concatenate",
        use_edge_metrics: bool = False,
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
        self._edge_embedding_methods = (
            [edge_embedding_methods]
            if isinstance(edge_embedding_methods, str)
            else list(edge_embedding_methods)
        )
        # Support-graph topological metric columns appended to the edge
        # features; built at fit time over the fit's support.
        self._use_edge_metrics = use_edge_metrics
        self._metric_columns = None
        super().__init__(random_state=random_state, device=device)

    def _default_model_instance(self, random_state: int, **kwargs):
        raise ValueError(
            "SklearnEdgeLabelPredictionAdapter requires a model_instance."
        )

    @classmethod
    def model_name(cls) -> str:
        return "Sklearn-like Edge Label Prediction Adapter"

    @classmethod
    def library_name(cls) -> str:
        return "scikit-learn"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "edge_embedding_methods": self._edge_embedding_methods,
            "use_edge_metrics": self._use_edge_metrics,
            **self._model_kwargs,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {}

    def is_binary_prediction_task(self) -> bool:
        return self._n_classes == 2

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        if not node_features:
            raise ValueError(f"{self.model_name()} requires node features.")
        feats = self.concatenate_features(node_features)
        self._transformer = EdgeLabelPredictionTransformer(
            methods=self._edge_embedding_methods, aligned_mapping=True,
            device=self.device,
        )
        self._transformer.fit(feats)
        self._n_classes = graph.number_of_edge_types
        self._metric_columns = (
            edge_metric_columns(support, self.device)
            if self._use_edge_metrics else None
        )
        x, y = self._transformer.transform(
            graph, extra_features_fn=self._metric_columns
        )
        self._model_instance.fit(x, y)

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        edge_tr = self._transformer._edge_transformer
        x = edge_tr.transform_tensor(graph.sources, graph.col_idx)
        if self._metric_columns is not None:
            x = torch.cat([x, torch.as_tensor(
                self._metric_columns(graph.sources, graph.col_idx), device=x.device)], dim=1)
        x = x.cpu().numpy()
        proba = predict_proba_compat(self._model_instance, x)
        classes = self._model_instance.classes_
        out = np.zeros((x.shape[0], self._n_classes), dtype=np.float64)
        out[:, np.asarray(classes, int)] = proba
        return out


def _make_wrapper(name: str, factory_path: str, defaults: dict):
    def _default_model_instance(self, random_state: int, **kwargs):
        return sklearn_estimator(name, "Edge Label Prediction", factory_path,
                                 defaults, random_state, kwargs)

    wrapper = type(
        name.replace(" ", "").replace("-", "") + "EdgeLabelPrediction",
        (SklearnEdgeLabelPredictionAdapter,),
        {
            "_default_model_instance": _default_model_instance,
            "model_name": classmethod(lambda cls: name),
            "__doc__": f"{name} over edge embeddings (sklearn backend).",
        },
    )
    return register_model(wrapper)


SKLEARN_EDGE_LABEL_MODELS = {
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
    for name, (path, defaults) in SKLEARN_EDGE_LABEL_MODELS.items()
}
globals().update({cls.__name__: cls for cls in _WRAPPERS.values()})
