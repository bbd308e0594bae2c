"""Sklearn-like edge prediction adapters — counterpart of
`embiggen_tpu/models/edge_prediction/sklearn_like.py`: any classifier with
`fit` and `predict_proba` (or `decision_function`) over edge embeddings of
node features, trained on the graph's arcs against as many negatives (times
`training_unbalance_rate`, scale-free by default) and scoring in chunks of
`prediction_batch_size` pairs; plus the 18 named rows over sklearn's
classifiers.

The features are built on the model's `device` (the card unless the caller
asks for the CPU) and downloaded once per fit and once per chunk; the
negatives' membership test runs there too (K5 on the card). The estimator
runs on the host. A named row imports sklearn when it is built, and raises
ModuleNotFoundError where sklearn is not installed; an estimator passed as
`model_instance` runs anywhere. `device` is the port's own parameter and
never reaches the estimator.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ...graph.graph import Graph
from ...graph.sampling import sample_negative_graph
from ...transformers.tasks import EdgePredictionTransformer
from ...utils.sklearn_compat import predict_proba_compat
from ..registry import register_model
from ..sklearn_backend import edge_metric_columns, sklearn_estimator
from .model import AbstractEdgePredictionModel

PREDICTION_BATCH_SIZE = 2 ** 15  # the reference's chunk of pairs


class SklearnEdgePredictionAdapter(AbstractEdgePredictionModel):
    """Wrap any sklearn-style classifier (fit/predict_proba) for link
    prediction over edge embeddings of node features."""

    def __init__(
        self,
        model_instance=None,
        edge_embedding_methods: Union[List[str], str] = "Concatenate",
        training_unbalance_rate: float = 1.0,
        use_scale_free_distribution: bool = True,
        use_edge_metrics: bool = False,
        prediction_batch_size: int = PREDICTION_BATCH_SIZE,
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
        self._training_unbalance_rate = training_unbalance_rate
        self._use_scale_free_distribution = use_scale_free_distribution
        # Support-graph topological metric columns (Adamic-Adar, Jaccard,
        # resource allocation, log1p preferential attachment) appended to
        # the edge features; built at fit time over the fit's support.
        self._use_edge_metrics = use_edge_metrics
        self._metric_columns = None
        self._prediction_batch_size = prediction_batch_size
        super().__init__(random_state=random_state, device=device)

    def _default_model_instance(self, random_state: int, **kwargs):
        raise ValueError(
            "SklearnEdgePredictionAdapter requires a model_instance."
        )

    @classmethod
    def model_name(cls) -> str:
        return "Sklearn-like Edge Prediction Adapter"

    @classmethod
    def library_name(cls) -> str:
        return "scikit-learn"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "edge_embedding_methods": self._edge_embedding_methods,
            "training_unbalance_rate": self._training_unbalance_rate,
            "use_scale_free_distribution": self._use_scale_free_distribution,
            "use_edge_metrics": self._use_edge_metrics,
            **self._model_kwargs,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {}

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        if not node_features:
            raise ValueError(
                f"{self.model_name()} requires node features (e.g. an "
                "embedding) for edge prediction."
            )
        feats = self.concatenate_features(node_features)
        self._transformer = EdgePredictionTransformer(
            methods=self._edge_embedding_methods, aligned_mapping=True,
            device=self.device,
        )
        self._transformer.fit(feats)
        n_neg = max(
            1,
            int(
                round(
                    graph.number_of_edges * self._training_unbalance_rate
                )
            ),
        )
        neg = sample_negative_graph(
            graph,
            number_of_negative_samples=n_neg,
            random_state=self.random_state or 42,
            use_scale_free_distribution=self._use_scale_free_distribution,
            support=support,
            device=self.device,
        )
        self._metric_columns = (
            edge_metric_columns(support, self.device)
            if self._use_edge_metrics else None
        )
        x, y = self._transformer.transform(
            graph, neg, shuffle=True, random_state=self.random_state or 42,
            extra_features_fn=self._edge_metrics_fn(),
        )
        self._model_instance.fit(x, y)

    def _edge_metrics_fn(self):
        """Aligned metric-column producer over the fit support graph, or
        None when `use_edge_metrics` is off."""
        if not self._use_edge_metrics:
            return None
        if self._metric_columns is None:
            raise ValueError(
                "use_edge_metrics requires the model to be fitted first."
            )
        return self._metric_columns

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        return self.predict_proba_from_edge_node_ids(
            graph.sources, graph.col_idx
        )

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray, **kwargs
    ) -> np.ndarray:
        out = []
        bs = self._prediction_batch_size
        edge_tr = self._transformer._graph_transformer._edge_transformer
        metric_fn = self._edge_metrics_fn()
        for i in range(0, len(src), bs):
            s, d = src[i: i + bs], dst[i: i + bs]
            x = edge_tr.transform_tensor(s, d)
            if metric_fn is not None:
                x = torch.cat(
                    [x, torch.as_tensor(metric_fn(s, d), device=x.device)], dim=1
                )
            proba = predict_proba_compat(self._model_instance, x.cpu().numpy())
            out.append(proba[:, -1] if proba.ndim == 2 else proba)
        return np.concatenate(out) if out else np.zeros(0)


def _make_sklearn_wrapper(name: str, factory_path: str, defaults: dict):
    """Named wrapper class around a sklearn classifier."""

    def _default_model_instance(self, random_state: int, **kwargs):
        return sklearn_estimator(name, "Edge Prediction", factory_path,
                                 defaults, random_state, kwargs)

    wrapper = type(
        name.replace(" ", "") + "EdgePrediction",
        (SklearnEdgePredictionAdapter,),
        {
            "_default_model_instance": _default_model_instance,
            "model_name": classmethod(lambda cls: name),
            "__doc__": f"{name} over edge embeddings (sklearn backend).",
        },
    )
    return register_model(wrapper)


SKLEARN_EDGE_PREDICTION_MODELS = {
    "Random Forest Classifier": (
        "sklearn.ensemble.RandomForestClassifier",
        {"n_estimators": 100},
    ),
    "Extra Trees Classifier": (
        "sklearn.ensemble.ExtraTreesClassifier",
        {"n_estimators": 100},
    ),
    "Decision Tree Classifier": ("sklearn.tree.DecisionTreeClassifier", {}),
    "Logistic Regression Classifier": (
        "sklearn.linear_model.LogisticRegression",
        {"max_iter": 1000},
    ),
    "Gradient Boosting Classifier": (
        "sklearn.ensemble.GradientBoostingClassifier",
        {},
    ),
    "AdaBoost Classifier": ("sklearn.ensemble.AdaBoostClassifier", {}),
    "Bagging Classifier": ("sklearn.ensemble.BaggingClassifier", {}),
    "K-Neighbour Classifier": (
        "sklearn.neighbors.KNeighborsClassifier",
        {},
    ),
    "Gaussian Naive Bayes": ("sklearn.naive_bayes.GaussianNB", {}),
    "MLP Classifier": (
        "sklearn.neural_network.MLPClassifier",
        {"max_iter": 500},
    ),
    "SGD Classifier": (
        "sklearn.linear_model.SGDClassifier",
        {"loss": "log_loss"},
    ),
    "Hist Gradient Boosting Classifier": (
        "sklearn.ensemble.HistGradientBoostingClassifier",
        {},
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
        "sklearn.linear_model.LogisticRegressionCV",
        {"max_iter": 1000},
    ),
    "Ridge Classifier": ("sklearn.linear_model.RidgeClassifier", {}),
    "Ridge Classifier Cross Validator": (
        "sklearn.linear_model.RidgeClassifierCV",
        {},
    ),
}

_WRAPPERS = {
    name: _make_sklearn_wrapper(name, path, defaults)
    for name, (path, defaults) in SKLEARN_EDGE_PREDICTION_MODELS.items()
}
globals().update(
    {cls.__name__: cls for cls in _WRAPPERS.values()}
)
