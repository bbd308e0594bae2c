"""AbstractClassifierModel — counterpart of
`embiggen_tpu/models/classifier.py`: feature normalization (model names,
embedding models, EmbeddingResults, DataFrames and arrays become aligned
[n_nodes, d] float32 matrices, with holdout-biased feature models deferred),
the fit / predict / predict_proba verbs, the binary, multiclass and
multilabel metric panels and the model-level holdout evaluation
(`evaluate`, through `pipelines/evaluation.py`).

A model runs on the explicit `device` it is given (default "cuda") and
never moves elsewhere on its own; the device is not a hyper-parameter, so
it stays out of `parameters()` and the hash.
"""
from __future__ import annotations

import os
import platform
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..graph.graph import Graph
from ..ops.metrics import all_binary_metrics, multiclass_metrics
from .abstract import AbstractEmbeddingModel, AbstractModel
from .embedding_result import EmbeddingResult

FeatureLike = Union[str, AbstractEmbeddingModel, EmbeddingResult, np.ndarray, Any]


def _align_dataframe(df, graph: Graph) -> np.ndarray:
    """Reindex a node-indexed DataFrame to the graph's node order."""
    names = graph.get_node_names()
    missing = set(names) - set(df.index)
    if missing:
        raise ValueError(
            f"Node features DataFrame is missing {len(missing)} nodes, e.g. "
            f"{sorted(missing)[:5]}"
        )
    return df.loc[names].to_numpy(dtype=np.float32)


class AbstractClassifierModel(AbstractModel):
    """Shared backbone of the prediction models."""

    def __init__(self, random_state: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self._device = torch.device(device)
        super().__init__(random_state=random_state)
        self._fitting_was_executed = False

    @property
    def device(self) -> torch.device:
        return self._device

    def clone(self) -> "AbstractClassifierModel":
        return type(self)(**self.parameters(), device=self._device)

    # ------------------------------------------------------------ feature prep
    def normalize_node_features(
        self,
        graph: Graph,
        node_features: Optional[Union[FeatureLike, List[FeatureLike]]],
        allow_automatic_feature: bool = True,
        skip_evaluation_biased_feature: bool = False,
    ) -> Optional[List[Any]]:
        """Normalize features into a list of [n_nodes, d] float32 arrays.

        With `skip_evaluation_biased_feature`, feature models that are
        topological or stochastic come back unfitted, so an evaluation can
        fit them per holdout on the train graph only."""
        if node_features is None:
            return None
        if not isinstance(node_features, list):
            node_features = [node_features]
        out: List[Any] = []
        for feature in node_features:
            if isinstance(feature, str):
                if not allow_automatic_feature:
                    raise ValueError(
                        f"Cannot resolve feature name {feature!r} here."
                    )
                from .registry import get_model_from_library

                feature = get_model_from_library(
                    feature, task_name="Node Embedding"
                )(device=self._device)
            if isinstance(feature, AbstractEmbeddingModel):
                if skip_evaluation_biased_feature and (
                    feature.is_topological() or feature.is_stochastic()
                ):
                    out.append(feature)
                    continue
                feature = feature.fit_transform(graph)
            if isinstance(feature, EmbeddingResult):
                for emb in feature.get_all_node_embedding():
                    out.append(self._validate_feature_matrix(emb, graph))
                continue
            out.append(self._validate_feature_matrix(feature, graph))
        return out

    def _validate_feature_matrix(self, feature, graph: Graph) -> np.ndarray:
        if hasattr(feature, "loc"):
            arr = _align_dataframe(feature, graph)
        elif isinstance(feature, torch.Tensor):
            arr = feature.detach().cpu().numpy().astype(np.float32, copy=False)
        else:
            arr = np.asarray(feature, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.shape[0] != graph.number_of_nodes:
            raise ValueError(
                f"Feature has {arr.shape[0]} rows but graph "
                f"{graph.name} has {graph.number_of_nodes} nodes."
            )
        if not np.isfinite(arr).all():
            raise ValueError("Node features contain NaN or Inf values.")
        return arr

    @staticmethod
    def _validate_type_feature_matrix(feature, n_rows: int, names, kind: str) -> np.ndarray:
        """One [n_rows, d] float32 matrix of per-type features; a DataFrame
        is reindexed by the type `names`."""
        if hasattr(feature, "loc"):
            missing = set(names) - set(feature.index)
            if missing:
                raise ValueError(
                    f"{kind} features DataFrame is missing {len(missing)} "
                    f"entries, e.g. {sorted(missing)[:5]}"
                )
            arr = feature.loc[list(names)].to_numpy(dtype=np.float32)
        else:
            arr = np.asarray(feature, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.shape[0] != n_rows:
            raise ValueError(
                f"{kind} feature has {arr.shape[0]} rows but the graph has "
                f"{n_rows} {kind.lower()}s."
            )
        if not np.isfinite(arr).all():
            raise ValueError(f"{kind} features contain NaN or Inf values.")
        return arr

    def normalize_node_type_features(self, graph: Graph, node_type_features
                                     ) -> Optional[List[np.ndarray]]:
        """A list of [n_node_types, d] float32 matrices."""
        if node_type_features is None:
            return None
        if not graph.has_node_types:
            raise ValueError(
                f"Node type features provided but graph {graph.name} has no "
                "node types."
            )
        if not isinstance(node_type_features, list):
            node_type_features = [node_type_features]
        names = graph.get_node_type_names()
        return [self._validate_type_feature_matrix(
            f, graph.number_of_node_types, names, "Node type") for f in node_type_features]

    def normalize_edge_type_features(self, graph: Graph, edge_type_features
                                     ) -> Optional[List[np.ndarray]]:
        """A list of [n_edge_types, d] float32 matrices."""
        if edge_type_features is None:
            return None
        if not graph.has_edge_types:
            raise ValueError(
                f"Edge type features provided but graph {graph.name} has no "
                "edge types."
            )
        if not isinstance(edge_type_features, list):
            edge_type_features = [edge_type_features]
        names = graph.get_edge_type_names()
        return [self._validate_type_feature_matrix(
            f, graph.number_of_edge_types, names, "Edge type") for f in edge_type_features]

    def normalize_edge_features(self, graph: Graph, edge_features
                                ) -> Optional[Tuple[List[Any], List[np.ndarray]]]:
        """(lazy models, static matrices) of `edge_features`, in their order
        within each kind. Lazy edge-feature models (anything with `fit` and
        `device_feature_fn`; a name builds one on this model's device) pass
        through; arrays and DataFrames must be [n_directed_edges, d] and
        finite, and become float32 arrays."""
        if edge_features is None:
            return None
        if not isinstance(edge_features, list):
            edge_features = [edge_features]
        lazy: List[Any] = []
        static: List[np.ndarray] = []
        for feature in edge_features:
            if isinstance(feature, str):
                from .registry import get_model_from_library

                feature = get_model_from_library(
                    feature, task_name="Node Embedding")(device=self._device)
            if hasattr(feature, "device_feature_fn"):
                lazy.append(feature)
                continue
            arr = (feature.to_numpy(dtype=np.float32) if hasattr(feature, "loc")
                   else np.asarray(feature, dtype=np.float32))
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.shape[0] != graph.number_of_directed_edges:
                raise ValueError(
                    f"Edge feature has {arr.shape[0]} rows but graph "
                    f"{graph.name} has {graph.number_of_directed_edges} "
                    "directed edges."
                )
            if not np.isfinite(arr).all():
                raise ValueError("Edge features contain NaN or Inf values.")
            static.append(arr)
        return lazy, static

    # Capability flags: a feature kwarg is either consumed or rejected,
    # never silently dropped.
    @classmethod
    def can_use_node_type_features(cls) -> bool:
        return False

    @classmethod
    def can_use_edge_type_features(cls) -> bool:
        return False

    @classmethod
    def can_use_edge_features(cls) -> bool:
        return False

    @staticmethod
    def fit_deferred_features(
        features: Optional[List[Any]], graph: Graph
    ) -> Optional[List[np.ndarray]]:
        """Fit any deferred feature models on the (train) graph."""
        if features is None:
            return None
        out = []
        for f in features:
            if isinstance(f, AbstractEmbeddingModel):
                result = f.clone().fit_transform(graph)
                out.extend(np.asarray(e) for e in result.get_all_node_embedding())
            else:
                out.append(f)
        return out

    @staticmethod
    def concatenate_features(
        features: Optional[List[np.ndarray]],
    ) -> Optional[np.ndarray]:
        if not features:
            return None
        return np.concatenate(
            [np.asarray(f, dtype=np.float32) for f in features], axis=1
        )

    # ------------------------------------------------------------------- verbs
    def fit(
        self,
        graph: Graph,
        support: Optional[Graph] = None,
        node_features: Optional[Union[FeatureLike, List[FeatureLike]]] = None,
        node_type_features=None,
        edge_type_features=None,
        edge_features=None,
    ) -> "AbstractClassifierModel":
        if graph.number_of_directed_edges == 0:
            raise ValueError(f"Graph {graph.name} has no edges.")
        if self.requires_node_types() and not graph.has_node_types:
            raise ValueError(
                f"{self.model_name()} requires node types; graph "
                f"{graph.name} has none."
            )
        if self.requires_edge_types() and not graph.has_edge_types:
            raise ValueError(
                f"{self.model_name()} requires edge types; graph "
                f"{graph.name} has none."
            )
        for provided, flag, kind in (
            (node_type_features, self.can_use_node_type_features(),
             "node_type_features"),
            (edge_type_features, self.can_use_edge_type_features(),
             "edge_type_features"),
            (edge_features, self.can_use_edge_features(), "edge_features"),
        ):
            if provided is not None and not flag:
                raise ValueError(
                    f"{self.model_name()} ({self.library_name()}) does not "
                    f"support {kind}; they would be silently ignored."
                )
        node_features = self.normalize_node_features(graph, node_features)
        # Only the feature classes given reach `_fit`.
        feature_kwargs = {
            kind: normalize(graph, given) for kind, given, normalize in (
                ("node_type_features", node_type_features,
                 self.normalize_node_type_features),
                ("edge_type_features", edge_type_features,
                 self.normalize_edge_type_features),
                ("edge_features", edge_features, self.normalize_edge_features),
            ) if given is not None}
        try:
            self._fit(graph, support=support or graph,
                      node_features=node_features, **feature_kwargs)
        except NotImplementedError:
            raise
        except Exception as exc:
            raise RuntimeError(
                f"Error while fitting {self.model_name()} from library "
                f"{self.library_name()} on graph {graph.name} for task "
                f"{self.task_name()}: {exc}"
            ) from exc
        self._fitting_was_executed = True
        return self

    def evaluate(
        self,
        graph: Graph,
        evaluation_schema: Optional[str] = None,
        holdouts_number: int = 10,
        node_features=None,
        node_type_features=None,
        edge_type_features=None,
        edge_features=None,
        random_state: int = 42,
        holdouts_kwargs: Optional[Dict[str, Any]] = None,
        number_of_workers: Optional[int] = None,
        worker_id: Optional[int] = None,
        enable_cache: bool = False,
        cache_dir: Optional[str] = None,
        **evaluation_kwargs,
    ) -> List[Dict[str, Any]]:
        """This model's holdout evaluation on `graph`: the metric rows of
        `pipelines.evaluation.evaluate_model_on_graph` (the schema defaults
        to the first available one)."""
        from ..pipelines.evaluation import evaluate_model_on_graph

        if evaluation_schema is None:
            evaluation_schema = self.get_available_evaluation_schemas()[0]
        return evaluate_model_on_graph(
            self,
            graph,
            evaluation_schema,
            holdouts_number,
            node_features=node_features,
            node_type_features=node_type_features,
            edge_type_features=edge_type_features,
            edge_features=edge_features,
            random_state=random_state,
            holdouts_kwargs=holdouts_kwargs,
            number_of_workers=number_of_workers,
            worker_id=worker_id,
            enable_cache=enable_cache,
            cache_dir=cache_dir,
            **evaluation_kwargs,
        )

    def predict(self, graph: Graph, **kwargs) -> np.ndarray:
        self._check_fitted()
        proba = self.predict_proba(graph, **kwargs)
        if proba.ndim == 1 or proba.shape[1] == 1:
            return (proba.reshape(-1) > 0.5).astype(np.int32)
        return proba.argmax(axis=1).astype(np.int32)

    def predict_proba(self, graph: Graph, **kwargs) -> np.ndarray:
        self._check_fitted()
        return self._predict_proba(graph, **kwargs)

    def _check_fitted(self):
        if not self._fitting_was_executed:
            raise ValueError(
                f"{self.model_name()} must be fitted before predicting; call "
                ".fit() first."
            )

    # ------------------------------------------------------ subclass interface
    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        raise NotImplementedError

    def _predict_proba(self, graph: Graph, **kwargs) -> np.ndarray:
        raise NotImplementedError

    def is_binary_prediction_task(self) -> bool:
        return False

    def is_multilabel_prediction_task(self) -> bool:
        return False

    # ----------------------------------------------------------------- metrics
    def evaluate_prediction_probabilities(
        self, labels: np.ndarray, probabilities: np.ndarray
    ) -> Dict[str, float]:
        """The binary panel on the last column's scores for a binary task,
        else the multiclass or multilabel panel."""
        if self.is_binary_prediction_task():
            scores = probabilities if probabilities.ndim == 1 else probabilities[:, -1]
            return all_binary_metrics(labels, scores)
        return multiclass_metrics(
            labels, probabilities, multilabel=self.is_multilabel_prediction_task())

    @staticmethod
    def run_metadata() -> Dict[str, Any]:
        """Platform metadata carried by every evaluation row."""
        return {
            "platform": platform.platform(),
            "python_version": platform.python_version(),
            "number_of_threads": os.cpu_count(),
            "hostname": platform.node(),
        }
