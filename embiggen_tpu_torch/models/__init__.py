"""Models: abstract interfaces, registry, results, the embedders, the edge,
node-label and edge-label predictors, the feature preprocessor and the edge
features."""
from .abstract import AbstractEmbeddingModel, AbstractModel
from .embedding_result import EmbeddingResult
from .registry import MODELS_LIBRARY, get_model_from_library, register_model
from . import (
    edge_features, edge_label_prediction, edge_prediction, embedders,
    feature_preprocessors, gcn, node_label_prediction,
)

__all__ = [
    "AbstractModel", "AbstractEmbeddingModel", "EmbeddingResult",
    "MODELS_LIBRARY", "register_model", "get_model_from_library",
    "edge_features", "edge_prediction", "embedders", "gcn",
    "node_label_prediction", "edge_label_prediction", "feature_preprocessors",
]
