"""Models: abstract interfaces, registry, results, the embedders, the edge
predictors and the edge features."""
from .abstract import AbstractEmbeddingModel, AbstractModel
from .embedding_result import EmbeddingResult
from .registry import MODELS_LIBRARY, get_model_from_library, register_model
from . import edge_features, edge_prediction, embedders, gcn

__all__ = [
    "AbstractModel", "AbstractEmbeddingModel", "EmbeddingResult",
    "MODELS_LIBRARY", "register_model", "get_model_from_library",
    "edge_features", "edge_prediction", "embedders", "gcn",
]
