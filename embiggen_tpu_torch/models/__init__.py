"""Models: abstract interfaces, registry and catalogue, results, the
embedders, the edge, node-label and edge-label predictors (the port's own
and the sklearn-like adapters), the feature preprocessor, the edge features
and the stubs of rows whose library is not installed. The task packages
import in the reference's order, so the catalogue lists each
classification task's rows in the reference's order."""
from .abstract import AbstractEmbeddingModel, AbstractModel
from .classifier import AbstractClassifierModel
from .embedding_result import EmbeddingResult
from .registry import (
    MODELS_LIBRARY, find_available_models, get_model_from_library, register_model,
)
from . import embedders
from . import gcn
from . import edge_prediction
from . import node_label_prediction
from . import edge_label_prediction
from . import feature_preprocessors
from . import edge_features
from . import stub

__all__ = [
    "AbstractModel", "AbstractEmbeddingModel", "AbstractClassifierModel",
    "EmbeddingResult", "MODELS_LIBRARY", "register_model", "get_model_from_library",
    "find_available_models", "edge_features", "edge_prediction", "embedders", "gcn",
    "node_label_prediction", "edge_label_prediction", "feature_preprocessors",
]
