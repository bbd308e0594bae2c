"""Edge-label prediction: the task's base model and the sklearn-like
adapters (the GCNs are in `models/gcn`)."""
from .model import AbstractEdgeLabelPredictionModel
from .sklearn_like import SKLEARN_EDGE_LABEL_MODELS, SklearnEdgeLabelPredictionAdapter

__all__ = ["AbstractEdgeLabelPredictionModel", "SklearnEdgeLabelPredictionAdapter",
           "SKLEARN_EDGE_LABEL_MODELS"]
