"""Node-label prediction: the task's base model and the sklearn-like
adapters (the GCNs are in `models/gcn`)."""
from .model import AbstractNodeLabelPredictionModel
from .sklearn_like import SKLEARN_NODE_LABEL_MODELS, SklearnNodeLabelPredictionAdapter

__all__ = ["AbstractNodeLabelPredictionModel", "SklearnNodeLabelPredictionAdapter",
           "SKLEARN_NODE_LABEL_MODELS"]
