"""Node-label prediction: the task's base model. The sklearn adapters come
with ROADMAP A15."""
from .model import AbstractNodeLabelPredictionModel

__all__ = ["AbstractNodeLabelPredictionModel"]
