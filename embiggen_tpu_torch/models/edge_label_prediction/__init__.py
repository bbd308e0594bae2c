"""Edge-label prediction: the task's base model. The sklearn adapters come
with ROADMAP A15."""
from .model import AbstractEdgeLabelPredictionModel

__all__ = ["AbstractEdgeLabelPredictionModel"]
