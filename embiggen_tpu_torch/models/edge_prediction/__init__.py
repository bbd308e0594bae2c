"""Edge prediction models."""
from .model import AbstractEdgePredictionModel
from .perceptron import PerceptronEdgePrediction

__all__ = ["AbstractEdgePredictionModel", "PerceptronEdgePrediction"]
