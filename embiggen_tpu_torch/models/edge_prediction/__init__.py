"""Edge prediction models: the Perceptron and the sklearn-like adapters."""
from .model import AbstractEdgePredictionModel
from .perceptron import PerceptronEdgePrediction
from .sklearn_like import SKLEARN_EDGE_PREDICTION_MODELS, SklearnEdgePredictionAdapter

__all__ = ["AbstractEdgePredictionModel", "PerceptronEdgePrediction",
           "SklearnEdgePredictionAdapter", "SKLEARN_EDGE_PREDICTION_MODELS"]
