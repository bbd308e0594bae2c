"""Graph convolutional models."""
from .core import GCNEncoder, TrainLoop
from .edge import (
    GCNEdgePrediction,
    GNNEdgePrediction,
    GraphSAGEEdgePrediction,
    KipfGCNEdgePrediction,
)

__all__ = [
    "GCNEncoder", "TrainLoop", "GCNEdgePrediction", "KipfGCNEdgePrediction",
    "GraphSAGEEdgePrediction", "GNNEdgePrediction",
]
