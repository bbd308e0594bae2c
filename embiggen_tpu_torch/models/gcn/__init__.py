"""Graph convolutional models."""
from .core import GCNEncoder, TrainLoop
from .edge import (
    GCNEdgeLabelPrediction,
    GCNEdgePrediction,
    GNNEdgeLabelPrediction,
    GNNEdgePrediction,
    GraphSAGEEdgeLabelPrediction,
    GraphSAGEEdgePrediction,
    KipfGCNEdgeLabelPrediction,
    KipfGCNEdgePrediction,
)
from .node_label import (
    GCNNodeLabelPrediction,
    GNNNodeLabelPrediction,
    GraphSAGENodeLabelPrediction,
    KipfGCNNodeLabelPrediction,
)

__all__ = [
    "GCNEncoder", "TrainLoop",
    "GCNNodeLabelPrediction", "KipfGCNNodeLabelPrediction",
    "GraphSAGENodeLabelPrediction", "GNNNodeLabelPrediction",
    "GCNEdgePrediction", "KipfGCNEdgePrediction",
    "GraphSAGEEdgePrediction", "GNNEdgePrediction",
    "GCNEdgeLabelPrediction", "KipfGCNEdgeLabelPrediction",
    "GraphSAGEEdgeLabelPrediction", "GNNEdgeLabelPrediction",
]
