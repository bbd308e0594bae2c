"""Transformers: node features, edge features and the per-task (X, y)
assembly of the sklearn-like adapters, on the caller's device."""
from .node import NodeTransformer
from .edge import EdgeTransformer
from .graph import GraphTransformer
from .tasks import (
    EdgeLabelPredictionTransformer,
    EdgePredictionTransformer,
    NodeLabelPredictionTransformer,
)

__all__ = [
    "NodeTransformer", "EdgeTransformer", "GraphTransformer",
    "EdgePredictionTransformer", "EdgeLabelPredictionTransformer",
    "NodeLabelPredictionTransformer",
]
