"""Pipelines: embedding and holdout evaluation."""
from .embed_graph import embed_graph
from .evaluation import (
    classification_evaluation_pipeline,
    edge_label_prediction_evaluation,
    edge_prediction_evaluation,
    node_label_prediction_evaluation,
    rows_to_dataframe,
)

__all__ = [
    "embed_graph", "classification_evaluation_pipeline",
    "edge_prediction_evaluation", "node_label_prediction_evaluation",
    "edge_label_prediction_evaluation", "rows_to_dataframe",
]
