"""AbstractNodeLabelPredictionModel — counterpart of
`embiggen_tpu/models/node_label_prediction/model.py`: the evaluation
schemas (Stratified Monte Carlo, Stratified Kfold, Monte Carlo, Kfold) and
`_evaluate`, which scores the labelled nodes of each split of a holdout
with the multiclass, multilabel or binary panel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...graph.graph import Graph
from ...graph.holdouts import node_label_holdout, node_label_kfold
from ..classifier import AbstractClassifierModel


class AbstractNodeLabelPredictionModel(AbstractClassifierModel):
    """Node-label prediction: the node types are the labels."""

    @classmethod
    def task_name(cls) -> str:
        return "Node Label Prediction"

    @classmethod
    def requires_node_types(cls) -> bool:
        return True

    @classmethod
    def get_available_evaluation_schemas(cls) -> List[str]:
        return ["Stratified Monte Carlo", "Stratified Kfold", "Monte Carlo", "Kfold"]

    @classmethod
    def split_graph_following_evaluation_schema(
        cls,
        graph: Graph,
        evaluation_schema: str,
        holdout_number: int,
        random_state: int = 42,
        holdouts_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Graph, Graph]:
        kwargs = dict(holdouts_kwargs or {})
        schema = evaluation_schema.lower()
        stratified = "stratified" in schema
        if "monte carlo" in schema:
            return node_label_holdout(
                graph, train_size=kwargs.get("train_size", 0.8),
                random_state=random_state + holdout_number,
                use_stratification=stratified,
            )
        if "kfold" in schema:
            return node_label_kfold(
                graph, k=kwargs.get("k", 10), holdout_number=holdout_number,
                random_state=random_state, use_stratification=stratified,
            )
        raise ValueError(
            f"Unknown evaluation schema {evaluation_schema!r}; available: "
            f"{cls.get_available_evaluation_schemas()}"
        )

    def _evaluate(
        self,
        graph: Graph,
        train: Graph,
        test: Graph,
        support: Optional[Graph] = None,
        random_state: int = 42,
        **kwargs,
    ) -> List[Dict[str, Any]]:
        """One row per split (train, test) with labelled nodes: the panel
        of the predictions over the whole graph, read at the split's
        labelled nodes against `graph`'s labels."""
        rows = []
        proba_all = self.predict_proba(graph, support=support or train)
        multilabel = graph.has_multilabel_node_types()
        for split, g in (("train", train), ("test", test)):
            ids = np.nonzero(g.get_known_node_types_mask())[0]
            if len(ids) == 0:
                continue
            if multilabel:
                labels = graph.get_one_hot_encoded_node_types()[ids]
            else:
                labels = graph.get_single_label_node_type_ids()[ids]
            metrics = self.evaluate_prediction_probabilities(labels, proba_all[ids])
            metrics.update({"evaluation_mode": split, "number_of_nodes": len(ids)})
            rows.append(metrics)
        return rows
