"""AbstractEdgeLabelPredictionModel — counterpart of
`embiggen_tpu/models/edge_label_prediction/model.py`: the evaluation
schemas (Stratified Monte Carlo, Monte Carlo, Kfold) and `_evaluate`,
which scores the typed arcs of each split of a holdout.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...graph.graph import Graph
from ...graph.holdouts import edge_label_holdout, edge_label_kfold
from ..classifier import AbstractClassifierModel


class AbstractEdgeLabelPredictionModel(AbstractClassifierModel):
    """Edge-label prediction: the edge types are the labels."""

    @classmethod
    def task_name(cls) -> str:
        return "Edge Label Prediction"

    @classmethod
    def requires_edge_types(cls) -> bool:
        return True

    @classmethod
    def get_available_evaluation_schemas(cls) -> List[str]:
        return ["Stratified Monte Carlo", "Monte Carlo", "Kfold"]

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
        if "monte carlo" in schema:
            return edge_label_holdout(
                graph, train_size=kwargs.get("train_size", 0.8),
                random_state=random_state + holdout_number,
                use_stratification="stratified" in schema,
            )
        if "kfold" in schema:
            return edge_label_kfold(
                graph, k=kwargs.get("k", 10), holdout_number=holdout_number,
                random_state=random_state,
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
        """One row per split (train, test) with typed arcs: the panel of
        the predictions over every arc of `graph`, read at the split's
        typed arcs against `graph`'s types."""
        rows = []
        proba_all = self.predict_proba(graph, support=support or train)
        for split, g in (("train", train), ("test", test)):
            ids = np.nonzero(g.get_known_edge_types_mask())[0]
            if len(ids) == 0:
                continue
            metrics = self.evaluate_prediction_probabilities(
                graph.edge_types[ids], proba_all[ids])
            metrics.update({"evaluation_mode": split, "number_of_edges": len(ids)})
            rows.append(metrics)
        return rows
