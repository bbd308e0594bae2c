"""AbstractEdgePredictionModel — counterpart of
`embiggen_tpu/models/edge_prediction/model.py`: the evaluation schemas and
`_evaluate`, which scores the train and test graphs of a holdout against
negative graphs drawn (scale-free by default) from the whole graph. The
bipartite and clique candidate-set surface comes with the evaluation
harness (ROADMAP A5).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...graph.graph import Graph
from ...graph.holdouts import connected_holdout, random_holdout
from ...graph.sampling import sample_negative_graph
from ..classifier import AbstractClassifierModel


class AbstractEdgePredictionModel(AbstractClassifierModel):
    """Binary link prediction."""

    @classmethod
    def task_name(cls) -> str:
        return "Edge Prediction"

    def is_binary_prediction_task(self) -> bool:
        return True

    @classmethod
    def get_available_evaluation_schemas(cls) -> List[str]:
        return ["Connected Monte Carlo", "Monte Carlo", "Kfold"]

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
        seed = random_state + holdout_number
        schema = evaluation_schema.lower()
        if schema == "connected monte carlo":
            return connected_holdout(
                graph, random_state=seed,
                train_size=kwargs.get("train_size", 0.8),
            )
        if schema == "monte carlo":
            return random_holdout(
                graph, random_state=seed,
                train_size=kwargs.get("train_size", 0.8),
            )
        if schema == "kfold":
            raise NotImplementedError(
                "The k-fold split is not ported yet (ROADMAP A5).")
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
        unbalance_rates: Sequence[float] = (1.0,),
        use_scale_free_distribution: bool = True,
        random_state: int = 42,
        subgraph_of_interest: Optional[Graph] = None,
        **kwargs,
    ) -> List[Dict[str, Any]]:
        """One row of the binary panel per split (train, test) and unbalance
        rate, each with the seconds of its phases. Negatives avoid every
        edge of `graph`; with `subgraph_of_interest` (in `graph`'s node ids)
        they are drawn from that subgraph's degrees."""
        if not use_scale_free_distribution:
            warnings.warn(
                "Using uniform negative sampling for evaluation; the model "
                "was likely trained with scale-free negatives, so the "
                "metrics will look optimistic."
            )
        support = support or train
        rows = []
        t0 = time.perf_counter()
        train_scores = self.predict_proba(train, support=support)
        predict_pos_s = {"train": time.perf_counter() - t0}
        t0 = time.perf_counter()
        test_scores = self.predict_proba(test, support=support)
        predict_pos_s["test"] = time.perf_counter() - t0
        for unbalance in unbalance_rates:
            for split, pos_scores, pos_graph, seed_off in (
                ("train", train_scores, train, 0),
                ("test", test_scores, test, 1),
            ):
                n_neg = max(1, int(round(pos_graph.number_of_edges * unbalance)))
                t0 = time.perf_counter()
                neg = sample_negative_graph(
                    subgraph_of_interest
                    if subgraph_of_interest is not None else graph,
                    number_of_negative_samples=n_neg,
                    random_state=random_state + seed_off,
                    use_scale_free_distribution=use_scale_free_distribution,
                    support=graph,
                    device=self.device,
                )
                neg_sample_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                neg_scores = self.predict_proba(neg, support=support)
                predict_neg_s = time.perf_counter() - t0
                labels = np.concatenate(
                    [np.ones(len(pos_scores)), np.zeros(len(neg_scores))]
                )
                scores = np.concatenate([pos_scores, neg_scores])
                t0 = time.perf_counter()
                metrics = self.evaluate_prediction_probabilities(labels, scores)
                metrics.update({
                    "evaluation_mode": split,
                    "unbalance_rate": unbalance,
                    "size_of_positive_set": len(pos_scores),
                    "size_of_negative_set": len(neg_scores),
                    "predict_positive_seconds": predict_pos_s[split],
                    "negative_sampling_seconds": neg_sample_s,
                    "predict_negative_seconds": predict_neg_s,
                    "metrics_seconds": time.perf_counter() - t0,
                })
                rows.append(metrics)
        return rows

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement arbitrary-pair "
            "prediction."
        )
