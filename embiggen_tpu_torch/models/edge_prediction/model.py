"""AbstractEdgePredictionModel — counterpart of
`embiggen_tpu/models/edge_prediction/model.py`: the evaluation schemas
(Connected Monte Carlo, Monte Carlo, Kfold), `_evaluate`, which scores the
train and test graphs of a holdout against negative graphs drawn
(scale-free by default) from the whole graph, and the bipartite and clique
candidate-set surface (by node ids, names, name prefixes and node types).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...graph.graph import Graph
from ...graph.holdouts import (
    connected_holdout,
    edge_prediction_kfold,
    random_holdout,
)
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
            return edge_prediction_kfold(
                graph, k=kwargs.get("k", 10),
                holdout_number=holdout_number, random_state=random_state,
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

    # ----------------------------------------------- candidate-set prediction
    #
    # {predict, predict_proba} x {bipartite, clique} x {ids, names,
    # prefixes, node types}. Every route scores the |S| x |D| candidate
    # product in chunks of PREDICTION_CHUNK_SIZE pairs, each chunk's (src,
    # dst) made from the flat pair index, so the product never exists as
    # pairs on the host.
    PREDICTION_CHUNK_SIZE = 1 << 20

    def _score_pair_product(
        self, source_node_ids: np.ndarray, destination_node_ids: np.ndarray,
    ) -> np.ndarray:
        """[|S|, |D|] probabilities of every (source, destination) pair."""
        src_ids = np.asarray(source_node_ids, dtype=np.int64).reshape(-1)
        dst_ids = np.asarray(destination_node_ids, dtype=np.int64).reshape(-1)
        s, d = len(src_ids), len(dst_ids)
        out = np.empty(s * d, dtype=np.float32)
        chunk = int(self.PREDICTION_CHUNK_SIZE)
        for start in range(0, s * d, chunk):
            flat = np.arange(start, min(start + chunk, s * d), dtype=np.int64)
            out[start:start + len(flat)] = np.asarray(
                self.predict_proba_from_edge_node_ids(
                    src_ids[flat // d].astype(np.int32),
                    dst_ids[flat % d].astype(np.int32),
                )).reshape(-1)
        return out.reshape(s, d)

    @staticmethod
    def _as_dataframe(matrix, graph, src_ids, dst_ids, return_node_names):
        """The matrix as a pandas DataFrame indexed by node names (or ids);
        pandas is imported only here."""
        import pandas as pd

        if return_node_names:
            names = graph.get_node_names()
            index = names[np.asarray(src_ids, dtype=np.int64)]
            columns = names[np.asarray(dst_ids, dtype=np.int64)]
        else:
            index, columns = src_ids, dst_ids
        return pd.DataFrame(matrix, index=index, columns=columns)

    def predict_proba_bipartite_graph_from_edge_node_ids(
        self,
        source_node_ids: np.ndarray,
        destination_node_ids: np.ndarray,
        support: Optional[Graph] = None,
        graph: Optional[Graph] = None,
        return_predictions_dataframe: bool = False,
        return_node_names: bool = True,
    ):
        """[|S|, |D|] probabilities of the bipartite candidate set, or a
        DataFrame of them (which needs `graph` for the node names)."""
        matrix = self._score_pair_product(source_node_ids, destination_node_ids)
        if not return_predictions_dataframe:
            return matrix
        if graph is None:
            raise ValueError("return_predictions_dataframe requires the graph "
                             "to resolve node names.")
        return self._as_dataframe(matrix, graph, source_node_ids,
                                  destination_node_ids, return_node_names)

    def predict_proba_bipartite_graph_from_edge_node_names(
        self, graph: Graph, source_node_names, destination_node_names,
        **kwargs,
    ):
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            graph.get_node_ids_from_names(source_node_names),
            graph.get_node_ids_from_names(destination_node_names),
            graph=graph, **kwargs,
        )

    def predict_proba_bipartite_graph_from_edge_node_prefixes(
        self, graph: Graph, source_node_prefixes, destination_node_prefixes,
        **kwargs,
    ):
        """Candidate sets: the nodes whose names start with the prefixes."""
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            graph.get_node_ids_from_prefixes(source_node_prefixes),
            graph.get_node_ids_from_prefixes(destination_node_prefixes),
            graph=graph, **kwargs,
        )

    def predict_proba_bipartite_graph_from_edge_node_types(
        self, graph: Graph, source_node_types, destination_node_types,
        **kwargs,
    ):
        """Candidate sets: the nodes that have any of the node types."""
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            graph.get_node_ids_from_node_type_names(source_node_types),
            graph.get_node_ids_from_node_type_names(destination_node_types),
            graph=graph, **kwargs,
        )

    def predict_proba_clique_graph_from_node_ids(self, node_ids: np.ndarray,
                                                 **kwargs):
        """[k, k] probabilities over the clique of the given nodes."""
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            node_ids, node_ids, **kwargs)

    def predict_proba_clique_graph_from_node_names(self, graph: Graph,
                                                   node_names, **kwargs):
        return self.predict_proba_clique_graph_from_node_ids(
            graph.get_node_ids_from_names(node_names), graph=graph, **kwargs)

    def predict_proba_clique_graph_from_node_prefixes(self, graph: Graph,
                                                      node_prefixes, **kwargs):
        return self.predict_proba_clique_graph_from_node_ids(
            graph.get_node_ids_from_prefixes(node_prefixes), graph=graph,
            **kwargs)

    def predict_proba_clique_graph_from_node_type_names(
        self, graph: Graph, node_type_names, **kwargs
    ):
        return self.predict_proba_clique_graph_from_node_ids(
            graph.get_node_ids_from_node_type_names(node_type_names), graph=graph, **kwargs)

    # Hard labels: probability > 0.5, elementwise on a matrix or DataFrame.
    def predict_bipartite_graph_from_edge_node_ids(self, *args, **kwargs):
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            *args, **kwargs) > 0.5

    def predict_bipartite_graph_from_edge_node_names(self, *args, **kwargs):
        return self.predict_proba_bipartite_graph_from_edge_node_names(
            *args, **kwargs) > 0.5

    def predict_bipartite_graph_from_edge_node_prefixes(self, *args, **kwargs):
        return self.predict_proba_bipartite_graph_from_edge_node_prefixes(
            *args, **kwargs) > 0.5

    def predict_bipartite_graph_from_edge_node_types(self, *args, **kwargs):
        return self.predict_proba_bipartite_graph_from_edge_node_types(
            *args, **kwargs) > 0.5

    def predict_clique_graph_from_node_ids(self, *args, **kwargs):
        return self.predict_proba_clique_graph_from_node_ids(
            *args, **kwargs) > 0.5

    def predict_clique_graph_from_node_names(self, *args, **kwargs):
        return self.predict_proba_clique_graph_from_node_names(
            *args, **kwargs) > 0.5

    def predict_clique_graph_from_node_prefixes(self, *args, **kwargs):
        return self.predict_proba_clique_graph_from_node_prefixes(
            *args, **kwargs) > 0.5

    def predict_clique_graph_from_node_type_names(self, *args, **kwargs):
        return self.predict_proba_clique_graph_from_node_type_names(
            *args, **kwargs) > 0.5

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement arbitrary-pair "
            "prediction."
        )
