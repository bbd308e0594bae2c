"""Per-task (X, y) assembly for sklearn-like estimators — counterpart of
`embiggen_tpu/transformers/tasks.py`. The features are built on the
transformers' device and downloaded once per call; the shuffles draw the
reference's `np.random.default_rng(random_state)` permutation (applied on
the device), so the rows come out in the reference's order."""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from ..graph.graph import Graph
from .edge import EdgeTransformer
from .graph import GraphTransformer
from .node import NodeTransformer, as_device_ids, as_device_tensor


def _shuffled(x: torch.Tensor, y: np.ndarray, random_state: int):
    perm = np.random.default_rng(random_state).permutation(len(x))
    return x[as_device_ids(perm, x.device)], y[perm]


class EdgePredictionTransformer:
    """(positive graph, negative graph) -> stacked edge features + 0/1 labels."""

    def __init__(
        self,
        methods: Union[List[str], str] = "Hadamard",
        aligned_mapping: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self._graph_transformer = GraphTransformer(
            methods=methods, aligned_mapping=aligned_mapping, device=device
        )

    def fit(self, node_feature) -> "EdgePredictionTransformer":
        self._graph_transformer.fit(node_feature)
        return self

    def transform(
        self,
        positive_graph: Graph,
        negative_graph: Graph,
        shuffle: bool = True,
        random_state: int = 42,
        extra_features_fn=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`extra_features_fn(src, dst) -> [B, d]` (numpy or a tensor)
        appends per-pair columns (the support graph's metrics for
        `use_edge_metrics`) aligned with the stacked pos/neg rows before the
        shuffle."""
        pos = self._graph_transformer.transform_tensor(positive_graph)
        neg = self._graph_transformer.transform_tensor(negative_graph)
        n_pos, n_neg = len(pos), len(neg)
        x = torch.cat([pos, neg], dim=0)
        del pos, neg
        if extra_features_fn is not None:
            src = np.concatenate(
                [positive_graph.sources, negative_graph.sources]
            )
            dst = np.concatenate(
                [positive_graph.col_idx, negative_graph.col_idx]
            )
            x = torch.cat(
                [x, as_device_tensor(extra_features_fn(src, dst), x.device)], dim=1
            )
        y = np.concatenate(
            [np.ones(n_pos, np.int32), np.zeros(n_neg, np.int32)]
        )
        if shuffle:
            x, y = _shuffled(x, y, random_state)
        return x.cpu().numpy(), y


class EdgeLabelPredictionTransformer:
    """Graph with known edge types -> edge features + type labels."""

    def __init__(
        self,
        methods: Union[List[str], str] = "Hadamard",
        aligned_mapping: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self._edge_transformer = EdgeTransformer(
            methods=methods, aligned_mapping=aligned_mapping, device=device
        )

    def fit(self, node_feature) -> "EdgeLabelPredictionTransformer":
        self._edge_transformer.fit(node_feature)
        return self

    def transform(
        self, graph: Graph, shuffle: bool = False, random_state: int = 42,
        extra_features_fn=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if graph.edge_types is None:
            raise ValueError("Graph has no edge types.")
        known = graph.get_known_edge_types_mask()
        src = graph.sources[known]
        dst = graph.col_idx[known]
        y = graph.edge_types[known]
        x = self._edge_transformer.transform_tensor(src, dst)
        if extra_features_fn is not None:
            x = torch.cat(
                [x, as_device_tensor(extra_features_fn(src, dst), x.device)], dim=1
            )
        if shuffle:
            x, y = _shuffled(x, y, random_state)
        return x.cpu().numpy(), y


class NodeLabelPredictionTransformer:
    """Graph with known node types -> node features + labels (single-label or
    multilabel one-hot)."""

    def __init__(self, aligned_mapping: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self._node_transformer = NodeTransformer(
            aligned_mapping=aligned_mapping, device=device
        )

    def fit(self, node_feature) -> "NodeLabelPredictionTransformer":
        self._node_transformer.fit(node_feature)
        return self

    def transform(
        self, graph: Graph, shuffle: bool = False, random_state: int = 42
    ) -> Tuple[np.ndarray, np.ndarray]:
        if not graph.has_node_types:
            raise ValueError("Graph has no node types.")
        known = graph.get_known_node_types_mask()
        ids = np.nonzero(known)[0]
        feats = self._node_transformer.transform_tensor(graph)
        x = feats[as_device_ids(ids, feats.device)]
        if graph.has_multilabel_node_types():
            y = graph.get_one_hot_encoded_node_types()[ids]
        else:
            y = graph.get_single_label_node_type_ids()[ids]
        if shuffle:
            x, y = _shuffled(x, y, random_state)
        return x.cpu().numpy(), y
