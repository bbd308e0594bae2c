"""GraphTransformer — counterpart of `embiggen_tpu/transformers/graph.py`:
the edge features of every arc of a graph."""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..graph.graph import Graph
from .edge import EdgeTransformer


class GraphTransformer:
    def __init__(
        self,
        methods: Union[List[str], str] = "Hadamard",
        aligned_mapping: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self._edge_transformer = EdgeTransformer(
            methods=methods, aligned_mapping=aligned_mapping, device=device
        )

    @property
    def device(self) -> torch.device:
        return self._edge_transformer.device

    def fit(self, node_feature) -> "GraphTransformer":
        self._edge_transformer.fit(node_feature)
        return self

    def transform_tensor(
        self, graph: Graph, edge_type_features: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """Edge features for every arc of the graph, on the device."""
        return self._edge_transformer.transform_tensor(
            graph.sources, graph.col_idx, edge_type_features=edge_type_features
        )

    def transform(
        self,
        graph: Graph,
        edge_type_features: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Edge features for every arc of the graph."""
        return self.transform_tensor(graph, edge_type_features).cpu().numpy()
