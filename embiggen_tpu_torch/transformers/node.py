"""NodeTransformer — counterpart of `embiggen_tpu/transformers/node.py`:
holds fitted node features and gathers their rows by node id or name.

The features are one float32 tensor on the transformer's `device` (the card
unless the caller asks for the CPU), and the rows are gathered there;
`transform` downloads them as numpy, as the reference returns numpy, and
`transform_tensor` leaves them on the device for the edge operators. A
DataFrame fit (anything with `.loc`) keeps its index as the node names, so
no pandas import is needed.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..graph.graph import Graph
from ..models.embedding_result import EmbeddingResult


def as_device_tensor(values, device: torch.device) -> torch.Tensor:
    """`values` (numpy-like or a tensor) as a float32 tensor on `device`."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32)).to(device)


def as_device_ids(ids, device: torch.device) -> torch.Tensor:
    """Integer node ids as an int64 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)).to(device)


class NodeTransformer:
    """Holds fitted node features; `transform` gathers rows by node id/name."""

    def __init__(self, aligned_mapping: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self._aligned_mapping = aligned_mapping
        self._device = torch.device(device)
        self._features: Optional[torch.Tensor] = None
        self._name_to_id = None

    @property
    def device(self) -> torch.device:
        return self._device

    def fit(self, node_feature) -> "NodeTransformer":
        if isinstance(node_feature, EmbeddingResult):
            node_feature = node_feature.get_all_node_embedding()
        if not isinstance(node_feature, list):
            node_feature = [node_feature]
        mats = []
        for f in node_feature:
            if hasattr(f, "loc"):
                if self._name_to_id is None:
                    self._name_to_id = {n: i for i, n in enumerate(f.index)}
                f = f.to_numpy(dtype=np.float32)
            mats.append(as_device_tensor(f, self._device))
        self._features = torch.cat(mats, dim=1)
        return self

    @property
    def is_fitted(self) -> bool:
        return self._features is not None

    def transform_tensor(
        self, nodes: Union[Graph, np.ndarray, List[str]]
    ) -> torch.Tensor:
        """The rows of `nodes` (a graph's nodes, ids or names) as a tensor
        on the transformer's device."""
        if self._features is None:
            raise ValueError("NodeTransformer must be fitted first.")
        if isinstance(nodes, Graph):
            if self._aligned_mapping or self._name_to_id is None:
                return self._features
            ids = [self._name_to_id[n] for n in nodes.get_node_names()]
            return self._features[as_device_ids(ids, self._device)]
        nodes = np.asarray(nodes)
        if nodes.dtype.kind in "iu":
            return self._features[as_device_ids(nodes, self._device)]
        if self._name_to_id is None:
            raise ValueError(
                "Cannot transform node names without a DataFrame-indexed fit."
            )
        ids = [self._name_to_id[n] for n in nodes]
        return self._features[as_device_ids(ids, self._device)]

    def transform(
        self, nodes: Union[Graph, np.ndarray, List[str]]
    ) -> np.ndarray:
        return self.transform_tensor(nodes).cpu().numpy()
