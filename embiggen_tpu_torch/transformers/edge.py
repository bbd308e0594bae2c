"""EdgeTransformer — counterpart of `embiggen_tpu/transformers/edge.py`:
(src, dst) pairs into edge features by the 14 operators of
`ops/edge_ops.py::EDGE_TRANSFORMER_METHODS`, several methods concatenated,
method None giving the raw (src, dst) columns, and optional edge-type
features appended. The gathers and operators run on the transformer's
device; `transform` downloads the result once. On a CPU device the
operators run in numpy on the gathered rows (views, no copy), which is the
reference's program: the features, and so the estimators fitted on them,
are the reference's bit for bit there (torch's CPU sums take another
order)."""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..ops import edge_ops
from .node import NodeTransformer, as_device_tensor


class EdgeTransformer:
    methods = list(edge_ops.EDGE_TRANSFORMER_METHODS)

    def __init__(
        self,
        methods: Union[List[str], str] = "Hadamard",
        aligned_mapping: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if isinstance(methods, str) or methods is None:
            methods = [methods]
        self._method_names = []
        self._methods = []
        for m in methods:
            if m is None:
                self._method_names.append(None)
                self._methods.append(None)
            else:
                self._methods.append(
                    edge_ops.resolve(m, edge_ops.EDGE_TRANSFORMER_METHODS)
                )
                # canonical casing
                self._method_names.append(
                    next(
                        k
                        for k in edge_ops.EDGE_TRANSFORMER_METHODS
                        if k.lower() == m.lower()
                    )
                )
        self._node_transformer = NodeTransformer(
            aligned_mapping=aligned_mapping, device=device
        )

    @property
    def method_names(self) -> List[Optional[str]]:
        return self._method_names

    @property
    def device(self) -> torch.device:
        return self._node_transformer.device

    def fit(self, node_feature) -> "EdgeTransformer":
        self._node_transformer.fit(node_feature)
        return self

    def transform_tensor(
        self,
        sources: np.ndarray,
        destinations: np.ndarray,
        edge_type_features: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """The edge features of the pairs as a tensor on the device."""
        src_emb = self._node_transformer.transform_tensor(sources)
        dst_emb = self._node_transformer.transform_tensor(destinations)
        outs = []
        for fn in self._methods:
            if fn is None:
                # method None => raw (src, dst) id tuples (reference behavior)
                outs.append(as_device_tensor(np.stack(
                    [np.asarray(sources), np.asarray(destinations)], axis=1
                ).astype(np.float32), self.device))
            elif self.device.type == "cpu":
                outs.append(torch.from_numpy(np.asarray(
                    fn(src_emb.numpy(), dst_emb.numpy()), dtype=np.float32)))
            else:
                outs.append(fn(src_emb, dst_emb).to(torch.float32))
        del src_emb, dst_emb
        out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        if edge_type_features is not None:
            out = torch.cat(
                [out, as_device_tensor(edge_type_features, self.device)], dim=1
            )
        return out

    def transform(
        self,
        sources: np.ndarray,
        destinations: np.ndarray,
        edge_type_features: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        return self.transform_tensor(
            sources, destinations, edge_type_features
        ).cpu().numpy()
