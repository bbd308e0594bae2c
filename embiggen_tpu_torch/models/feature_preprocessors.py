"""Feature preprocessors — counterpart of
`embiggen_tpu/models/feature_preprocessors.py`: the GraphConvolution
preprocessor, n hops of feature smoothing X <- A X over the support graph's
Left Normalized Laplacian (its transpose with `transpose`), optionally
concatenating every hop's features.

Each hop is kernel K7 (`ops.spmm.csr_spmm`) on the kernel's CSR, which
`csr_kernel` builds by a stable sort of the COO rows: the transposed
kernel's rows are not sorted, and the product is the sum over each row's
arcs all the same. The hops run in float32; only the result is cast to
`dtype`.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..graph.graph import Graph
from ..graph.laplacians import kernel_coo
from ..ops.spmm import csr_kernel, csr_spmm
from .abstract import AbstractModel
from .embedding_result import EmbeddingResult
from .registry import register_model


class AbstractFeaturePreprocessor(AbstractModel):
    """`transform(support, node_features) -> EmbeddingResult`."""

    @classmethod
    def task_name(cls) -> str:
        return "Feature Preprocessor"

    @classmethod
    def is_stochastic(cls) -> bool:
        return False

    def transform(self, support: Graph, node_features) -> EmbeddingResult:
        raise NotImplementedError


@register_model
class GraphConvolution(AbstractFeaturePreprocessor):
    """n-hop feature propagation over the support graph, on `device`
    (default "cuda")."""

    def __init__(
        self,
        number_of_convolutions: int = 2,
        concatenate_features: bool = False,
        transpose: bool = False,
        normalize_rows: bool = False,
        dtype: str = "f32",
        device: Union[str, torch.device] = "cuda",
    ):
        self._number_of_convolutions = number_of_convolutions
        self._concatenate_features = concatenate_features
        self._transpose = transpose
        self._normalize_rows = normalize_rows
        self._dtype = dtype
        self._device = torch.device(device)
        super().__init__(random_state=None)

    @classmethod
    def model_name(cls) -> str:
        return "Graph Convolution"

    @property
    def device(self) -> torch.device:
        return self._device

    def clone(self) -> "GraphConvolution":
        return type(self)(**self.parameters(), device=self._device)

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "number_of_convolutions": self._number_of_convolutions,
            "concatenate_features": self._concatenate_features,
            "transpose": self._transpose,
            "normalize_rows": self._normalize_rows,
            "dtype": self._dtype,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"number_of_convolutions": 1}

    def transform(self, support: Graph, node_features) -> EmbeddingResult:
        """One [N, D] (or, concatenated, [N, D (hops + 1)]) matrix per
        feature matrix of `node_features` (an array, a DataFrame, a list of
        them or an EmbeddingResult's node embeddings)."""
        if isinstance(node_features, EmbeddingResult):
            node_features = node_features.get_all_node_embedding()
        if not isinstance(node_features, list):
            node_features = [node_features]
        kernel = ("Transposed Left Normalized Laplacian" if self._transpose
                  else "Left Normalized Laplacian")
        rows, cols, vals = kernel_coo(support, kernel)
        k = csr_kernel(rows, cols, vals, support.number_of_nodes, device=self._device,
                       with_transpose=False)
        np_dtype = {"f16": np.float16, "f32": np.float32, "f64": np.float64}[self._dtype]
        out = []
        for feature in node_features:
            x = np.asarray(feature.to_numpy() if hasattr(feature, "loc") else feature,
                           dtype=np.float32)
            if self._normalize_rows:
                x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
            h = torch.from_numpy(np.ascontiguousarray(x)).to(self._device)
            hops = [h]
            for _ in range(self._number_of_convolutions):
                h = csr_spmm(k, h)
                hops.append(h)
            result = torch.cat(hops, dim=1) if self._concatenate_features else h
            out.append(result.cpu().numpy().astype(np_dtype))
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=out,
            node_names=support.get_node_names(),
        )
