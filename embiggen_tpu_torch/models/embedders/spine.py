"""SPINE, WINE, RUBICONE and RUINE — counterpart of
`embiggen_tpu/models/embedders/spine.py`, with the reference's parameters
(embedding_size, dtype, maximum_depth / window_size /
number_of_convolutions).

- SPINE: feature j is the shortest-path distance from anchor set j,
  `maximum_depth` (default 32) min-plus relaxations of kernel K15a
  (`ops/bfs.py::multi_source_distances`, which stops after the first one
  that moves nothing); unreached pairs get depth + 1.
  WeightedSPINE relaxes along the arc weights (their reciprocals with
  `use_reciprocal_weights`).
- WINE: feature j counts the walks of length 1..window_size into anchor
  set j: `window_size` K7 hops at unit values.
- Anchors are the top-degree nodes, the top-score nodes, or the node-label
  classes; node types come with ROADMAP A6, so the node-label rows raise
  the reference's error on the port's untyped graphs.
- RUBICONE and RUINE: random binary or uniform features, drawn on the
  model's device from a torch.Generator seeded by `random_state`, then
  `number_of_convolutions` K7 products with the Left Normalized Laplacian.

SPINE and WINE are deterministic and equal the JAX package's output exactly;
RUBICONE and RUINE draw other random numbers than jax.random.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...graph.graph import Graph
from ...graph.laplacians import kernel_coo
from ...ops.bfs import (
    UNREACHED, anchor_init_from_sets, multi_source_distances, window_cooccurrence_counts,
)
from ...ops.spmm import csr_kernel, csr_spmm
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from ..registry import register_model


def _clamp_to_dtype(x: torch.Tensor, dtype: Optional[str]) -> np.ndarray:
    """The reference's u8 / u16 semantics: values clamp to the dtype's
    maximum, then truncate; anything else stays float32."""
    if dtype in ("u8", "uint8"):
        return torch.clamp(x, max=255).to(torch.uint8).cpu().numpy()
    x = x.cpu().numpy()
    if dtype in ("u16", "uint16"):
        return np.minimum(x, 65535).astype(np.uint16)
    return x.astype(np.float32)


class _AnchorSketchBase(AbstractEmbeddingModel):
    """Shared anchor-selection machinery."""

    def __init__(self, embedding_size: int = 100, dtype: Optional[str] = "u8",
                 enable_cache: bool = False, device="cuda", **kwargs):
        self._dtype = dtype
        super().__init__(embedding_size=embedding_size, enable_cache=enable_cache,
                         random_state=None, device=device)

    @classmethod
    def is_stochastic(cls) -> bool:
        return False

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5}

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "dtype": self._dtype}

    def _anchor_sets(self, graph: Graph) -> List[np.ndarray]:
        raise NotImplementedError


class _DegreeAnchorMixin:
    def _anchor_sets(self, graph: Graph) -> List[np.ndarray]:
        order = np.argsort(-graph.degrees, kind="stable")
        d = min(self.embedding_size, graph.number_of_nodes)
        return [np.asarray([order[j]]) for j in range(d)]


class _NodeLabelAnchorMixin:
    @classmethod
    def requires_node_types(cls) -> bool:
        return True

    def _anchor_sets(self, graph: Graph) -> List[np.ndarray]:
        # The port's Graph has no node types until ROADMAP A6.
        raise ValueError(f"{self.model_name()} requires node types.")


class _ScoreAnchorMixin:
    def __init__(self, scores: Optional[np.ndarray] = None, **kwargs):
        self._scores = None if scores is None else np.asarray(scores)
        super().__init__(**kwargs)

    def _anchor_sets(self, graph: Graph) -> List[np.ndarray]:
        if self._scores is None:
            raise ValueError(
                f"{self.model_name()} requires a `scores` array at construction.")
        if len(self._scores) != graph.number_of_nodes:
            raise ValueError(f"scores has {len(self._scores)} entries for "
                             f"{graph.number_of_nodes} nodes.")
        order = np.argsort(-self._scores, kind="stable")
        d = min(self.embedding_size, graph.number_of_nodes)
        return [np.asarray([order[j]]) for j in range(d)]


class _SPINEBase(_AnchorSketchBase):
    WEIGHTED = False

    def __init__(self, maximum_depth: Optional[int] = None, **kwargs):
        self._maximum_depth = maximum_depth
        super().__init__(**kwargs)

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "maximum_depth": self._maximum_depth}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        sets = self._anchor_sets(graph)
        depth = self._maximum_depth or 32
        init = anchor_init_from_sets(graph.number_of_nodes, sets, self.device)
        dist = multi_source_distances(graph.device(self.device), init, max_depth=depth,
                                      weighted=self.WEIGHTED)
        dist = torch.where(dist >= UNREACHED, float(depth + 1), dist)
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[_clamp_to_dtype(dist, self._dtype)],
            node_names=graph.get_node_names(),
        )


class _WINEBase(_AnchorSketchBase):
    def __init__(self, window_size: int = 2, **kwargs):
        self._window_size = window_size
        super().__init__(**kwargs)

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "window_size": self._window_size}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        sets = self._anchor_sets(graph)
        membership = torch.zeros((graph.number_of_nodes, len(sets)), dtype=torch.float32,
                                 device=self.device)
        for j, nodes in enumerate(sets):
            membership[torch.as_tensor(np.asarray(nodes, np.int64), device=self.device), j] = 1.0
        counts = window_cooccurrence_counts(graph.device(self.device), membership,
                                            self._window_size)
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[_clamp_to_dtype(counts, self._dtype)],
            node_names=graph.get_node_names(),
        )


@register_model
class DegreeSPINE(_DegreeAnchorMixin, _SPINEBase):
    """Reference `degree_spine.py:48`."""

    @classmethod
    def model_name(cls) -> str:
        return "Degree-based SPINE"


@register_model
class DegreeWINE(_DegreeAnchorMixin, _WINEBase):
    """Reference `degree_wine.py:50`."""

    @classmethod
    def model_name(cls) -> str:
        return "Degree-based WINE"


@register_model
class NodeLabelSPINE(_NodeLabelAnchorMixin, _SPINEBase):
    """Reference `node_label_spine.py:45`."""

    @classmethod
    def model_name(cls) -> str:
        return "Node-label-based SPINE"


@register_model
class NodeLabelWINE(_NodeLabelAnchorMixin, _WINEBase):
    """Reference `node_label_wine.py`."""

    @classmethod
    def model_name(cls) -> str:
        return "Node-label-based WINE"


@register_model
class ScoreSPINE(_ScoreAnchorMixin, _SPINEBase):
    """Reference `score_spine.py:53`."""

    @classmethod
    def model_name(cls) -> str:
        return "Score-based SPINE"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "scores": self._scores}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5, "scores": None}


@register_model
class ScoreWINE(_ScoreAnchorMixin, _WINEBase):
    """Reference `score_wine.py`."""

    @classmethod
    def model_name(cls) -> str:
        return "Score-based WINE"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "scores": self._scores}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5, "scores": None}


@register_model
class WeightedSPINE(_DegreeAnchorMixin, _SPINEBase):
    """Weighted shortest paths (Bellman-Ford min-plus) — reference
    `weighted_spine.py:38`."""

    WEIGHTED = True

    @classmethod
    def model_name(cls) -> str:
        return "WeightedSPINE"

    @classmethod
    def requires_edge_weights(cls) -> bool:
        return True

    def __init__(self, use_reciprocal_weights: bool = False, **kwargs):
        self._use_reciprocal_weights = use_reciprocal_weights
        super().__init__(**kwargs)

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(),
                "use_reciprocal_weights": self._use_reciprocal_weights}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        if self._use_reciprocal_weights:
            # A new Graph: its device export carries the new weights.
            graph = dataclasses.replace(
                graph, weights=(1.0 / np.maximum(graph.weights, 1e-9)))
        return super()._fit_transform(graph)


class _RandomConvolutionBase(AbstractEmbeddingModel):
    """Random features smoothed by k rounds of mean aggregation."""

    def __init__(self, embedding_size: int = 100, dtype: Optional[str] = "u8",
                 number_of_convolutions: int = 2, random_state: int = 42,
                 enable_cache: bool = False, device="cuda"):
        self._dtype = dtype
        self._number_of_convolutions = number_of_convolutions
        super().__init__(embedding_size=embedding_size, enable_cache=enable_cache,
                         random_state=random_state, device=device)

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "dtype": self._dtype,
                "number_of_convolutions": self._number_of_convolutions}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5, "number_of_convolutions": 1}

    def _random_features(self, generator: torch.Generator,
                         shape: Tuple[int, int]) -> torch.Tensor:
        raise NotImplementedError

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        generator = torch.Generator(device=self.device).manual_seed(self.random_state or 0)
        x = self._random_features(generator, (graph.number_of_nodes, self.embedding_size))
        rows, cols, vals = kernel_coo(graph, "Left Normalized Laplacian")
        k = csr_kernel(rows, cols, vals, graph.number_of_nodes, device=self.device,
                       with_transpose=False)
        for _ in range(self._number_of_convolutions):
            x = csr_spmm(k, x)
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[x.cpu().numpy().astype(np.float32)],
            node_names=graph.get_node_names(),
        )


@register_model
class RUBICONE(_RandomConvolutionBase):
    """Random-bit convolved embedding (reference `rubicone.py:48`)."""

    @classmethod
    def model_name(cls) -> str:
        return "RUBICONE"

    def _random_features(self, generator, shape):
        return (torch.rand(shape, generator=generator, device=self.device) < 0.5).float()


@register_model
class RUINE(_RandomConvolutionBase):
    """Random-uniform convolved embedding (reference `ruine.py:48`)."""

    @classmethod
    def model_name(cls) -> str:
        return "RUINE"

    def _random_features(self, generator, shape):
        return torch.rand(shape, generator=generator, device=self.device)
