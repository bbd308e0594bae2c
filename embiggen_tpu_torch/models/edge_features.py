"""Edge-feature protocol and HyperSketching — counterpart of
`embiggen_tpu/models/edge_features.py` (the reference's lazy per-batch
edge-feature surface and its dual embedder / edge feature `HyperSketching`:
hops 3, precision 8, bits 6; feature width hops² + 2·hops).

`fit(support)` builds the [N, hops, 2^precision] HLL sketches of the
support graph on the model's device (kernel K16a); the features of any
(src, dst) pairs are kernel K16b's overlaps and differences. The GCNs take
them per batch through `device_feature_fn`, with no gradient.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..graph.graph import Graph
from ..ops.hll import edge_sketch_features, khop_sketches_of_singletons
from .abstract import AbstractEmbeddingModel
from .embedding_result import EmbeddingResult
from .registry import register_model

# Pairs per K16b call when features go to the host: 2^22 pairs of 15
# features are 252 MB.
_PAIR_CHUNK = 1 << 22


class AbstractEdgeFeature:
    """Lazy per-batch edge-feature protocol: fitted on a support graph, then
    queried for arbitrary (src, dst) batches during training and
    inference."""

    def fit(self, support: Graph) -> "AbstractEdgeFeature":
        raise NotImplementedError

    def is_fit(self) -> bool:
        raise NotImplementedError

    @classmethod
    def get_feature_dictionary_keys(cls) -> List[str]:
        raise NotImplementedError

    def get_feature_dictionary_shapes(self) -> Dict[str, List[int]]:
        raise NotImplementedError

    def get_edge_feature_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_edge_feature_from_graph(self, graph: Graph) -> Dict[str, np.ndarray]:
        return self.get_edge_feature_from_edge_node_ids(graph.sources, graph.col_idx)


@register_model
class HyperSketching(AbstractEmbeddingModel, AbstractEdgeFeature):
    """HLL k-hop ball sketches; edge features are the pairwise hop overlaps
    and the left and right difference cardinalities."""

    def __init__(
        self,
        number_of_hops: int = 3,
        precision: int = 8,
        bits: int = 6,
        normalize: bool = False,
        zero_out_differences_cardinalities: bool = False,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        if not 4 <= precision <= 12:
            raise ValueError("precision must be in [4, 12]")
        self._number_of_hops = number_of_hops
        self._precision = precision
        self._bits = bits
        self._normalize = normalize
        self._zero_out_differences_cardinalities = zero_out_differences_cardinalities
        self._sketches: Optional[torch.Tensor] = None
        super().__init__(
            # the feature width, for the embedding_size contract
            embedding_size=number_of_hops ** 2 + 2 * number_of_hops,
            enable_cache=enable_cache, random_state=random_state, device=device,
        )

    @classmethod
    def model_name(cls) -> str:
        return "HyperSketching"

    def parameters(self) -> Dict[str, Any]:
        params = super().parameters()
        params.pop("embedding_size", None)
        return {
            **params,
            "number_of_hops": self._number_of_hops,
            "precision": self._precision,
            "bits": self._bits,
            "normalize": self._normalize,
            "zero_out_differences_cardinalities":
                self._zero_out_differences_cardinalities,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"number_of_hops": 2, "precision": 4}

    # ------------------------------------------------- AbstractEdgeFeature
    def fit(self, support: Graph) -> "HyperSketching":
        self._sketches = khop_sketches_of_singletons(
            support.device(self.device), self._number_of_hops, self._precision, self._bits,
            seed=self.random_state or 0)
        return self

    def is_fit(self) -> bool:
        return self._sketches is not None

    @classmethod
    def get_feature_dictionary_keys(cls) -> List[str]:
        return ["edge_features"]

    def get_feature_dictionary_shapes(self) -> Dict[str, List[int]]:
        h = self._number_of_hops
        return {"edge_features": [h * h + 2 * h]}

    def get_edge_feature_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> Dict[str, np.ndarray]:
        """Features of (src, dst) pairs on the host, by chunks of K16b on the
        model's device; `zero_out_differences_cardinalities` zeroes the
        difference columns and `normalize` divides each row by its largest
        entry, as in the reference."""
        fn = self.device_feature_fn()
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        h = self._number_of_hops
        out = np.empty((len(src), h * h + 2 * h), np.float32)
        for i in range(0, len(src), _PAIR_CHUNK):
            feats = fn(torch.from_numpy(src[i:i + _PAIR_CHUNK]).to(self.device),
                       torch.from_numpy(dst[i:i + _PAIR_CHUNK]).to(self.device))
            if self._zero_out_differences_cardinalities:
                feats[:, h * h:] = 0.0
            if self._normalize:
                feats = feats / torch.clamp(feats.max(dim=1, keepdim=True).values, min=1e-9)
            out[i:i + len(feats)] = feats.cpu().numpy()
        return {"edge_features": out}

    def device_feature_fn(self) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """(src, dst) int32 tensors on the model's device -> [B, F] float32
        features (K16b on the card): what the edge GCNs query per batch."""
        if not self.is_fit():
            raise ValueError("HyperSketching must be fitted first.")
        sketches = self._sketches
        precision = self._precision
        return lambda src, dst: edge_sketch_features(sketches, src, dst, precision)

    # ------------------------------------------------------------- embedder
    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        self.fit(graph)
        feats = self.get_edge_feature_from_graph(graph)["edge_features"]
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            edge_embeddings=[feats],
            node_names=graph.get_node_names(),
        )
