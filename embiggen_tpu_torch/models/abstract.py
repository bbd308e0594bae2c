"""Abstract model interfaces — counterpart of `embiggen_tpu/models/abstract.py`:
naming, the random-state contract, parameter hashing, smoke-test configs
and the embedding-fit validation.
"""
from __future__ import annotations

import hashlib
import json
import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..graph.graph import Graph
from .embedding_result import EmbeddingResult


def _stable_hash(obj: Any) -> str:
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer, np.floating)):
            return o.item()
        return repr(o)

    payload = json.dumps(obj, sort_keys=True, default=default)
    return hashlib.sha256(payload.encode()).hexdigest()


class AbstractModel:
    """Root interface: naming, capabilities, reproducibility, registry hooks."""

    def __init__(self, random_state: Optional[int] = None):
        if self.is_stochastic() and random_state is None:
            raise ValueError(
                f"Model {self.model_name()} is stochastic but no random_state "
                "was provided."
            )
        if not self.is_stochastic() and random_state is not None:
            raise ValueError(
                f"Model {self.model_name()} is deterministic; do not provide "
                "a random_state."
            )
        self._random_state = random_state

    @classmethod
    def task_name(cls) -> str:
        raise NotImplementedError

    @classmethod
    def model_name(cls) -> str:
        raise NotImplementedError

    @classmethod
    def library_name(cls) -> str:
        return "Torch"

    @classmethod
    def is_stochastic(cls) -> bool:
        return True

    @classmethod
    def requires_edge_types(cls) -> bool:
        return False

    @classmethod
    def requires_edge_weights(cls) -> bool:
        return False

    @classmethod
    def requires_positive_edge_weights(cls) -> bool:
        return cls.requires_edge_weights()

    @classmethod
    def requires_node_types(cls) -> bool:
        return False

    @classmethod
    def can_use_edge_weights(cls) -> bool:
        return cls.requires_edge_weights()

    @classmethod
    def can_use_node_types(cls) -> bool:
        return cls.requires_node_types()

    @classmethod
    def can_use_edge_types(cls) -> bool:
        return cls.requires_edge_types()

    def is_using_edge_weights(self) -> bool:
        return self.can_use_edge_weights()

    def is_using_node_types(self) -> bool:
        return self.can_use_node_types()

    def is_using_edge_types(self) -> bool:
        return self.can_use_edge_types()

    @classmethod
    def is_topological(cls) -> bool:
        """Whether the features this model produces depend on graph topology
        (the evaluation harness refits such features per holdout)."""
        return True

    @property
    def random_state(self) -> Optional[int]:
        return self._random_state

    def set_random_state(self, random_state: int) -> None:
        self._random_state = random_state

    def parameters(self) -> Dict[str, Any]:
        return {"random_state": self._random_state} if self.is_stochastic() else {}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {}

    @classmethod
    def into_smoke_test(cls, **kwargs) -> "AbstractModel":
        params = dict(cls.smoke_test_parameters())
        params.update(kwargs)
        return cls(**params)

    def clone(self) -> "AbstractModel":
        return type(self)(**self.parameters())

    def consistent_hash(self) -> str:
        return _stable_hash(
            {
                "task": self.task_name(),
                "model": self.model_name(),
                "library": self.library_name(),
                "parameters": self.parameters(),
            }
        )

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.parameters().items())
        return f"{type(self).__name__}({params})"


class AbstractEmbeddingModel(AbstractModel):
    """Embedding contract: `fit_transform(graph) -> EmbeddingResult` with the
    reference's validity pre-checks. A model trains on the explicit `device`
    it is given and never moves elsewhere on its own; the device is not a
    hyper-parameter, so it stays out of `parameters()` and the hash."""

    def __init__(
        self,
        embedding_size: int = 100,
        enable_cache: bool = False,
        random_state: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if embedding_size <= 0:
            raise ValueError(f"embedding_size must be positive, got {embedding_size}")
        self._embedding_size = int(embedding_size)
        self._enable_cache = enable_cache
        self._device = torch.device(device)
        super().__init__(random_state=random_state)

    @classmethod
    def task_name(cls) -> str:
        return "Node Embedding"

    @property
    def embedding_size(self) -> int:
        return self._embedding_size

    @property
    def device(self) -> torch.device:
        return self._device

    def clone(self) -> "AbstractEmbeddingModel":
        return type(self)(**self.parameters(), device=self._device)

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "embedding_size": self._embedding_size,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5}

    @classmethod
    def requires_nodes_sorted_by_decreasing_node_degree(cls) -> bool:
        return False

    def _validate_graph(self, graph: Graph) -> None:
        if graph.number_of_nodes == 0:
            raise ValueError(f"Graph {graph.name} has no nodes.")
        if graph.number_of_directed_edges == 0:
            raise ValueError(f"Graph {graph.name} has no edges.")
        if (
            self.requires_nodes_sorted_by_decreasing_node_degree()
            and not graph.is_sorted_by_decreasing_outbound_node_degree()
        ):
            raise ValueError(
                f"Model {self.model_name()} requires the graph nodes to be "
                "sorted by decreasing outbound degree; call "
                "graph.sort_by_decreasing_outbound_node_degree() first."
            )
        if self.requires_edge_weights() and not graph.has_edge_weights:
            raise ValueError(
                f"Model {self.model_name()} requires edge weights but graph "
                f"{graph.name} has none."
            )
        if self.requires_node_types() and not graph.has_node_types:
            raise ValueError(
                f"Model {self.model_name()} requires node types but graph "
                f"{graph.name} has none."
            )
        if self.requires_edge_types() and not graph.has_edge_types:
            raise ValueError(
                f"Model {self.model_name()} requires edge types but graph "
                f"{graph.name} has none."
            )
        if (graph.degrees == 0).any():
            inbound = np.zeros(graph.number_of_nodes, dtype=bool)
            inbound[graph.col_idx] = True
            if (~inbound & (graph.degrees == 0)).any():
                warnings.warn(
                    f"Graph {graph.name} contains disconnected nodes; their "
                    "embeddings will not be trained meaningfully."
                )

    def fit_transform(
        self,
        graph: Graph,
        return_dataframe: bool = False,
    ) -> EmbeddingResult:
        if isinstance(graph, str):
            from ..graph.loaders import get_dataset

            graph = get_dataset(graph)
        self._validate_graph(graph)
        if return_dataframe and graph.number_of_nodes > 100_000_000:
            raise ValueError(
                "Refusing to build a >100M-row DataFrame; set "
                "return_dataframe=False."
            )
        result = self._cached_fit_transform(graph)
        if return_dataframe:
            result = result.to_dataframes()
        return result

    def _cached_fit_transform(self, graph: Graph) -> EmbeddingResult:
        """`_fit_transform`, through the on-disk cache when `enable_cache`:
        keyed by the model's hash, its device type (a fit on the card and a
        fit on the CPU draw differently from one seed) and the graph's hash,
        at the reference's `embedding/{model}/{library}/{graph}/{hash}.pkl.gz`
        under `utils.cache.DEFAULT_CACHE_DIR`."""
        from ..utils.cache import Cache

        cached = Cache(
            "embedding/{model_name}/{library_name}/{graph_name}/{hash}.pkl.gz"
        )(type(self)._fit_transform)
        return cached(self, graph)

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        raise NotImplementedError
