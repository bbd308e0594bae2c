"""GloVe over walk co-occurrences, with its Node2Vec and DeepWalk presets —
counterpart of `embiggen_tpu/models/embedders/glove.py` (`GloVe`,
`DeepWalkGloVe`), single device.

(1) Walks from every node, `iterations` times each (K1, or K9 / K10 for p/q
walks); (2) their window pairs at distance d = 1..w weighted 1/d, summed per
distinct (center, context) key (K13a); (3) minibatch SGD over the non-zero
entries on the weighted least squares f(X)(w_i . c_j + b_i + b_j - log X)^2,
a batch mean: each step draws entry ids (K2's uniform mode) and applies the
reference's "add" updates in place (K13b: a gradient launch and two update
launches on a workspace the fit allocates once), every gradient taken before
any table changes. Built on the `MinibatchEmbedder` skeleton, whose batch is
the drawn ids and whose shared part is the entries.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...graph.graph import Graph
from ...ops.glove import (
    Entries, GloVeStepWorkspace, cooccurrences, draw_entries, glove_entries, glove_step,
    glove_strides,
)
from ...ops.walks import random_walks
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import MinibatchEmbedder


@register_model
class GloVe(MinibatchEmbedder):
    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 30,
        walk_length: int = 64,
        iterations: int = 4,
        window_size: int = 5,
        return_weight: float = 1.0,
        explore_weight: float = 1.0,
        change_node_type_weight: float = 1.0,
        change_edge_type_weight: float = 1.0,
        max_neighbours: Optional[int] = 100,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.95,
        alpha: float = 0.75,
        x_max: float = 100.0,
        batch_size: int = 65536,
        **kwargs,
    ):
        for name, value in (("change_node_type_weight", change_node_type_weight),
                            ("change_edge_type_weight", change_edge_type_weight)):
            if value != 1.0:
                raise NotImplementedError(
                    f"{name}={value}: typed walks are not ported yet (ROADMAP A6).")
        self._walk_length = walk_length
        self._iterations = iterations
        self._window_size = window_size
        self._return_weight = return_weight
        self._explore_weight = explore_weight
        self._max_neighbours = max_neighbours
        self._alpha = alpha
        self._x_max = x_max
        super().__init__(
            embedding_size=embedding_size,
            epochs=epochs,
            batch_size=batch_size,
            learning_rate=learning_rate,
            learning_rate_decay=learning_rate_decay,
            **kwargs,
        )

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec GloVe"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "walk_length": self._walk_length,
            "iterations": self._iterations,
            "window_size": self._window_size,
            "return_weight": self._return_weight,
            "explore_weight": self._explore_weight,
            "change_node_type_weight": 1.0,
            "change_edge_type_weight": 1.0,
            "max_neighbours": self._max_neighbours,
            "alpha": self._alpha,
            "x_max": self._x_max,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 5, "epochs": 2, "walk_length": 8,
            "window_size": 2, "iterations": 1,
        }

    # ----------------------------------------------------------- co-occurrence
    def _walks(self, graph: Graph) -> torch.Tensor:
        """`iterations` walks from every node on the model's device; the ELL
        table is exported only for p/q walks."""
        second_order = self._return_weight != 1.0 or self._explore_weight != 1.0
        tg = graph.device(self.device, with_alias=graph.has_edge_weights,
                          ell_cap=(self._max_neighbours or 100) if second_order else None,
                          ell_seed=self.random_state or 0)
        starts = torch.arange(graph.number_of_nodes, dtype=torch.int32,
                              device=self.device).repeat(self._iterations)
        return random_walks(tg, starts, self._walk_length,
                            torch.Generator().manual_seed(self.random_state or 0),
                            return_weight=self._return_weight,
                            explore_weight=self._explore_weight,
                            max_neighbours=self._max_neighbours)

    # ------------------------------------------------------- minibatch hooks
    def _prepare_data(self, graph: Graph) -> Entries:
        # Window pairs at distance d = 1..w, weighted 1/d (GloVe's decay).
        counts = cooccurrences(self._walks(graph), graph.number_of_nodes,
                               glove_strides(self._window_size))
        entries = glove_entries(*counts, self._x_max, self._alpha)
        if entries.n_entries == 0:
            raise ValueError(f"{self.model_name()}: the walks of graph {graph.name} "
                             "have no co-occurrences.")
        self._n_entries = entries.n_entries
        return entries

    def _param_shapes(self, n_nodes: int, n_edge_types: int):
        d = self.embedding_size
        return {"node_embedding": (n_nodes, d), "context_embedding": (n_nodes, d),
                "center_bias": (n_nodes,), "context_bias": (n_nodes,)}

    def _init_table(self, name, shape, g):
        if len(shape) == 1:
            return torch.zeros(shape, device=self.device)
        return super()._init_table(name, shape, g)

    def _resolve_batch_size(self, graph: Graph, ctx) -> int:
        return int(min(self._batch_size or 65536, self._n_entries))

    def _steps_per_epoch(self, graph: Graph, ctx, batch: int) -> int:
        return max(1, self._n_entries // batch)

    def _sample_batch(self, ctx: Entries, generator: torch.Generator, batch_size: int):
        return (draw_entries(ctx, batch_size, generator),), ctx

    def _step(self, ctx: Entries, params, generator: torch.Generator, lr: float,
              batch=None) -> torch.Tensor:
        """One step on `params`, in place: draw B entry ids (or take the
        injected `batch`), apply the step (K13b on the fit's workspace).
        Returns the loss per entry as a 0-d device tensor. The step returns
        no Update, so the model is single-device (`supports_distribution`
        is False; the reference's GloVe is distributable) until ROADMAP
        A13."""
        size = self._run_batch()
        if batch is None:
            batch = self._sample_batch(ctx, generator, size)
        (ids,), entries = batch
        ws = self._fit_buffer("glove_step", lambda: GloVeStepWorkspace.empty(
            size, self.embedding_size, params["node_embedding"].device))
        return glove_step(entries, ids, params["node_embedding"], params["context_embedding"],
                          params["center_bias"], params["context_bias"], lr, ws) / size

    def _extract(self, params, graph: Graph) -> EmbeddingResult:
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[params["node_embedding"].cpu().numpy(),
                             params["context_embedding"].cpu().numpy()],
            node_names=graph.get_node_names(),
        )


@register_model
class DeepWalkGloVe(GloVe):
    """GloVe on first-order walks."""

    @classmethod
    def model_name(cls) -> str:
        return "DeepWalk GloVe"

    def __init__(self, **kwargs):
        for forbidden in ("return_weight", "explore_weight"):
            if forbidden in kwargs:
                raise ValueError(
                    f"{type(self).__name__} does not accept {forbidden!r}.")
        super().__init__(return_weight=1.0, explore_weight=1.0, **kwargs)

    def parameters(self) -> Dict[str, Any]:
        p = super().parameters()
        p.pop("return_weight", None)
        p.pop("explore_weight", None)
        return p
