"""Walklets: multi-scale embeddings from stride-p walk pairs — counterpart of
`embiggen_tpu/models/embedders/walklets.py` (`WalkletsSkipGram`,
`WalkletsCBOW`, `WalkletsGloVe`), single device.

For each power p in 1..P the training pairs are walk positions exactly p
apart; each power trains its own [N, embedding_size // P] slice of the
stacked [P, N, sub] tables, and the result concatenates the scales per node.

A SkipGram or CBOW step samples start nodes, walks and per-walk negatives
(K2, then K1 for first-order walks or K9 / K10 for p/q walks, then K2), adds
every power's gradient rows into sums of P * N rows (K12) and applies the
per-row mean update of all powers in one pass over the flat [P * N, sub]
views (K4's SkipGram combine). As in the reference, no clipping and no
centre weights apply. Walklets GloVe builds each power's exact-stride counts
(K13a) from walks of every node and runs GloVe's SGD on them, in place on the
power's slices (K13b, on one workspace a fit).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...graph.graph import Graph
from ...ops.glove import (
    GloVeStepWorkspace, cooccurrences, draw_entries, glove_entries, glove_step,
)
from ...ops.negatives import BatchDraws
from ...ops.scatter import SkipGramSums, skipgram_mean_combine
from ...ops.walklets import walklets_update
from ...ops.walks import random_walks
from ...parallel.mesh import resolve_mesh
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .glove import glove_dp_step
from .walk_based import WalkBasedEmbedder, _device_generator


class _WalkletsBase(WalkBasedEmbedder):
    _TABLES = ("node_embedding", "context_embedding", "context_bias")
    _MODE: str

    def __init__(self, power: int = 4, **kwargs):
        self._power = power
        kwargs.setdefault("window_size", 4)
        super().__init__(**kwargs)
        if self.embedding_size % power:
            raise ValueError(
                f"embedding_size ({self.embedding_size}) must be divisible "
                f"by power ({power})."
            )

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "power": self._power}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 4, "power": 2, "epochs": 1, "walk_length": 8,
            "window_size": 2, "batch_size": 32,
        }

    def _param_shapes(self, graph: Graph) -> Dict[str, Tuple[int, ...]]:
        p, n = self._power, graph.number_of_nodes
        sub = self.embedding_size // p
        return {"node_embedding": (p, n, sub), "context_embedding": (p, n, sub),
                "context_bias": (p, n)}

    def _init_params(self, graph: Graph, generator: torch.Generator):
        g = _device_generator(generator, self.device)
        shapes = self._param_shapes(graph)
        scale = 1.0 / np.sqrt(shapes["node_embedding"][2])
        return {name: (torch.randn(shape, generator=g, device=self.device).mul_(scale)
                       if len(shape) == 3
                       else torch.zeros(shape, device=self.device))
                for name, shape in shapes.items()}

    def _new_sums(self, params) -> SkipGramSums:
        p, n, sub = params["node_embedding"].shape
        return SkipGramSums.zeros(p * n, sub, params["node_embedding"].device)

    def _center_weights(self, tg, walks, generator) -> None:
        """None: as in the reference, no centre weights apply."""
        return None

    def _add_gradients(self, tables, walks, negs, center_w, sums):
        """K12 into `sums` over the stacked tables; the loss sum per power
        [P]."""
        return walklets_update(*tables, walks, negs, self._power, sums, self._MODE)

    def _update(self, params, walks, negs, center_w, lr, sums):
        """One step on the stacked tables, in place: K12 into `sums`, then
        one combine over the flat views for all powers. Returns the loss sum
        per power [P]."""
        loss = self._add_gradients(tuple(params[name] for name in self._TABLES), walks,
                                   negs, None, sums)
        skipgram_mean_combine(*self._flat_tables(params), sums, lr)
        return loss

    def _loss_per_centre(self, loss, walks) -> torch.Tensor:
        """The sum over powers of the loss per pair of that power, divided
        by the power, as the reference reports it."""
        b, length = walks.shape
        strides = torch.arange(1, self._power + 1, device=loss.device)
        return (loss / (2 * b * (length - strides))).sum() / self._power

    def _step(self, tg, params, generator, lr, batch=None, sums=None) -> torch.Tensor:
        """One step on `params`, in place (see `WalkBasedEmbedder._step`);
        returns `_loss_per_centre`."""
        walks, negs = (
            self._sample_batch(tg, generator, self._run_batch_size)
            if batch is None else batch
        )
        loss = self._update(params, walks, negs, None, lr,
                            self._new_sums(params) if sums is None else sums)
        return self._loss_per_centre(loss, walks)

    # The distributed steps' compact tables are the stacked tables' rows of
    # the batch's ids in every power: flat row p N + id of the [P N, sub]
    # views, gathered as [P U, sub] and viewed as [P, U, sub].
    def _flat_tables(self, params):
        p, n, sub = params["node_embedding"].shape
        return (params["node_embedding"].view(p * n, sub),
                params["context_embedding"].view(p * n, sub),
                params["context_bias"].view(p * n))

    def _compact_ids(self, uniq, params):
        p, n, _ = params["node_embedding"].shape
        powers = torch.arange(p, dtype=torch.int32, device=uniq.device)[:, None] * n
        return (powers + uniq[None, :]).reshape(-1)

    def _compact_tables(self, rows, n_uniq):
        p = self._power
        return (rows[0].view(p, n_uniq, -1), rows[1].view(p, n_uniq, -1),
                rows[2].view(p, n_uniq))

    def _choose_distribution(self, mesh, graph: Graph) -> str:
        strategy = super()._choose_distribution(mesh, graph)
        if strategy == "rows":
            warnings.warn("Walklets tables are stacked per power; the row-sharded "
                          "strategy does not apply, using data parallelism.")
            return "data"
        return strategy

    def _extract(self, params, graph: Graph) -> EmbeddingResult:
        p, n, sub = params["node_embedding"].shape
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[
                self._post_process(params[name].permute(1, 0, 2).reshape(n, p * sub), graph)
                for name in self._TABLES[:2]
            ],
            node_names=graph.get_node_names(),
        )


@register_model
class WalkletsSkipGram(_WalkletsBase):
    """Per-power NCE: each pair's input row against its target row and the
    walk's K negatives."""

    _MODE = "skipgram"

    @classmethod
    def model_name(cls) -> str:
        return "Walklets SkipGram"


@register_model
class WalkletsCBOW(_WalkletsBase):
    """CBOW at each scale: the stride-p 'context' is the single node p hops
    away, its target predicted by a sampled softmax against the walk's K
    negatives."""

    _MODE = "cbow"

    @classmethod
    def model_name(cls) -> str:
        return "Walklets CBOW"


@register_model
class WalkletsGloVe(_WalkletsBase):
    """GloVe's weighted least squares per scale: the exact-stride counts of
    a walk corpus (walks from every node, `iterations` times each) are built
    once per power, then that power's tables minimise
    f(X)(w . c + b_w + b_c - log X)^2 over its non-zero entries with
    minibatch SGD ("add" updates), at lr * decay^epoch with no plateau.
    Each power starts a fresh zero b_c; `context_bias` keeps b_w, as the
    reference does."""

    def __init__(self, alpha: float = 0.75, x_max: float = 100.0, **kwargs):
        self._alpha = alpha
        self._x_max = x_max
        super().__init__(**kwargs)

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "alpha": self._alpha, "x_max": self._x_max}

    @classmethod
    def model_name(cls) -> str:
        return "Walklets GloVe"

    def _glove_step(self, state, entries, ids, lr: float,
                    workspace: Optional[GloVeStepWorkspace] = None) -> torch.Tensor:
        """One SGD step on a power's state (emb, ctx, bw, bc), in place, from
        the drawn entry ids (K13b, on `workspace`, which a fit allocates
        once; fresh buffers where none is given); returns the batch's mean
        loss."""
        return glove_step(entries, ids, state["emb"], state["ctx"], state["bw"], state["bc"],
                          lr, workspace) / ids.shape[0]

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        mesh = resolve_mesh(self._mesh)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the model trains on {self.device}, its mesh's ranks on "
                             f"{mesh.device}.")
        data_parallel = self._choose_distribution(mesh, graph) == "data"
        tg = self._device_graph(graph)
        generator = torch.Generator().manual_seed(self.random_state or 0)
        n = graph.number_of_nodes
        starts = torch.arange(n, dtype=torch.int32, device=self.device).repeat(
            self._iterations)
        walks = random_walks(tg, starts, self._walk_length, generator, **self._walk_kwargs())
        params = self._initial_tables(graph, generator)
        self._epoch_losses, self._epoch_seconds = [], []
        last, workspace, draws = None, None, None
        sub = params["node_embedding"].shape[2]
        with torch.no_grad():
            for p in range(self._power):
                # The counts of the pairs exactly p + 1 apart.
                ci, cj, counts = cooccurrences(walks, n, [(p + 1, 1.0)])
                if ci.shape[0] == 0:
                    raise ValueError(f"Walklets GloVe: no co-occurrences at stride {p + 1}.")
                entries = glove_entries(ci, cj, counts, self._x_max, self._alpha)
                batch = min(self._batch_size or 4096, entries.n_entries)
                steps = max(1, entries.n_entries // batch)
                if data_parallel:
                    # Id slices divide evenly over the mesh (drawn with
                    # replacement, so a batch may exceed the entries).
                    batch = -(-batch // mesh.size) * mesh.size
                # A rank's gradient launch takes B / P of the entries.
                rows = batch // mesh.size if data_parallel else batch
                if workspace is None or workspace.rows.shape[0] != rows:
                    workspace = GloVeStepWorkspace.empty(rows, sub, walks.device)
                if walks.device.type == "cuda" and (draws is None
                                                    or draws.block.shape[0] != batch):
                    # K2's ids at one key and an offset a batch.
                    draws = BatchDraws(torch.empty((batch,), dtype=torch.int32,
                                                   device=walks.device))
                # Views of power p's slices: the steps update the tables in
                # place.
                state = {"emb": params["node_embedding"][p],
                         "ctx": params["context_embedding"][p],
                         "bw": params["context_bias"][p],
                         "bc": torch.zeros_like(params["context_bias"][p])}
                tables = [state[k] for k in ("emb", "ctx", "bw", "bc")]
                for epoch in range(self._epochs):
                    t0 = time.perf_counter()
                    lr = self._learning_rate * self._learning_rate_decay ** epoch
                    losses = [
                        glove_dp_step(mesh, entries, draw_entries(entries, batch, generator,
                                                                  draws),
                                      tables, lr, workspace) / batch
                        if data_parallel else
                        self._glove_step(state, entries, draw_entries(entries, batch, generator,
                                                                      draws),
                                         lr, workspace)
                        for _ in range(steps)]
                    last = float(torch.stack(losses).mean())
                    self._epoch_seconds.append(time.perf_counter() - t0)
                    self._epoch_losses.append(last)
                del entries
        self._last_loss = last
        return self._extract(params, graph)
