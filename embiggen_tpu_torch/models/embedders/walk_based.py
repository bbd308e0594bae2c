"""Walk-based embedders — counterpart of
`embiggen_tpu/models/embedders/walk_based.py` (`WalkBasedEmbedder`,
`SkipGram`, `CBOW`, the DeepWalk presets and the generic `Node2Vec`), single
device, first-order and p/q walks.

One training step samples start nodes, walks and per-walk negatives
(kernels K2, then K1 for first-order walks or K9 / K10 for p/q walks, then
K2), adds the gradients of the gathered rows into per-node sums and counts
(K3 for SkipGram's banded NCE, K11 for CBOW's sampled softmax) and applies
the per-row mean update to the three tables in one pass that zeroes the sums
again (K4's combine). The sums are allocated once per fit; the tables are
updated in place. An epoch is a loop over steps; its mean loss is read on
the host once per epoch, for the lr plateau and early stopping.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ...graph.graph import Graph, TorchGraph
from ...ops.cbow import cbow_update
from ...ops.negatives import negative_nodes_for_nce, sample_nodes_uniform
from ...ops.scatter import SkipGramSums, skipgram_mean_combine
from ...ops.skipgram import skipgram_nce_update
from ...ops.walks import random_walks
from ...utils.plateau import PlateauController
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from ..registry import register_model

Params = Dict[str, torch.Tensor]


def _device_generator(
    generator: torch.Generator, device: torch.device
) -> torch.Generator:
    """A generator on `device` seeded from a draw of the fit's generator, for
    the dense draws (table init, centre subsampling) made on the device."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


class WalkBasedEmbedder(AbstractEmbeddingModel):
    """Shared training skeleton for walk-based embedders.

    The hyper-parameters are the JAX package's, with the same defaults. Those
    this port does not carry yet raise NotImplementedError naming the ROADMAP
    item that brings them. `device` (default "cuda") is where training runs;
    `initial_params` (e.g. from `utils.convert.skipgram_params_from_jax`)
    replaces the random initial tables."""

    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 10,
        batch_size: Optional[int] = None,
        walk_length: int = 64,
        iterations: int = 1,
        window_size: int = 5,
        return_weight: float = 1.0,
        explore_weight: float = 1.0,
        change_node_type_weight: float = 1.0,
        change_edge_type_weight: float = 1.0,
        max_neighbours: Optional[int] = 100,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.9,
        number_of_negative_samples: int = 10,
        use_scale_free_distribution: bool = True,
        clipping_value: float = 6.0,
        normalize_by_degree: bool = False,
        stochastic_downsample_by_degree: bool = False,
        normalize_learning_rate_by_degree: bool = False,
        early_stopping_min_delta: float = 0.001,
        early_stopping_patience: int = 1,
        learning_rate_plateau_min_delta: float = 0.001,
        learning_rate_plateau_patience: int = 1,
        mesh=None,
        distribution: str = "auto",
        checkpoint_dir: Optional[str] = None,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
        initial_params: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        for name, value in (
            ("change_node_type_weight", change_node_type_weight),
            ("change_edge_type_weight", change_edge_type_weight),
        ):
            if value != 1.0:
                raise NotImplementedError(
                    f"{name}={value}: typed walks are not ported yet "
                    "(ROADMAP A6).")
        if mesh is not None:
            raise NotImplementedError(
                "mesh: multi-device training is not ported yet (ROADMAP A13).")
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir: checkpointing is not ported yet (ROADMAP A12).")
        if distribution not in ("auto", "data", "rows", "none"):
            raise ValueError(
                "distribution must be one of 'auto', 'data', 'rows', "
                f"'none'; got {distribution!r}."
            )
        self._epochs = epochs
        self._batch_size = batch_size
        self._distribution = distribution
        self._walk_length = walk_length
        self._iterations = iterations
        self._window_size = window_size
        self._return_weight = return_weight
        self._explore_weight = explore_weight
        self._change_node_type_weight = change_node_type_weight
        self._change_edge_type_weight = change_edge_type_weight
        # The candidate cap of p/q steps (and the ELL table's width); a
        # first-order step is O(1) whatever the degree and never capped.
        self._max_neighbours = max_neighbours
        self._learning_rate = learning_rate
        self._learning_rate_decay = learning_rate_decay
        self._number_of_negative_samples = number_of_negative_samples
        self._use_scale_free_distribution = use_scale_free_distribution
        self._clipping_value = clipping_value
        # Degree-conditioned SGD knobs of the reference Rust trainers:
        # - stochastic_downsample_by_degree: a centre of degree d is kept
        #   with probability min(1, sqrt(1e-3 * E / d));
        # - normalize_learning_rate_by_degree: each centre's pair gradients
        #   are scaled by min(1, mean_degree / degree(centre));
        # - normalize_by_degree: rows divided by their degree at extraction.
        self._normalize_by_degree = normalize_by_degree
        self._stochastic_downsample_by_degree = stochastic_downsample_by_degree
        self._normalize_learning_rate_by_degree = (
            normalize_learning_rate_by_degree
        )
        self._early_stopping_min_delta = early_stopping_min_delta
        self._early_stopping_patience = early_stopping_patience
        self._learning_rate_plateau_min_delta = learning_rate_plateau_min_delta
        self._learning_rate_plateau_patience = learning_rate_plateau_patience
        self._initial_params = initial_params
        super().__init__(
            embedding_size=embedding_size,
            enable_cache=enable_cache,
            random_state=random_state,
            device=device,
        )
        if walk_length <= 2 * window_size:
            raise ValueError(
                f"walk_length ({walk_length}) must exceed 2*window_size "
                f"({2 * window_size})."
            )

    def _resolve_batch(self, graph: Graph) -> int:
        """Walker batch for this graph: the explicit value, or enough
        concurrent walkers to fill the device, capped at 32768."""
        if self._batch_size is not None:
            return self._batch_size
        return int(min(32768, max(128, graph.number_of_nodes // 8)))

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "epochs": self._epochs,
            "batch_size": self._batch_size,
            "mesh": None,
            "distribution": self._distribution,
            "walk_length": self._walk_length,
            "iterations": self._iterations,
            "window_size": self._window_size,
            "return_weight": self._return_weight,
            "explore_weight": self._explore_weight,
            "change_node_type_weight": self._change_node_type_weight,
            "change_edge_type_weight": self._change_edge_type_weight,
            "max_neighbours": self._max_neighbours,
            "learning_rate": self._learning_rate,
            "learning_rate_decay": self._learning_rate_decay,
            "number_of_negative_samples": self._number_of_negative_samples,
            "use_scale_free_distribution": self._use_scale_free_distribution,
            "clipping_value": self._clipping_value,
            "normalize_by_degree": self._normalize_by_degree,
            "stochastic_downsample_by_degree":
                self._stochastic_downsample_by_degree,
            "normalize_learning_rate_by_degree":
                self._normalize_learning_rate_by_degree,
            "early_stopping_min_delta": self._early_stopping_min_delta,
            "early_stopping_patience": self._early_stopping_patience,
            "learning_rate_plateau_min_delta":
                self._learning_rate_plateau_min_delta,
            "learning_rate_plateau_patience":
                self._learning_rate_plateau_patience,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 5,
            "epochs": 1,
            "walk_length": 8,
            "window_size": 2,
            "batch_size": 32,
            "iterations": 1,
        }

    @classmethod
    def can_use_edge_weights(cls) -> bool:
        return True

    def is_using_edge_weights(self) -> bool:
        return True

    # The reference's typed-walk contract: a model uses node (edge) types
    # iff its change_node_type_weight (change_edge_type_weight) is not 1.
    # The port accepts only 1.0 until typed walks come (ROADMAP A6).
    @classmethod
    def can_use_node_types(cls) -> bool:
        return True

    def is_using_node_types(self) -> bool:
        return self._change_node_type_weight != 1.0

    @classmethod
    def can_use_edge_types(cls) -> bool:
        return True

    def is_using_edge_types(self) -> bool:
        return self._change_edge_type_weight != 1.0

    # ------------------------------------------------------------- the tables
    # The three tables of a model, in `SkipGramSums` order: the input table
    # (sums_w), the output table (sums_c) and its bias (sums_b).
    _TABLES: Tuple[str, str, str]

    def _param_shapes(self, graph: Graph) -> Dict[str, Tuple[int, ...]]:
        n, d = graph.number_of_nodes, self.embedding_size
        w, c, b = self._TABLES
        return {w: (n, d), c: (n, d), b: (n,)}

    def _init_params(self, graph: Graph, generator: torch.Generator) -> Params:
        g = _device_generator(generator, self.device)
        scale = 1.0 / np.sqrt(self.embedding_size)
        return {
            name: (torch.randn(shape, generator=g, device=self.device).mul_(scale)
                   if len(shape) == 2
                   else torch.zeros(shape, device=self.device))
            for name, shape in self._param_shapes(graph).items()
        }

    def _new_sums(self, params: Params) -> SkipGramSums:
        """Zeroed per-node gradient sums and counts for `_update`, allocated
        once per fit."""
        n, d = params[self._TABLES[0]].shape
        return SkipGramSums.zeros(n, d, params[self._TABLES[0]].device)

    def _add_gradients(self, tables, walks, negs, center_w,
                       sums: SkipGramSums) -> torch.Tensor:
        """Add one batch's gradient rows into `sums`; returns the loss sum."""
        raise NotImplementedError

    def _update(self, params: Params, walks, negs, center_w, lr: float,
                sums: SkipGramSums) -> torch.Tensor:
        """One SGD step on `params`, in place, from a batch of walks and
        their per-walk negatives, through `sums` (zero before and after).
        `center_w` ([B, L] or None) weights each centre's losses. Returns
        the loss sum as a 0-d device tensor."""
        # Every touched row takes one full-lr step on the mean of its
        # gradients, all taken at the tables before the step (the combine
        # runs after every walk's update, in stream order). Output and
        # negative rows of the same table share one index multiset, so a row
        # in both roles averages once; the bias reuses the output table's
        # counts.
        tables = tuple(params[name] for name in self._TABLES)
        loss = self._add_gradients(tables, walks, negs, center_w, sums)
        skipgram_mean_combine(*tables, sums, lr)
        return loss

    def _extract(self, params: Params, graph: Graph) -> EmbeddingResult:
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[self._post_process(params[name], graph)
                             for name in self._TABLES[:2]],
            node_names=graph.get_node_names(),
        )

    def _post_process(self, table: torch.Tensor, graph: Graph) -> np.ndarray:
        """The table on the host; `normalize_by_degree` divides each row by
        its node's degree."""
        table = table.detach().cpu().numpy()
        if self._normalize_by_degree:
            deg = np.maximum(graph.degrees.astype(np.float32), 1.0)
            table = table / deg[(...,) + (None,) * (table.ndim - 1)]
        return table

    # ----------------------------------------------------------- training loop
    def _walks_are_biased(self) -> bool:
        """True when walks weigh their candidates (p/q); these take the ELL
        sampler K9."""
        return self._return_weight != 1.0 or self._explore_weight != 1.0

    def _ell_cap_for_walks(self) -> Optional[int]:
        """Width of the ELL table to export: p/q walks need it, at the
        candidate cap; first-order walks do not."""
        if not self._walks_are_biased():
            return None
        return self._max_neighbours or 100

    def _device_graph(self, graph: Graph) -> TorchGraph:
        """The graph on the model's device: alias tables on weighted graphs,
        and for p/q walks the ELL table, whose over-cap rows are a subsample
        seeded by random_state."""
        return graph.device(self.device, with_alias=graph.has_edge_weights,
                            ell_cap=self._ell_cap_for_walks(),
                            ell_seed=self.random_state or 0)

    def _sample_batch(
        self, tg: TorchGraph, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(walks [B·iters, L], negatives [B·iters, K]) for one step.
        Negatives are per walk: each walk's centres contrast against their
        own K draws."""
        starts = sample_nodes_uniform(tg, generator, (batch_size,))
        walks = random_walks(
            tg, starts.repeat(self._iterations), self._walk_length, generator,
            return_weight=self._return_weight,
            explore_weight=self._explore_weight,
            max_neighbours=self._max_neighbours,
        )
        negs = negative_nodes_for_nce(
            tg, generator, self._number_of_negative_samples,
            self._use_scale_free_distribution,
            per_walk=batch_size * self._iterations,
        )
        return walks, negs

    def _center_weights(
        self, tg: TorchGraph, walks: torch.Tensor, generator: torch.Generator
    ) -> Optional[torch.Tensor]:
        """[B, L] per-centre loss weight for the degree-conditioned SGD knobs,
        or None when both are off."""
        if not (
            self._stochastic_downsample_by_degree
            or self._normalize_learning_rate_by_degree
        ):
            return None
        deg = tg.degrees[walks.long()].float().clamp(min=1.0)
        w = torch.ones(walks.shape, dtype=torch.float32, device=walks.device)
        if self._normalize_learning_rate_by_degree:
            mean_deg = max(tg.n_arcs / max(tg.n_nodes, 1), 1.0)
            w = w * (mean_deg / deg).clamp(max=1.0)
        if self._stochastic_downsample_by_degree:
            keep_p = torch.sqrt(1e-3 * max(tg.n_arcs, 1) / deg).clamp(max=1.0)
            u = torch.rand(walks.shape, device=walks.device,
                           generator=_device_generator(generator, walks.device))
            w = w * (u < keep_p).float()
        return w

    def _step(
        self,
        tg: TorchGraph,
        params: Params,
        generator: torch.Generator,
        lr: float,
        batch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        sums=None,
    ) -> torch.Tensor:
        """One step on `params`, in place: sample a batch of the fit's size
        (or take the injected `batch` of (walks, negs)) and update the
        tables through `sums` (the fit's, or fresh ones). Returns the loss
        per centre as a 0-d device tensor."""
        walks, negs = (
            self._sample_batch(tg, generator, self._run_batch_size)
            if batch is None else batch
        )
        center_w = self._center_weights(tg, walks, generator)
        loss = self._update(params, walks, negs, center_w, lr,
                            self._new_sums(params) if sums is None else sums)
        n_centers = walks.shape[0] * (self._walk_length - 2 * self._window_size)
        return loss / n_centers

    def _initial_tables(self, graph: Graph, generator: torch.Generator) -> Params:
        if self._initial_params is None:
            return self._init_params(graph, generator)
        params = {}
        for name, shape in self._param_shapes(graph).items():
            given = self._initial_params[name]
            if tuple(given.shape) != shape:
                raise ValueError(f"initial_params[{name!r}] has shape "
                                 f"{tuple(given.shape)}, expected {shape}.")
            params[name] = given.detach().to(self.device, torch.float32).clone()
        return params

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        tg = self._device_graph(graph)
        generator = torch.Generator().manual_seed(self.random_state or 0)
        batch = self._resolve_batch(graph)
        self._run_batch_size = batch
        params = self._initial_tables(graph, generator)
        sums = self._new_sums(params)
        steps_per_epoch = max(1, graph.number_of_nodes // batch)
        # Early stopping and lr-on-plateau, default-on as in the reference.
        ctrl = PlateauController(
            early_stopping_min_delta=self._early_stopping_min_delta,
            early_stopping_patience=self._early_stopping_patience,
            learning_rate_plateau_min_delta=(
                self._learning_rate_plateau_min_delta
            ),
            learning_rate_plateau_patience=(
                self._learning_rate_plateau_patience
            ),
        )
        self._epoch_losses, self._epoch_seconds = [], []
        last_loss = None
        with torch.no_grad():
            for epoch in range(self._epochs):
                t0 = time.perf_counter()
                lr = (self._learning_rate * self._learning_rate_decay ** epoch
                      * ctrl.lr_scale)
                losses = [self._step(tg, params, generator, lr, sums=sums)
                          for _ in range(steps_per_epoch)]
                # The epoch's one host read, which also waits for the device.
                last_loss = float(torch.stack(losses).mean())
                self._epoch_seconds.append(time.perf_counter() - t0)
                self._epoch_losses.append(last_loss)
                if ctrl.update(last_loss):
                    ctrl.stopped_epoch = epoch
                    break
        self._last_loss = last_loss
        self._stopped_epoch = ctrl.stopped_epoch
        return self._extract(params, graph)


@register_model
class SkipGram(WalkBasedEmbedder):
    """Node2Vec SkipGram with NCE loss over per-walk scale-free negatives."""

    _TABLES = ("node_embedding", "context_embedding", "context_bias")

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec SkipGram"

    def _add_gradients(self, tables, walks, negs, center_w, sums):
        return skipgram_nce_update(*tables, walks, negs, self._window_size,
                                   self._clipping_value, sums, center_w)


@register_model
class CBOW(WalkBasedEmbedder):
    """Node2Vec CBOW: the mean of a centre's window of input rows predicts
    the centre by a sampled softmax against per-walk negatives. Its tables
    share SkipGram's sums layout, so its step is K11 and K4's combine."""

    _TABLES = ("node_embedding", "output_embedding", "output_bias")

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec CBOW"

    def _add_gradients(self, tables, walks, negs, center_w, sums):
        return cbow_update(*tables, walks, negs, self._window_size,
                           self._clipping_value, sums, center_w)


class _FixedPQMixin:
    """DeepWalk presets: p = q = 1 (uniform first-order walks)."""

    def __init__(self, **kwargs):
        for forbidden in ("return_weight", "explore_weight"):
            if forbidden in kwargs:
                raise ValueError(
                    f"{type(self).__name__} does not accept {forbidden!r}: "
                    "DeepWalk walks are first-order (p = q = 1).")
        super().__init__(return_weight=1.0, explore_weight=1.0, **kwargs)

    def parameters(self) -> Dict[str, Any]:
        params = super().parameters()
        params.pop("return_weight", None)
        params.pop("explore_weight", None)
        return params


@register_model
class DeepWalkSkipGram(_FixedPQMixin, SkipGram):
    @classmethod
    def model_name(cls) -> str:
        return "DeepWalk SkipGram"


@register_model
class DeepWalkCBOW(_FixedPQMixin, CBOW):
    @classmethod
    def model_name(cls) -> str:
        return "DeepWalk CBOW"


@register_model
class Node2Vec(SkipGram):
    """Generic "Node2Vec", the name the reference registers from its
    adapters that train SkipGram over p/q walks: the port's SkipGram."""

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec"
