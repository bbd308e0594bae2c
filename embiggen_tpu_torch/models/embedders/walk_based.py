"""Walk-based embedders — counterpart of
`embiggen_tpu/models/embedders/walk_based.py` (`WalkBasedEmbedder`,
`SkipGram`, `CBOW`, the DeepWalk presets and the generic `Node2Vec`), single
device, first-order, p/q and typed walks.

One training step samples start nodes, walks and per-walk negatives (one
fused launch for first-order walks, `ops.negatives.first_order_batch`; K2,
then K9 / K10 for p/q walks or K9 / K19 for typed walks, then K2, the K2
draws at a key the fit draws once), adds the gradients of the gathered rows into
per-node sums and counts (K3 for SkipGram's banded NCE, K11 for CBOW's
sampled softmax) and applies the per-row mean update to the three tables in
one pass that zeroes the sums again (K4's combine). The sums are allocated
once per fit; the tables are updated in place. An epoch is a loop over steps; its mean loss is read on
the host once per epoch, for the lr plateau and early stopping.

With `mesh` (see `parallel.mesh.resolve_mesh`) a fit trains over
torch.distributed, one process per rank, every rank drawing the same global
batch from the same seed. The distributed steps run the same kernels on
compact tables: the batch's U distinct rows (U at most B L + B K, growing
with the batch and not with N) are gathered (K17d; on row-sharded tables
followed by an all-reduce), K3 / K11 (K12 for Walklets) adds the gradients
of the rank's slice of the walks (data-parallel) or of the whole batch
(row-sharded) into compact sums, the data-parallel ranks all-reduce those
sums and counts, and the per-row mean step is applied through the id map
(K17c): to every row of the replicated tables, or to the rows a rank owns.
"""
from __future__ import annotations

import functools
import os
import time
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ...graph.graph import Graph, TorchGraph
from ...ops.cbow import cbow_update
from ...ops.negatives import (
    BatchDraws, first_order_batch, negative_nodes_for_nce, sample_nodes_uniform,
)
from ...ops.scatter import SkipGramSums, skipgram_mean_combine
from ...ops.sharded import owned_gather, owned_scatter
from ...ops.skipgram import skipgram_nce_update
from ...ops.walks import random_walks
from ...parallel.mesh import Mesh, all_reduce, resolve_mesh
from ...parallel.sharded_table import shard_rows, unshard_rows
from ...utils.checkpoint import FitCheckpoint, RandomState
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

    The hyper-parameters are the JAX package's, with the same defaults. With
    `checkpoint_dir` the fit saves its state every `checkpoint_interval`
    epochs to `<checkpoint_dir>/embed_state.npz` and a later fit of the same
    run resumes from it (`utils.checkpoint`). `device` (default "cuda") is where training runs;
    `initial_params` (e.g. from `utils.convert.skipgram_params_from_jax`)
    replaces the random initial tables. `mesh` (None, "auto", an int or a
    `parallel.Mesh`) trains over torch.distributed; `distribution` picks
    "data" (replicated tables), "rows" (row-sharded tables), "none", or
    "auto": rows when the tables take more than a quarter of the device's
    memory (`_table_budget`), else data."""

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
        checkpoint_interval: int = 1,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
        initial_params: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        if distribution not in ("auto", "data", "rows", "none"):
            raise ValueError(
                "distribution must be one of 'auto', 'data', 'rows', "
                f"'none'; got {distribution!r}."
            )
        self._mesh = mesh
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = max(1, checkpoint_interval)
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
        # The fit's `BatchDraws` on the card (`_batch_draws`), None between fits.
        self._draws = None
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

    def __getstate__(self) -> Dict[str, Any]:
        # The fit's draws are a device workspace: a pickle leaves them out.
        return {**self.__dict__, "_draws": None}

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
            "mesh": self._mesh.size if isinstance(self._mesh, Mesh) else self._mesh,
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

    @classmethod
    def supports_distribution(cls) -> bool:
        """True when the model implements the compact-gradient hook
        `_add_gradients` (and can therefore train data-parallel or
        row-sharded on a mesh)."""
        return cls._add_gradients is not WalkBasedEmbedder._add_gradients

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
    def _walks_are_typed(self) -> bool:
        return (self._change_node_type_weight != 1.0
                or self._change_edge_type_weight != 1.0)

    def _walks_are_biased(self) -> bool:
        """True when walks weigh their candidates (p/q or typed factors);
        these take the ELL sampler K9."""
        return (self._return_weight != 1.0 or self._explore_weight != 1.0
                or self._walks_are_typed())

    def _ell_cap_for_walks(self) -> Optional[int]:
        """Width of the ELL table to export: biased walks need it, at the
        candidate cap; first-order walks do not."""
        if not self._walks_are_biased():
            return None
        return self._max_neighbours or 100

    def _walk_kwargs(self) -> Dict[str, Any]:
        """The walk hyper-parameters `random_walks` takes."""
        return dict(return_weight=self._return_weight,
                    explore_weight=self._explore_weight,
                    max_neighbours=self._max_neighbours,
                    change_node_type_weight=self._change_node_type_weight,
                    change_edge_type_weight=self._change_edge_type_weight)

    def _device_graph(self, graph: Graph) -> TorchGraph:
        """The graph on the model's device: alias tables on weighted graphs,
        for biased walks the ELL table, whose over-cap rows are a subsample
        seeded by random_state, and for typed walks its type tables; for
        first-order walks on the card the arcs' records (a step one load)."""
        first_order = not self._walks_are_biased()
        return graph.device(self.device, with_alias=graph.has_edge_weights,
                            ell_cap=self._ell_cap_for_walks(),
                            ell_seed=self.random_state or 0,
                            with_walk_types=self._walks_are_typed(),
                            with_walk_arcs=first_order and self.device.type == "cuda")

    def _batch_draws(self, tg: TorchGraph, batch_size: int) -> Optional[BatchDraws]:
        """The fit's draws on the card: one block for the step's walks,
        negatives and starts (`BatchDraws.walks`), allocated at the first
        batch, with one Philox key drawn from the fit's generator then and a
        counter offset a launch. None on the CPU."""
        if tg.col_idx.device.type != "cuda":
            return None
        shapes = BatchDraws.walk_shapes(batch_size, self._iterations, self._walk_length,
                                        self._number_of_negative_samples)
        draws = self._draws
        if draws is None or tuple(tuple(v.shape) for v in draws.views) != shapes[:-1]:
            draws = self._draws = BatchDraws.walks(
                batch_size, self._iterations, self._walk_length,
                self._number_of_negative_samples, tg.device)
        return draws

    def _sample_batch(
        self, tg: TorchGraph, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(walks [B·iters, L], negatives [B·iters, K]) for one step.
        Negatives are per walk: each walk's centres contrast against their
        own K draws. First-order walks are one fused launch on the card;
        biased and typed walks draw their starts and negatives with K2 at
        the fit's key (`_batch_draws`) around their walk kernel. On the CPU
        every draw comes from `generator`: starts, walks, then negatives."""
        draws = self._batch_draws(tg, batch_size)
        if not self._walks_are_biased():
            return first_order_batch(
                tg, generator, batch_size, self._iterations, self._walk_length,
                self._number_of_negative_samples, self._use_scale_free_distribution, draws)
        _, neg_out, start_out = (None,) * 3 if draws is None else draws.views
        starts = sample_nodes_uniform(tg, generator, (batch_size,), draws, start_out)
        walks = random_walks(tg, starts.repeat(self._iterations), self._walk_length,
                             generator, **self._walk_kwargs())
        negs = negative_nodes_for_nce(
            tg, generator, self._number_of_negative_samples,
            self._use_scale_free_distribution,
            per_walk=batch_size * self._iterations, workspace=draws, out=neg_out,
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

    # ----------------------------------------------------- distributed steps
    def _flat_tables(self, params: Params) -> Tuple[torch.Tensor, ...]:
        """The three tables as row tables, in `SkipGramSums` order: what the
        compact route gathers from and applies to."""
        return tuple(params[name] for name in self._TABLES)

    def _compact_ids(self, uniq: torch.Tensor, params: Params) -> torch.Tensor:
        """The rows of the flat tables that the batch's distinct ids name."""
        return uniq

    def _compact_tables(self, rows, n_uniq: int):
        """The gathered rows as the tables `_add_gradients` takes."""
        return tuple(rows)

    def _loss_per_centre(self, loss: torch.Tensor, walks: torch.Tensor) -> torch.Tensor:
        return loss / (walks.shape[0] * (self._walk_length - 2 * self._window_size))

    @staticmethod
    def _compact_batch(walks: torch.Tensor, negs: torch.Tensor):
        """(the distinct ids U [U] int32, walks and negatives renumbered to
        their places in U)."""
        ids = torch.cat([walks.reshape(-1), negs.reshape(-1)])
        uniq, inverse = torch.unique(ids, return_inverse=True)
        inverse = inverse.int()
        k = walks.numel()
        return (uniq.int(), inverse[:k].view(walks.shape).contiguous(),
                inverse[k:].view(negs.shape).contiguous())

    def _distributed_step(self, mesh: Mesh, rows: bool):
        """step(tg, params, generator, lr, batch=None) -> loss per centre:
        the data-parallel step over replicated tables (rows False) or the
        row-sharded step over this rank's row shards (rows True), in place.
        Every rank draws the same global batch."""

        def step(tg, params, generator, lr, batch=None):
            walks, negs = (self._sample_batch(tg, generator, self._run_batch_size)
                           if batch is None else batch)
            center_w = self._center_weights(tg, walks, generator)
            uniq, walks_u, negs_u = self._compact_batch(walks, negs)
            flat = self._flat_tables(params)
            ids = self._compact_ids(uniq, params)
            lo = mesh.rank * flat[0].shape[0] if rows else 0
            gathered = [owned_gather(t, lo, ids) for t in flat]
            if rows:
                gathered = [all_reduce(g, mesh) for g in gathered]
            compact = self._compact_tables(gathered, uniq.shape[0])
            sums = SkipGramSums.zeros(gathered[0].shape[0], gathered[0].shape[1],
                                      gathered[0].device)
            if not rows:
                per = walks.shape[0] // mesh.size
                sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
                walks_u, negs_u = walks_u[sl], negs_u[sl]
                center_w = None if center_w is None else center_w[sl].contiguous()
            loss = self._add_gradients(compact, walks_u, negs_u, center_w, sums)
            if not rows:
                for t in sums.buffers():
                    all_reduce(t, mesh)
                loss = all_reduce(loss.clone(), mesh)
            for t, total, counts in zip(flat, (sums.sums_w, sums.sums_c, sums.sums_b),
                                        (sums.counts_w, sums.counts_c, sums.counts_c)):
                owned_scatter(t, lo, ids, total, -lr, entry_den=counts)
            return self._loss_per_centre(loss, walks)

        return step

    def _make_dp_step(self, mesh: Mesh, batch_size: int):
        """Data-parallel step: replicated tables, each rank's slice of the
        walks ([p B / P, (p + 1) B / P)), compact sums and counts
        all-reduced (the exchange grows with the batch, never with [N, D]),
        and the same update applied on every rank. Equal to the
        single-device step up to the order of float sums."""
        if (batch_size * self._iterations) % mesh.size:
            raise ValueError(f"{batch_size * self._iterations} walks do not split over "
                             f"{mesh.size} ranks.")
        return self._distributed_step(mesh, rows=False)

    def _make_row_sharded_step(self, mesh: Mesh, batch_size: int):
        """Row-sharded step: the tables' rows cut over the mesh; compact
        rows gathered by K17d and one all-reduce, the whole batch's
        gradients on every rank, and each rank's update applied to the rows
        it owns (no communication). Same batches as the single-device
        step."""
        return self._distributed_step(mesh, rows=True)

    @staticmethod
    def _table_budget(device: torch.device) -> int:
        """Bytes of tables above which "auto" shards rows: a quarter of the
        device's memory (the card's total memory, or the host's for the
        CPU), leaving room for the walks, the compact tables and their
        sums."""
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
        else:
            total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return total // 4

    def _table_bytes(self, graph: Graph) -> int:
        return sum(int(np.prod(shape)) * 4 for shape in self._param_shapes(graph).values())

    def _choose_distribution(self, mesh: Optional[Mesh], graph: Graph) -> str:
        """'data' | 'rows' | 'none' for this (mesh, graph)."""
        if mesh is None or self._distribution == "none":
            return "none"
        if not self.supports_distribution():
            warnings.warn(
                f"{type(self).__name__} does not implement the distributed "
                "training hooks; falling back to single-device training.")
            return "none"
        if self._distribution != "auto":
            return self._distribution
        return ("rows" if self._table_bytes(graph) > self._table_budget(mesh.device)
                else "data")

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

    def _checkpoint_fingerprint(self, graph: Graph) -> str:
        """The run's identity in its checkpoint: the reference's fields."""
        return "|".join(str(x) for x in (
            type(self).__name__, getattr(graph, "name", ""), graph.number_of_nodes,
            graph.number_of_directed_edges, self.embedding_size, self._epochs,
            self._batch_size, self._walk_length, self.random_state))

    @staticmethod
    def _checkpoint_state(params: Params, epoch: int, ctrl: PlateauController,
                          rng: RandomState) -> Dict[str, Any]:
        """What a checkpoint holds: the tables, the next epoch, the plateau
        controller and the draws' state."""
        return {"params": params, "epoch": np.int64(epoch), "ctrl": ctrl.state_array(),
                "rng": rng.state()}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        mesh = resolve_mesh(self._mesh)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the model trains on {self.device}, its mesh's ranks on "
                             f"{mesh.device}.")
        strategy = self._choose_distribution(mesh, graph)
        self._draws = None
        tg = self._device_graph(graph)
        generator = torch.Generator().manual_seed(self.random_state or 0)
        batch = self._resolve_batch(graph)
        if strategy != "none":
            # Walk slices divide evenly over the mesh.
            batch = -(-batch // mesh.size) * mesh.size
        self._run_batch_size = batch
        params = self._initial_tables(graph, generator)
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
        rng = RandomState([generator], lambda: [self._draws])
        ckpt, start_epoch = None, 0
        if self._checkpoint_dir is not None:
            ckpt = FitCheckpoint(self._checkpoint_dir, "embed_state",
                                 self._checkpoint_fingerprint(graph),
                                 self._checkpoint_interval, self._epochs, mesh)
            state = ckpt.restore(self._checkpoint_state(params, 0, ctrl, rng))
            if state is not None:
                params = {name: t.to(self.device) for name, t in state["params"].items()}
                start_epoch = int(state["epoch"])
                ctrl.load_state_array(state["ctrl"])
                rng.load(state["rng"])
                (row,) = state["rng"]["draws"]
                draws = self._batch_draws(tg, batch) if row[0] >= 0 else None
                if draws is not None:
                    RandomState.set_draws(draws, row)
        if strategy == "data":
            step = self._make_dp_step(mesh, batch)
        elif strategy == "rows":
            step = self._make_row_sharded_step(mesh, batch)
            params = {name: shard_rows(t, mesh) for name, t in params.items()}
        else:
            step = functools.partial(self._step, sums=self._new_sums(params))
        steps_per_epoch = max(1, graph.number_of_nodes // batch)
        self._epoch_losses, self._epoch_seconds = [], []
        last_loss = None
        with torch.no_grad():
            for epoch in range(start_epoch, self._epochs):
                t0 = time.perf_counter()
                lr = (self._learning_rate * self._learning_rate_decay ** epoch
                      * ctrl.lr_scale)
                losses = [step(tg, params, generator, lr) for _ in range(steps_per_epoch)]
                # The epoch's one host read, which also waits for the device.
                last_loss = float(torch.stack(losses).mean())
                self._epoch_seconds.append(time.perf_counter() - t0)
                self._epoch_losses.append(last_loss)
                stop = ctrl.update(last_loss)
                if ckpt is not None and ckpt.due(epoch, stop):
                    # Row shards are saved as the full tables, from rank 0.
                    full = ({name: unshard_rows(t, mesh, graph.number_of_nodes)
                             for name, t in params.items()} if strategy == "rows" else params)
                    ckpt.save(self._checkpoint_state(full, epoch + 1, ctrl, rng))
                if stop:
                    ctrl.stopped_epoch = epoch
                    break
        if ckpt is not None:
            ckpt.finish()
        self._draws = None
        self._last_loss = last_loss
        self._stopped_epoch = ctrl.stopped_epoch
        if strategy == "rows":
            params = {name: unshard_rows(t, mesh, graph.number_of_nodes)
                      for name, t in params.items()}
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
