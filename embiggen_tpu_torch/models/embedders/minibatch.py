"""Minibatch SGD skeleton of the edge, triple and entry embedders —
counterpart of `embiggen_tpu/models/embedders/minibatch.py` (`Update`,
`apply_updates`, `MinibatchEmbedder`), single device.

A model implements two hooks:

- `_sample_batch(tg, generator, batch_size) -> (sliceable, shared)` draws
  one batch (LINE's and the siamese models' draws are kernel K14 on the
  card);
- `_batch_updates(params, batch, full_batch) -> (loss_sum, updates)`
  computes the batch's sparse gradients as a list of `Update`s, normalized
  by `full_batch` where the model's loss is a batch mean.

`apply_updates` applies them IN PLACE on the tables (the JAX version returns
new ones): "mean" updates through `ops.scatter.mean_scatter` (kernel K4
standalone on the card) with a sums-and-counts workspace per table shape
that the fit keeps and frees at its end, "add" through `index_add_`,
"dense" through `sub_`. Every gradient is taken before any table changes,
so the in-place order cannot change the step. An epoch is a loop over
steps; its mean loss is read on the host once per epoch, for the lr plateau
and early stopping. The data-parallel and row-sharded steps of the JAX
version come with multi-device training (ROADMAP A13).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...graph.graph import Graph, TorchGraph
from ...ops.scatter import MeanScatterSums, mean_scatter
from ...utils.plateau import PlateauController
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from .walk_based import _device_generator

Params = Dict[str, torch.Tensor]


class Update(NamedTuple):
    """One sparse (or dense) SGD update against a named parameter table.

    idx: [M] int rows, or (mean mode) a tuple of aligned [Mi] row tensors,
         SEGMENTS of one index multiset that share its counts; either may be
         wrapped as (prefix, rows) for a stacked table indexed
         `table[prefix, rows]` (prefix an int); or None with mode "dense".
    grad: [M, ...] gradients aligned with idx (a tuple of [Mi, ...] for
         segments; the table's shape for mode "dense").
    mode: "add"   - table[rows] -= lr * grad, summed over repeats;
          "mean"  - per-row mean of the gradients at full lr (K4);
          "dense" - table -= lr * grad.
    """

    name: str
    idx: Any
    grad: Any
    mode: str = "add"


def _split_prefix(idx):
    """(prefix, rows) -> (prefix, rows); plain rows -> (None, rows). A
    stacked-table prefix is an int; segment tuples hold only tensors, so the
    two tuple shapes are unambiguous."""
    if isinstance(idx, tuple) and isinstance(idx[0], int):
        return idx[0], idx[1]
    return None, idx


Workspaces = Dict[Tuple[int, ...], MeanScatterSums]


def apply_updates(params: Params, updates: List[Update], lr: float,
                  workspaces: Optional[Workspaces] = None) -> Params:
    """Apply `updates` to the tables of `params` in place; returns
    `params`. "mean" updates take their sums and counts from `workspaces`
    (by table shape, made at first use; zero between calls) when given."""
    for u in updates:
        t = params[u.name]
        if u.mode == "dense":
            t.sub_(lr * u.grad)
            continue
        prefix, rows = _split_prefix(u.idx)
        table = t if prefix is None else t[prefix]
        if u.mode == "mean":
            ws = None
            if workspaces is not None:
                shape = tuple(table.shape)
                ws = workspaces.get(shape)
                if ws is None:
                    ws = workspaces[shape] = MeanScatterSums.zeros(shape, table.device,
                                                                   table.dtype)
            mean_scatter(table, rows, u.grad, lr, workspace=ws)
        elif u.mode == "add":
            table.index_add_(0, rows, u.grad, alpha=-lr)
        else:
            raise ValueError(f"Unknown update mode {u.mode!r}.")
    return params


def value_and_grad(
    loss_fn: Callable[..., torch.Tensor], leaves: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(loss, its gradients with respect to `leaves`) by autograd, with the
    leaves detached from the tables they were gathered from."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss = loss_fn(*leaves)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


class MinibatchEmbedder(AbstractEmbeddingModel):
    """Training template: an epoch is a loop of sample -> gradients ->
    sparse update steps on tables updated in place, with the plateau
    callbacks between epochs. The hyper-parameters are the JAX package's,
    with the same defaults; `mesh` and `checkpoint_dir` raise naming the
    ROADMAP item that brings them (`checkpoint_interval` is taken for the
    reference's signature and serves checkpointing only). `device` (default "cuda") is where
    training runs; `initial_params` (e.g. from
    `utils.convert.minibatch_params_from_jax`) replaces the random initial
    tables."""

    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 30,
        batch_size: Optional[int] = None,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.9,
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
        self._learning_rate = learning_rate
        self._learning_rate_decay = learning_rate_decay
        self._early_stopping_min_delta = early_stopping_min_delta
        self._early_stopping_patience = early_stopping_patience
        self._learning_rate_plateau_min_delta = learning_rate_plateau_min_delta
        self._learning_rate_plateau_patience = learning_rate_plateau_patience
        self._distribution = distribution
        self._initial_params = initial_params
        # The "mean" updates' workspaces, kept across steps, freed after a fit.
        self._mean_sums: Workspaces = {}
        # Other buffers a model's steps keep across a fit, by name (K13b's
        # workspace, K14's batches), freed with the workspaces.
        self._fit_buffers: Dict[str, Any] = {}
        super().__init__(
            embedding_size=embedding_size,
            enable_cache=enable_cache,
            random_state=random_state,
            device=device,
        )

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "epochs": self._epochs,
            "batch_size": self._batch_size,
            "learning_rate": self._learning_rate,
            "learning_rate_decay": self._learning_rate_decay,
            "early_stopping_min_delta": self._early_stopping_min_delta,
            "early_stopping_patience": self._early_stopping_patience,
            "learning_rate_plateau_min_delta":
                self._learning_rate_plateau_min_delta,
            "learning_rate_plateau_patience":
                self._learning_rate_plateau_patience,
            "mesh": None,
            "distribution": self._distribution,
        }

    # ------------------------------------------------------- subclass hooks
    def _pre_fit_check(self, graph: Graph) -> None:
        pass

    def _prepare_data(self, graph: Graph) -> TorchGraph:
        """What the sampler draws from (the graph on the model's device for
        edge and triple models)."""
        raise NotImplementedError

    def _param_shapes(self, n_nodes: int, n_edge_types: int) -> Dict[str, Tuple[int, ...]]:
        """{table name: shape} for a graph of `n_nodes` nodes and
        `n_edge_types` edge types."""
        raise NotImplementedError

    def _init_table(self, name: str, shape: Tuple[int, ...],
                    g: torch.Generator) -> torch.Tensor:
        """A table's random initial value: normal entries scaled by
        1 / sqrt(embedding_size)."""
        return torch.randn(shape, generator=g, device=self.device).mul_(
            1.0 / np.sqrt(self.embedding_size))

    def _init_params(self, graph: Graph, generator: torch.Generator) -> Params:
        g = _device_generator(generator, self.device)
        return {name: self._init_table(name, shape, g) for name, shape in
                self._param_shapes(graph.number_of_nodes,
                                   graph.number_of_edge_types).items()}

    def _resolve_batch_size(self, graph: Graph, ctx) -> int:
        """Auto-scaled batch: enough samples per step to fill the device,
        epochs still covering the data once."""
        if self._batch_size is not None:
            return self._batch_size
        return int(min(65536, max(1024, graph.number_of_directed_edges // 64)))

    def _steps_per_epoch(self, graph: Graph, ctx, batch: int) -> int:
        return max(1, graph.number_of_directed_edges // batch)

    def _sample_batch(self, ctx, generator: torch.Generator, batch_size: int):
        """(sliceable, shared); sliceable leaves have leading dim batch_size."""
        raise NotImplementedError

    def _batch_updates(
        self, params: Params, batch, full_batch: int
    ) -> Tuple[torch.Tensor, List[Update]]:
        """(loss_sum, updates) for `batch` = (sliceable, shared)."""
        raise NotImplementedError

    def _extract(self, params: Params, graph: Graph) -> EmbeddingResult:
        raise NotImplementedError

    @classmethod
    def supports_distribution(cls) -> bool:
        """Distributable iff the model implements the Update-protocol hooks
        (models overriding `_step` directly stay single-device)."""
        return (
            cls._batch_updates is not MinibatchEmbedder._batch_updates
            and cls._sample_batch is not MinibatchEmbedder._sample_batch
        )

    def _row_sharded_keys(self, graph: Graph, params) -> Tuple[str, ...]:
        """Tables that a row-sharded run would split by node rows: every
        table whose leading dimension is the node count."""
        n = graph.number_of_nodes
        return tuple(name for name, t in params.items() if t.shape[0] == n)

    # -------------------------------------------------------------- the step
    def _run_batch(self) -> int:
        b = getattr(self, "_run_batch_size", None)
        if b is not None:
            return b
        return self._batch_size if self._batch_size is not None else 1024

    def _step(self, ctx, params: Params, generator: torch.Generator, lr: float,
              batch=None) -> torch.Tensor:
        """One step on `params`, in place: sample a batch of the fit's size
        (or take the injected `batch`), compute its updates and apply them.
        Returns the loss per sample as a 0-d device tensor."""
        size = self._run_batch()
        if batch is None:
            batch = self._sample_batch(ctx, generator, size)
        loss, updates = self._batch_updates(params, batch, size)
        apply_updates(params, updates, lr, self._mean_sums)
        return loss / size

    # --------------------------------------------------------- training loop
    def _initial_tables(self, graph: Graph, generator: torch.Generator) -> Params:
        if self._initial_params is None:
            return self._init_params(graph, generator)
        shapes = self._param_shapes(graph.number_of_nodes, graph.number_of_edge_types)
        if set(self._initial_params) != set(shapes):
            raise ValueError(f"initial_params has tables {sorted(self._initial_params)}, "
                             f"expected {sorted(shapes)}.")
        params = {}
        for name, shape in shapes.items():
            given = self._initial_params[name]
            if tuple(given.shape) != shape:
                raise ValueError(f"initial_params[{name!r}] has shape "
                                 f"{tuple(given.shape)}, expected {shape}.")
            params[name] = given.detach().to(self.device, torch.float32).clone()
        return params

    def _fit_buffer(self, name: str, make: Callable[[], Any]) -> Any:
        """The fit's buffer `name`, made by `make()` at its first use."""
        if name not in self._fit_buffers:
            self._fit_buffers[name] = make()
        return self._fit_buffers[name]

    def _free_fit_buffers(self) -> None:
        self._mean_sums.clear()
        self._fit_buffers.clear()

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        self._pre_fit_check(graph)
        self._free_fit_buffers()
        ctx = self._prepare_data(graph)
        generator = torch.Generator().manual_seed(self.random_state or 0)
        params = self._initial_tables(graph, generator)
        batch = self._resolve_batch_size(graph, ctx)
        self._run_batch_size = batch
        steps_per_epoch = self._steps_per_epoch(graph, ctx, batch)
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
        last = None
        try:
            with torch.no_grad():
                for epoch in range(self._epochs):
                    t0 = time.perf_counter()
                    lr = (self._learning_rate * self._learning_rate_decay ** epoch
                          * ctrl.lr_scale)
                    losses = [self._step(ctx, params, generator, lr)
                              for _ in range(steps_per_epoch)]
                    # The epoch's one host read, which also waits for the device.
                    last = float(torch.stack(losses).mean())
                    self._epoch_seconds.append(time.perf_counter() - t0)
                    self._epoch_losses.append(last)
                    if ctrl.update(last):
                        ctrl.stopped_epoch = epoch
                        break
        finally:
            self._free_fit_buffers()
        self._last_loss = last
        self._stopped_epoch = ctrl.stopped_epoch
        return self._extract(params, graph)
