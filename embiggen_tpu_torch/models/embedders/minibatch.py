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
and early stopping.

With `mesh` a fit trains over torch.distributed, one process per rank,
every rank drawing the same global batch. Data-parallel: each rank takes
the updates of its slice of the batch and `gather_updates` all-gathers the
sparse payloads in rank order (all-reduces the dense ones), so every rank
applies the global update. Row-sharded: the node-row tables are cut over
the mesh, the hooks gather from `_RowShardView`s (K17d and one
all-reduce), and each rank applies the updates of the rows it owns (K17c).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...graph.graph import Graph, TorchGraph
from ...ops.scatter import MeanScatterSums, mean_scatter
from ...parallel.mesh import Mesh, all_gather, all_reduce, resolve_mesh
from ...parallel.sharded_table import (
    _mean_scatter_owned, _RowShardView, _scatter_add_owned, shard_rows, unshard_rows,
)
from ...ops.negatives import BatchDraws
from ...utils.checkpoint import FitCheckpoint, RandomState
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


def gather_updates(updates: List[Update], mesh: Mesh) -> List[Update]:
    """The global update from each rank's updates of its slice: sparse
    payloads all-gathered in rank order (per segment, each staying aligned
    with its gradients), dense gradients all-reduced."""
    out = []
    for u in updates:
        if u.mode == "dense":
            out.append(u._replace(grad=all_reduce(u.grad.clone(), mesh)))
            continue
        prefix, rows = _split_prefix(u.idx)
        if isinstance(rows, tuple):
            rows_g = tuple(all_gather(a, mesh) for a in rows)
            grad_g = tuple(all_gather(g, mesh) for g in u.grad)
        else:
            rows_g, grad_g = all_gather(rows, mesh), all_gather(u.grad, mesh)
        out.append(u._replace(idx=rows_g if prefix is None else (prefix, rows_g),
                              grad=grad_g))
    return out


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
    with the same defaults; with `checkpoint_dir` the fit saves its state
    every `checkpoint_interval` epochs to `<checkpoint_dir>/embed_state.npz`
    and a later fit of the same run resumes from it. `mesh` (None, "auto", an int
    or a `parallel.Mesh`) trains over torch.distributed; `distribution`
    picks "data", "rows" (the node-row tables sharded), "none", or "auto":
    rows when those tables take more than a quarter of the device's memory
    (`WalkBasedEmbedder._table_budget`), else data. `device` (default
    "cuda") is where training runs; `initial_params` (e.g. from
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
        self._mesh = mesh
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = max(1, checkpoint_interval)
        self._initial_params = initial_params
        # The "mean" updates' workspaces, kept across steps, freed after a fit.
        self._mean_sums: Workspaces = {}
        # Other buffers a model's steps keep across a fit, by name (K13b's
        # workspace, K14's batches), freed with the workspaces.
        self._fit_buffers: Dict[str, Any] = {}
        # The saved key and offset of each `BatchDraws` fit buffer, by name,
        # given to the buffer when a resumed fit makes it.
        self._resumed_draws: Dict[str, np.ndarray] = {}
        super().__init__(
            embedding_size=embedding_size,
            enable_cache=enable_cache,
            random_state=random_state,
            device=device,
        )

    def __getstate__(self) -> Dict[str, Any]:
        # The fit's workspaces and draws: a pickle leaves them out.
        return {**self.__dict__, "_mean_sums": {}, "_fit_buffers": {}, "_resumed_draws": {}}

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
            "mesh": self._mesh.size if isinstance(self._mesh, Mesh) else self._mesh,
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

    # ----------------------------------------------------- distributed steps
    def _slice_batch(self, sliceable, i: int, per: int):
        """Rank i's slice [i per, (i + 1) per) of every sliceable leaf's
        batch axis (the leading one)."""
        return tuple(a[i * per:(i + 1) * per] for a in sliceable)

    def _make_dp_step(self, mesh: Mesh, batch_size: int):
        """Data-parallel step: every rank draws the same global batch,
        computes the updates of its slice (normalized by the global batch)
        and applies the all-gathered global update. Equal to the
        single-device step up to the order of float sums."""
        if batch_size % mesh.size:
            raise ValueError(f"a batch of {batch_size} does not split over {mesh.size} ranks.")
        per = batch_size // mesh.size

        def step(ctx, params, generator, lr, batch=None):
            sl, sh = self._sample_batch(ctx, generator, batch_size) if batch is None else batch
            loss, updates = self._batch_updates(
                params, (self._slice_batch(sl, mesh.rank, per), sh), batch_size)
            apply_updates(params, gather_updates(updates, mesh), lr, self._mean_sums)
            return all_reduce(loss.clone(), mesh) / batch_size

        return step

    def _make_row_sharded_step(self, mesh: Mesh, batch_size: int, row_keys):
        """Row-sharded step: every rank draws the same whole batch, gathers
        the rows it needs from the sharded tables (`_RowShardView`: K17d and
        one all-reduce a gather) and applies the updates of the rows it
        owns (K17c, no communication); the other tables update as on one
        device."""
        row_keys = frozenset(row_keys)

        def step(ctx, params, generator, lr, batch=None):
            views = {n: _RowShardView(t, mesh) if n in row_keys else t
                     for n, t in params.items()}
            batch = self._sample_batch(ctx, generator, batch_size) if batch is None else batch
            loss, updates = self._batch_updates(views, batch, batch_size)
            for u in updates:
                if u.name not in row_keys:
                    apply_updates(params, [u], lr, self._mean_sums)
                    continue
                prefix, rows = _split_prefix(u.idx)
                if prefix is not None or u.mode not in ("add", "mean"):
                    raise ValueError(f"a row-sharded table takes 'add' and 'mean' updates "
                                     f"of plain rows; got {u.mode!r} on {u.name!r}.")
                if u.mode == "mean":
                    _mean_scatter_owned(params[u.name], rows, u.grad, lr, mesh)
                else:
                    _scatter_add_owned(params[u.name], rows, -lr * u.grad, mesh)
            # The gathered rows are the same on every rank: so is the loss.
            return loss / batch_size

        return step

    def _choose_distribution(self, mesh: Optional[Mesh], graph: Graph, params) -> str:
        """'data' | 'rows' | 'none' for this (mesh, graph)."""
        from .walk_based import WalkBasedEmbedder

        if mesh is None or self._distribution == "none":
            return "none"
        if not self.supports_distribution():
            warnings.warn(
                f"{type(self).__name__} does not implement the distributed "
                "training hooks; falling back to single-device training.")
            return "none"
        keys = self._row_sharded_keys(graph, params)
        row_bytes = sum(t.numel() * 4 for n, t in params.items() if n in keys)
        if self._distribution == "rows" or (
                self._distribution == "auto"
                and row_bytes > WalkBasedEmbedder._table_budget(mesh.device)):
            if not keys:
                warnings.warn(f"{type(self).__name__} has no node-row tables to "
                              "shard; using data parallelism.")
                return "data"
            return "rows"
        return "data"

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
            buffer = self._fit_buffers[name] = make()
            if name in self._resumed_draws and isinstance(buffer, BatchDraws):
                RandomState.set_draws(buffer, self._resumed_draws.pop(name))
        return self._fit_buffers[name]

    def _free_fit_buffers(self) -> None:
        self._mean_sums.clear()
        self._fit_buffers.clear()
        self._resumed_draws.clear()

    def _fit_draws(self) -> List[Tuple[str, BatchDraws]]:
        """The fit's `BatchDraws` buffers, by name, in name order."""
        return sorted((name, b) for name, b in self._fit_buffers.items()
                      if isinstance(b, BatchDraws))

    def _checkpoint_fingerprint(self, graph: Graph) -> str:
        """The run's identity in its checkpoint: the reference's fields."""
        return "|".join(str(x) for x in (
            type(self).__name__, getattr(graph, "name", ""), graph.number_of_nodes,
            graph.number_of_directed_edges, self.embedding_size, self._epochs,
            self._batch_size, self.random_state))

    def _checkpoint_state(self, params: Params, epoch: int, ctrl: PlateauController,
                          rng: RandomState) -> Dict[str, Any]:
        """What a checkpoint holds: the tables, the next epoch, the plateau
        controller, the draws' state and the names of the fit's draws
        (one string, "|"-joined)."""
        return {"params": params, "epoch": np.int64(epoch), "ctrl": ctrl.state_array(),
                "rng": rng.state(),
                "draw_names": np.asarray("|".join(n for n, _ in self._fit_draws()))}

    def _restore(self, ckpt: FitCheckpoint, params: Params, row_rows,
                 mesh: Optional[Mesh], ctrl: PlateauController, rng: RandomState) -> int:
        """Load a matching checkpoint into `params` (in place; the row-sharded
        tables from their full saved tables), `ctrl` and `rng`; the saved
        draws go to their buffers when the fit makes them. Returns the epoch
        to start from."""
        state = ckpt.restore(self._checkpoint_state(params, 0, ctrl, rng))
        if state is None:
            return 0
        for n, t in state["params"].items():
            params[n].copy_(shard_rows(t, mesh) if n in row_rows else t)
        ctrl.load_state_array(state["ctrl"])
        rng.load(state["rng"])
        names = [n for n in str(state["draw_names"]).split("|") if n]
        self._resumed_draws = dict(zip(names, state["rng"]["draws"]))
        return int(state["epoch"])

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        self._pre_fit_check(graph)
        self._free_fit_buffers()
        mesh = resolve_mesh(self._mesh)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the model trains on {self.device}, its mesh's ranks on "
                             f"{mesh.device}.")
        ctx = self._prepare_data(graph)
        generator = torch.Generator().manual_seed(self.random_state or 0)
        params = self._initial_tables(graph, generator)
        strategy = self._choose_distribution(mesh, graph, params)
        batch = self._resolve_batch_size(graph, ctx)
        if strategy != "none":
            # Batch slices divide evenly over the mesh.
            batch = -(-batch // mesh.size) * mesh.size
        self._run_batch_size = batch
        steps_per_epoch = self._steps_per_epoch(graph, ctx, batch)
        row_rows = {}
        if strategy == "data":
            step = self._make_dp_step(mesh, batch)
        elif strategy == "rows":
            row_keys = self._row_sharded_keys(graph, params)
            step = self._make_row_sharded_step(mesh, batch, row_keys)
            row_rows = {n: params[n].shape[0] for n in row_keys}
            params.update({n: shard_rows(params[n], mesh) for n in row_keys})
        else:
            step = self._step
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
        rng = RandomState([generator], lambda: [b for _, b in self._fit_draws()])
        ckpt, start_epoch = None, 0
        if self._checkpoint_dir is not None:
            ckpt = FitCheckpoint(self._checkpoint_dir, "embed_state",
                                 self._checkpoint_fingerprint(graph),
                                 self._checkpoint_interval, self._epochs, mesh)
            start_epoch = self._restore(ckpt, params, row_rows, mesh, ctrl, rng)
        self._epoch_losses, self._epoch_seconds = [], []
        last = None
        try:
            with torch.no_grad():
                for epoch in range(start_epoch, self._epochs):
                    t0 = time.perf_counter()
                    lr = (self._learning_rate * self._learning_rate_decay ** epoch
                          * ctrl.lr_scale)
                    losses = [step(ctx, params, generator, lr)
                              for _ in range(steps_per_epoch)]
                    # The epoch's one host read, which also waits for the device.
                    last = float(torch.stack(losses).mean())
                    self._epoch_seconds.append(time.perf_counter() - t0)
                    self._epoch_losses.append(last)
                    stop = ctrl.update(last)
                    if ckpt is not None and ckpt.due(epoch, stop):
                        # Row shards are saved as the full tables, from rank 0.
                        full = {**params, **{n: unshard_rows(params[n], mesh, rows)
                                             for n, rows in row_rows.items()}}
                        ckpt.save(self._checkpoint_state(full, epoch + 1, ctrl, rng))
                    if stop:
                        ctrl.stopped_epoch = epoch
                        break
            if ckpt is not None:
                ckpt.finish()
        finally:
            self._free_fit_buffers()
        self._last_loss = last
        self._stopped_epoch = ctrl.stopped_epoch
        params.update({n: unshard_rows(params[n], mesh, rows) for n, rows in row_rows.items()})
        return self._extract(params, graph)
