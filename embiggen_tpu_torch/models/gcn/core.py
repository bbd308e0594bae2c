"""GCN core: encoder and training loop — counterpart of
`embiggen_tpu/models/gcn/core.py`.

Parameters are the reference's tree of plain tensors ({"w": [in, out],
"b": [out]} per dense layer, `x @ w + b`), so a JAX parameter tree maps
onto them one to one (`utils.convert.gcn_params_from_jax`). The
convolution is the CSR SpMM with its transposed backward (`ops.spmm`,
kernel K7). Kernel choice per preset follows the reference: Kipf GCN =
Symmetric Normalized Laplacian, GraphSAGE = Left Normalized Laplacian, GNN
= no kernels. Over a mesh (`enable_halo`) each convolution is the
halo-exchange SpMM of `parallel.halo`.
"""
from __future__ import annotations

import os
import time
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...graph.graph import Graph
from ...graph.laplacians import kernel_coo, validate_convolution_graph
from ...ops.spmm import CSRKernel, csr_kernel, spmm
from ...parallel.halo import build_halo_partition, halo_conv
from ...parallel.mesh import Mesh, resolve_mesh
from ...utils.checkpoint import FitCheckpoint, RandomState
from ..registry import register_model

Params = Dict[str, Any]

def graph_fingerprint(graph: Graph, *extras) -> str:
    """Identity string of a fit's graph for its checkpoint: the graph's
    name and size and a CRC of its CSR and of any extra arrays (training
    masks, labels), enough to tell holdouts of one graph apart."""
    crc = zlib.crc32(np.ascontiguousarray(graph.row_ptr).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(graph.col_idx).tobytes(), crc)
    for extra in extras:
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(extra)).tobytes(), crc)
    return (f"{getattr(graph, 'name', '')}|{graph.number_of_nodes}|"
            f"{graph.number_of_directed_edges}|{crc:08x}")


# Kernels laid out on a device, keyed on the graph's content fingerprint,
# the kernel name and the device: the models evaluated on one holdout share
# them. Small, since entries hold device memory (a 20M-arc kernel with its
# transpose is about 0.5 GB).
_KERNEL_CACHE: "OrderedDict[tuple, CSRKernel]" = OrderedDict()
_KERNEL_CACHE_SIZE = 4


def _cached_kernel(graph: Graph, name: str, device: torch.device, halo_mesh=None):
    """The kernel's CSRKernel on `device`, or with `halo_mesh` the
    HaloPartition of this rank's shard, from the LRU above (keyed on the
    halo configuration too)."""
    key = (graph.arcs_fingerprint, name, str(device),
           None if halo_mesh is None else (halo_mesh.size, halo_mesh.rank))
    hit = _KERNEL_CACHE.get(key)
    if hit is not None:
        _KERNEL_CACHE.move_to_end(key)
        return hit
    rows, cols, vals = kernel_coo(graph, name)
    if halo_mesh is not None:
        built = build_halo_partition(rows, cols, vals, graph.number_of_nodes, halo_mesh.size,
                                     device=device, shards=[halo_mesh.rank])
    else:
        built = csr_kernel(rows, cols, vals, graph.number_of_nodes, device=device,
                           with_transpose=True)
    _KERNEL_CACHE[key] = built
    while len(_KERNEL_CACHE) > _KERNEL_CACHE_SIZE:
        _KERNEL_CACHE.popitem(last=False)
    return built


def glorot(shape: Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def init_mlp(dims: Sequence[int], generator: torch.Generator) -> List[Dict[str, torch.Tensor]]:
    """Dense layers dims[0] → … → dims[-1] on the CPU, from `generator`."""
    return [
        {"w": glorot((dims[i], dims[i + 1]), generator),
         "b": torch.zeros(dims[i + 1])}
        for i in range(len(dims) - 1)
    ]


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def apply_mlp(layers, x, activation=torch.relu, final_activation=None,
              dropout_rate: float = 0.0, generator=None, training: bool = False):
    n = len(layers)
    for i, layer in enumerate(layers):
        if training and dropout_rate > 0 and generator is not None:
            x = _dropout(x, dropout_rate, generator)
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    return [t for item in tree for t in param_leaves(item)]


def map_params(fn: Callable, tree):
    """The parameter tree with `fn` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return [map_params(fn, v) for v in tree]


class GCNEncoder:
    """Stack of graph convolutions over one or more propagation kernels.

    Per kernel k and layer l: H = relu(A_k (dropout(H)) W_l + b_l); the
    kernels' outputs are concatenated, and with `residual` the input
    features are concatenated to the result."""

    def __init__(
        self,
        kernel_names: Optional[Sequence[str]],
        units: Sequence[int],
        combiner: str = "sum",
        dropout_rate: float = 0.5,
        residual: bool = False,
        handling_multi_graph: str = "warn",
    ):
        self.kernel_names = list(kernel_names) if kernel_names else []
        self.units = list(units)
        self.combiner = combiner
        self.dropout_rate = dropout_rate
        self.residual = residual
        self.handling_multi_graph = handling_multi_graph
        self._halo_mesh: Optional[Mesh] = None

    @property
    def has_convolutions(self) -> bool:
        return bool(self.kernel_names) and bool(self.units)

    def enable_mesh(self, mesh, device: torch.device) -> None:
        """Resolve a model's `mesh` (None, "auto", an int or a `Mesh`) on the
        "nodes" axis and, when it has more than one rank, `enable_halo` on
        it. The mesh's ranks must run on the model's device type."""
        mesh = resolve_mesh(mesh, axis="nodes")
        if mesh is None:
            return
        if mesh.device.type != torch.device(device).type:
            raise ValueError(f"the model trains on {device}, its mesh's ranks on "
                             f"{mesh.device}.")
        self.enable_halo(mesh)

    def enable_halo(self, mesh: Mesh) -> None:
        """Convolve over `mesh` with the halo-exchange SpMM
        (`parallel.halo.halo_conv`): each rank computes its shard's rows and
        exchanges only boundary rows; the activations stay replicated, so
        the rest of the model, its dropout draws and its gradients are those
        of one device, up to the order of float sums. `build_kernels` then
        builds this rank's HaloPartition instead of a CSRKernel."""
        self._halo_mesh = mesh

    def build_kernels(self, graph: Graph, device: torch.device) -> List[CSRKernel]:
        """One CSRKernel (with its transpose) per kernel name, or in halo
        mode one HaloPartition, from the kernel cache."""
        if self.kernel_names:
            validate_convolution_graph(graph, self.handling_multi_graph)
        return [_cached_kernel(graph, name, torch.device(device), self._halo_mesh)
                for name in self.kernel_names]

    def _conv(self, k, h: torch.Tensor) -> torch.Tensor:
        """A @ h: K7 on one device, the halo-exchange SpMM over the mesh."""
        if self._halo_mesh is None:
            return spmm(k, h, self.combiner)
        return halo_conv(self._halo_mesh, k, h, self.combiner)

    def init(self, generator: torch.Generator, in_dim: int) -> Params:
        return {"kernels": [init_mlp([in_dim] + self.units, generator)
                            for _ in self.kernel_names]}

    def output_dim(self, in_dim: int) -> int:
        if not self.has_convolutions:
            return in_dim
        d = self.units[-1] * len(self.kernel_names)
        return d + in_dim if self.residual else d

    def apply(self, params: Params, kernels: Sequence[CSRKernel],
              x: torch.Tensor, n_nodes: int, training: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.has_convolutions:
            return x
        outs = []
        for layers, k in zip(params["kernels"], kernels):
            h = x
            for layer in layers:
                if training and self.dropout_rate > 0 and generator is not None:
                    h = _dropout(h, self.dropout_rate, generator)
                h = self._conv(k, h)
                h = torch.relu(h @ layer["w"] + layer["b"])
            outs.append(h)
        h = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        if self.residual:
            h = torch.cat([h, x], dim=1)
        return h


def kernel_preset(base, name: str, kernel_list: Sequence[str], doc: str):
    """A registered Kipf GCN / GraphSAGE / GNN preset subclass of the GCN
    class `base`, named `doc`, with the kernels `kernel_list` fixed; with no
    kernels (GNN) no convolution layers, a learned node embedding by
    default, and the base's smoke-test parameters but its units."""

    def __init__(self, **kwargs):
        kwargs.pop("kernels", None)
        if not kernel_list:
            kwargs.setdefault("use_node_embedding", True)
            base.__init__(self, kernels=[], units=(), **kwargs)
        else:
            base.__init__(self, kernels=list(kernel_list), **kwargs)

    def parameters(self):
        p = base.parameters(self)
        p.pop("kernels", None)
        if not kernel_list:
            p.pop("units", None)
        return p

    cls = type(name, (base,), {
        "__init__": __init__,
        "parameters": parameters,
        "model_name": classmethod(lambda cls: doc),
        "DEFAULT_KERNELS": list(kernel_list),
        # The module that assigns the preset to `name`, so pickle finds it.
        "__module__": base.__module__,
        "__qualname__": name,
        "__doc__": f"{doc} preset of {base.__name__}.",
    })
    if not kernel_list:
        cls.smoke_test_parameters = classmethod(lambda cls: {
            k: v for k, v in base.smoke_test_parameters().items() if k != "units"})
    return register_model(cls)


class StaticFeatureSpec:
    """The fixed node features plus, when used, a learned node embedding
    and a learned node-type embedding, gathered by each node's primary type
    (`type_ids`: the type + 1, 0 for an unknown type)."""

    def __init__(self, static: torch.Tensor, use_node_embedding: bool,
                 type_ids: Optional[torch.Tensor] = None):
        self.static = static
        self.use_node_embedding = use_node_embedding
        self.type_ids = type_ids

    def dim(self, embed_params: Params) -> int:
        d = self.static.shape[1]
        if self.use_node_embedding:
            d += embed_params["node_embedding"].shape[1]
        if self.type_ids is not None:
            d += embed_params["node_type_embedding"].shape[1]
        return d

    def materialize(self, embed_params: Params) -> torch.Tensor:
        parts = [self.static]
        if self.use_node_embedding:
            parts.append(embed_params["node_embedding"])
        if self.type_ids is not None:
            parts.append(embed_params["node_type_embedding"][self.type_ids])
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def materialize_node_type_features(
    graph: Graph, node_type_features: List[np.ndarray]
) -> List[np.ndarray]:
    """Per-node rows of [n_node_types, d] matrices: the mean over each
    node's types, zeros for a node of unknown type."""
    onehot = graph.get_one_hot_encoded_node_types()
    counts = np.maximum(onehot.sum(axis=1, keepdims=True), 1.0)
    return [(onehot @ np.asarray(f, np.float32)) / counts for f in node_type_features]


def assemble_node_features(
    graph: Graph,
    node_features: Optional[List[np.ndarray]],
    use_node_embedding: bool,
    node_embedding_size: int,
    use_node_type_embedding: bool,
    node_type_embedding_size: int,
    generator: torch.Generator,
    device: torch.device,
    node_type_features: Optional[List[np.ndarray]] = None,
) -> Tuple[Params, StaticFeatureSpec]:
    """The static feature matrix on `device` (the node features, then the
    node-type features as per-node rows), and the learned node embedding
    and node-type embedding tables ([n_node_types + 1, d], row 0 for an
    unknown type; on the CPU, from `generator`) when used."""
    mats = [np.asarray(f, np.float32) for f in (node_features or [])]
    if node_type_features:
        mats.extend(materialize_node_type_features(graph, node_type_features))
    static = (np.concatenate(mats, axis=1) if mats
              else np.zeros((graph.number_of_nodes, 0), np.float32))
    params: Params = {}
    if use_node_embedding:
        params["node_embedding"] = torch.randn(
            (graph.number_of_nodes, node_embedding_size), generator=generator
        ) / np.sqrt(node_embedding_size)
    type_ids = None
    if use_node_type_embedding:
        if not graph.has_node_types:
            raise ValueError("use_node_type_embedding requires a graph with node types.")
        params["node_type_embedding"] = torch.randn(
            (graph.number_of_node_types + 1, node_type_embedding_size), generator=generator
        ) / np.sqrt(node_type_embedding_size)
        type_ids = torch.from_numpy(
            graph.get_single_label_node_type_ids().astype(np.int64) + 1).to(device)
    spec = StaticFeatureSpec(torch.from_numpy(static).to(device), use_node_embedding, type_ids)
    return params, spec


class TrainLoop:
    """Epoch loop with the reference's callbacks: EarlyStopping,
    ReduceLROnPlateau and TerminateOnNaN on the training loss. The optimizer
    is Adam. As in the reference, the plateau factor scales the gradients
    before Adam, not the learning rate (Adam's normalization cancels most
    of it).

    With `checkpoint_dir`, the loop's whole state (parameters, Adam's
    moments and step counts, the epoch, the best loss and parameters, the
    patience counters, the plateau scale, the loss history and the caller's
    random state) is saved every `checkpoint_interval` epochs to
    `<checkpoint_dir>/train_state.npz` and restored by the next run of the
    same fit, which then resumes where the saved one stopped; the file is
    deleted when the run completes. Over a `mesh` (every rank training the
    same model), rank 0 writes it."""

    def __init__(
        self,
        epochs: int = 1000,
        learning_rate: float = 0.001,
        early_stopping_patience: int = 10,
        early_stopping_min_delta: float = 1e-4,
        reduce_lr_patience: int = 5,
        reduce_lr_factor: float = 0.5,
        steps_per_epoch: int = 1,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 10,
        mesh: Optional[Mesh] = None,
    ):
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_min_delta = early_stopping_min_delta
        self.reduce_lr_patience = reduce_lr_patience
        self.reduce_lr_factor = reduce_lr_factor
        self.steps_per_epoch = steps_per_epoch
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = max(1, checkpoint_interval)
        self.mesh = mesh

    def _ckpt_path(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, "train_state")

    def _fingerprint(self, params: Params, fingerprint: str) -> str:
        """The reference's fields: the caller's string, the parameter tree
        (its structure and its sorted leaf shapes) and the loop's size."""
        shapes = sorted(tuple(t.shape) for t in param_leaves(params))
        return "|".join(str(x) for x in (
            fingerprint, map_params(lambda t: "*", params), shapes, self.epochs,
            self.steps_per_epoch, self.learning_rate))

    @staticmethod
    def _adam_state(optimizer: torch.optim.Adam, leaves) -> List[Dict[str, Any]]:
        """Adam's state of each leaf: its step count and two moments (zeros
        and `has` 0 for a leaf that has taken no step)."""
        out = []
        for p in leaves:
            st = optimizer.state.get(p, {})
            out.append({
                "has": np.int64(bool(st)),
                "step": (st["step"] if st else torch.zeros((), dtype=torch.float32)),
                "exp_avg": st["exp_avg"] if st else torch.zeros_like(p),
                "exp_avg_sq": st["exp_avg_sq"] if st else torch.zeros_like(p),
            })
        return out

    @staticmethod
    def _load_adam_state(optimizer: torch.optim.Adam, leaves, saved) -> None:
        for p, st in zip(leaves, saved):
            if int(st["has"]):
                optimizer.state[p] = {
                    "step": torch.as_tensor(st["step"], dtype=torch.float32).cpu(),
                    "exp_avg": st["exp_avg"].to(p.device), "exp_avg_sq": st["exp_avg_sq"].to(p.device)}

    def run(self, params: Params, loss_step: Callable[[Params], torch.Tensor],
            fingerprint: str = "", rng=None):
        """Train `params` (a tree of leaf tensors, updated in place) for up
        to `epochs` epochs of `steps_per_epoch` Adam steps on
        `loss_step(params)`, a 0-d loss tensor. The epoch loss is the mean
        of its steps, read on the host once per epoch. `fingerprint` (the
        graph's and split's identity, `graph_fingerprint`) and `rng` (a
        `utils.checkpoint.RandomState` of the generators and draws the loss
        steps take) serve the checkpoints. Returns (a copy of the parameters
        of the best epoch, loss history)."""
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        optimizer = torch.optim.Adam(leaves, lr=self.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        best = np.inf
        best_params = map_params(lambda t: t.detach().clone(), params)
        patience = lr_patience = 0
        lr_scale = 1.0
        history: List[float] = []
        self.epoch_seconds = []
        rng = rng if rng is not None else RandomState()
        ckpt, start_epoch = None, 0

        def pack(epoch):
            return {
                "params": params, "adam": self._adam_state(optimizer, leaves),
                "epoch": np.int64(epoch), "best": np.float64(best), "best_params": best_params,
                "patience": np.int64(patience), "lr_patience": np.int64(lr_patience),
                "lr_scale": np.float64(lr_scale), "history": np.asarray(history, np.float64),
                "rng": rng.state(),
            }

        if self.checkpoint_dir is not None:
            ckpt = FitCheckpoint(self.checkpoint_dir, "train_state",
                                 self._fingerprint(params, fingerprint),
                                 self.checkpoint_interval, self.epochs, self.mesh)
            state = ckpt.restore(pack(0))
            if state is not None:
                with torch.no_grad():
                    for p, t in zip(leaves, param_leaves(state["params"])):
                        p.copy_(t)
                self._load_adam_state(optimizer, leaves, state["adam"])
                start_epoch = int(state["epoch"])
                best = float(state["best"])
                best_params = state["best_params"]
                patience = int(state["patience"])
                lr_patience = int(state["lr_patience"])
                lr_scale = float(state["lr_scale"])
                history = [float(x) for x in np.asarray(state["history"])]
                rng.load(state["rng"])
        for epoch in range(start_epoch, self.epochs):
            t0 = time.perf_counter()
            total = torch.zeros((), device=leaves[0].device)
            for _ in range(self.steps_per_epoch):
                optimizer.zero_grad(set_to_none=True)
                loss = loss_step(params)
                loss.backward()
                if lr_scale != 1.0:
                    for p in leaves:
                        if p.grad is not None:
                            p.grad.mul_(lr_scale)
                optimizer.step()
                total += loss.detach()
            loss = float(total / self.steps_per_epoch)
            self.epoch_seconds.append(time.perf_counter() - t0)
            history.append(loss)
            if not np.isfinite(loss):  # TerminateOnNaN
                break
            if loss < best - self.early_stopping_min_delta:
                best = loss
                best_params = map_params(lambda t: t.detach().clone(), params)
                patience = lr_patience = 0
            else:
                patience += 1
                lr_patience += 1
                if lr_patience >= self.reduce_lr_patience:
                    lr_scale *= self.reduce_lr_factor
                    lr_patience = 0
                if patience >= self.early_stopping_patience:
                    break
            if ckpt is not None and ckpt.due(epoch):
                ckpt.save(pack(epoch + 1))
        if ckpt is not None:
            ckpt.finish()
        for p in leaves:
            p.requires_grad_(False)
        return best_params, history
