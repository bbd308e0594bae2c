"""Node-label prediction GCNs — counterpart of
`embiggen_tpu/models/gcn/node_label.py` (`GCNNodeLabelPrediction` and its
Kipf GCN / GraphSAGE / GNN presets).

Training is full-graph, as in the reference: every epoch is one Adam step
on the loss over the labelled nodes, through the convolution stack (kernel
K7 forward, and its transposed backward) and the head. The loss is the
class-weighted softmax cross-entropy of each node's primary type, or for a
multilabel graph the logistic loss summed over the types; it is averaged
over the labelled nodes. With no node features the model learns a node
embedding instead. Inference convolves over the support graph's kernels
and returns the softmax (the sigmoid, multilabel) of every node's logits.

With `mesh` (None, "auto", an int or a `parallel.Mesh`) every rank trains
the same model and each convolution is the halo-exchange SpMM
(`GCNEncoder.enable_mesh`, kernel K17a); the result equals a single-device
fit up to the order of float sums. With `checkpoint_dir`, `TrainLoop` saves
the fit's state every `checkpoint_interval` epochs, the dropout generator's
with it, and a later fit of the same run resumes from it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.graph import Graph
from ...parallel.mesh import Mesh
from ...utils.checkpoint import RandomState
from ..embedders.walk_based import _device_generator
from ..node_label_prediction.model import AbstractNodeLabelPredictionModel
from ..registry import register_model
from .core import (
    GCNEncoder, TrainLoop, apply_mlp, assemble_node_features, graph_fingerprint, init_mlp,
    kernel_preset, map_params,
)


class GCNNodeLabelPrediction(AbstractNodeLabelPredictionModel):
    """Configurable node-label GCN ("Everything Bagel GCN")."""

    DEFAULT_KERNELS = ["Symmetric Normalized Laplacian"]

    def __init__(
        self,
        kernels: Optional[Sequence[str]] = None,
        units: Sequence[int] = (128, 128),
        head_units: Sequence[int] = (128,),
        combiner: str = "sum",
        dropout_rate: float = 0.5,
        residual: bool = False,
        use_class_weights: bool = True,
        use_node_embedding: bool = False,
        node_embedding_size: int = 50,
        use_node_type_embedding: bool = False,
        node_type_embedding_size: int = 50,
        epochs: int = 200,
        learning_rate: float = 0.01,
        early_stopping_patience: int = 20,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 10,
        handling_multi_graph: str = "warn",
        random_state: int = 42,
        device: Union[str, torch.device] = "cuda",
    ):
        self._mesh = mesh
        self._handling_multi_graph = handling_multi_graph
        self._kernels = (
            list(kernels) if kernels is not None else list(self.DEFAULT_KERNELS)
        )
        self._units = list(units)
        self._head_units = list(head_units)
        self._combiner = combiner
        self._dropout_rate = dropout_rate
        self._residual = residual
        self._use_class_weights = use_class_weights
        self._use_node_embedding = use_node_embedding
        self._node_embedding_size = node_embedding_size
        self._use_node_type_embedding = use_node_type_embedding
        self._node_type_embedding_size = node_type_embedding_size
        self._epochs = epochs
        self._learning_rate = learning_rate
        self._early_stopping_patience = early_stopping_patience
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = checkpoint_interval
        super().__init__(random_state=random_state, device=device)

    @classmethod
    def model_name(cls) -> str:
        return "Everything Bagel GCN"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "mesh": self._mesh.size if isinstance(self._mesh, Mesh) else self._mesh,
            "kernels": self._kernels,
            "units": self._units,
            "head_units": self._head_units,
            "combiner": self._combiner,
            "dropout_rate": self._dropout_rate,
            "residual": self._residual,
            "use_class_weights": self._use_class_weights,
            "use_node_embedding": self._use_node_embedding,
            "node_embedding_size": self._node_embedding_size,
            "use_node_type_embedding": self._use_node_type_embedding,
            "node_type_embedding_size": self._node_type_embedding_size,
            "epochs": self._epochs,
            "learning_rate": self._learning_rate,
            "early_stopping_patience": self._early_stopping_patience,
            "checkpoint_dir": self._checkpoint_dir,
            "checkpoint_interval": self._checkpoint_interval,
            "handling_multi_graph": self._handling_multi_graph,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"units": [8], "head_units": [8], "epochs": 5}

    def is_multilabel_prediction_task(self) -> bool:
        return self._multilabel

    def is_binary_prediction_task(self) -> bool:
        return self._n_classes == 2 and not self._multilabel

    # --------------------------------------------------------------- assembly
    def _build(self, graph: Graph, support: Graph, node_features,
               generator: torch.Generator):
        """The encoder and its kernels on the device, the node features,
        and the initial parameter tree {"embed", "enc", "head"} (drawn on
        the CPU from `generator`, then moved to the device)."""
        self._multilabel = graph.has_multilabel_node_types()
        self._n_classes = graph.number_of_node_types
        self._encoder = GCNEncoder(
            self._kernels if self._units else None, self._units,
            combiner=self._combiner, dropout_rate=self._dropout_rate,
            residual=self._residual, handling_multi_graph=self._handling_multi_graph,
        )
        self._encoder.enable_mesh(self._mesh, self.device)
        kernels = self._encoder.build_kernels(support, self.device)
        self._csr_kernels = kernels
        # A GCN with no features at all learns a node embedding instead.
        if not (node_features or self._use_node_embedding or self._use_node_type_embedding):
            self._use_node_embedding = True
        embed_params, spec = assemble_node_features(
            graph, node_features, self._use_node_embedding, self._node_embedding_size,
            self._use_node_type_embedding, self._node_type_embedding_size, generator,
            self.device,
        )
        self._spec = spec
        in_dim = spec.dim(embed_params)
        params = {
            "embed": embed_params,
            "enc": self._encoder.init(generator, in_dim),
            "head": init_mlp([self._encoder.output_dim(in_dim)] + self._head_units
                             + [self._n_classes], generator),
        }
        return map_params(lambda t: t.to(self.device), params), kernels

    def _targets(self, graph: Graph):
        """(targets, labelled-node mask, class weights) on the device: the
        one-hot types of a multilabel graph, else each node's primary type
        (0 where unknown, masked out); the weights n / (C count_c) of the
        labelled nodes' classes (ones for a multilabel graph or without
        `use_class_weights`)."""
        mask = graph.get_known_node_types_mask()
        if self._multilabel:
            y = graph.get_one_hot_encoded_node_types()
        else:
            y = np.maximum(graph.get_single_label_node_type_ids(), 0).astype(np.int64)
        if self._use_class_weights and not self._multilabel:
            counts = np.bincount(y[mask], minlength=self._n_classes).astype(np.float64)
            weights = counts.sum() / np.maximum(counts * self._n_classes, 1)
        else:
            weights = np.ones(max(self._n_classes, 1))
        return (torch.from_numpy(y).to(self.device), torch.from_numpy(mask).to(self.device),
                torch.from_numpy(weights.astype(np.float32)).to(self.device))

    def _logits(self, params, kernels, n_nodes, training=False, generator=None):
        x = self._spec.materialize(params["embed"])
        h = self._encoder.apply(params["enc"], kernels, x, n_nodes,
                                training=training, generator=generator)
        return apply_mlp(params["head"], h)

    def _loss(self, params, kernels, targets, n_nodes, generator=None):
        """Mean over the labelled nodes of the class-weighted softmax
        cross-entropy, or the logistic loss summed over the types when
        multilabel; dropout from `generator` when given."""
        y, mask, class_w = targets
        logits = self._logits(params, kernels, n_nodes, training=True, generator=generator)
        if self._multilabel:
            per = (F.softplus(logits) - y * logits).sum(dim=1)
        else:
            per = -F.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0] * class_w[y]
        per = torch.where(mask, per, torch.zeros((), device=per.device))
        return per.sum() / mask.sum().clamp(min=1)

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        generator = torch.Generator().manual_seed(self.random_state or 0)
        params, kernels = self._build(graph, support, node_features, generator)
        targets = self._targets(graph)
        drop_generator = _device_generator(generator, self.device)
        loop = TrainLoop(epochs=self._epochs, learning_rate=self._learning_rate,
                         early_stopping_patience=self._early_stopping_patience,
                         checkpoint_dir=self._checkpoint_dir,
                         checkpoint_interval=self._checkpoint_interval,
                         mesh=self._encoder._halo_mesh)
        n_nodes = graph.number_of_nodes
        y, mask, _ = targets
        self._params, self._history = loop.run(
            params, lambda p: self._loss(p, kernels, targets, n_nodes, drop_generator),
            fingerprint=graph_fingerprint(graph, mask.cpu().numpy(), y.cpu().numpy()),
            rng=RandomState([drop_generator]))
        self._epoch_seconds = list(loop.epoch_seconds)

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        """Softmax (sigmoid, multilabel) of every node's logits, convolving
        over `support`'s kernels (the fitted ones without it)."""
        kernels = (self._encoder.build_kernels(support, self.device)
                   if support is not None else self._csr_kernels)
        with torch.no_grad():
            logits = self._logits(self._params, kernels, graph.number_of_nodes)
            proba = torch.sigmoid(logits) if self._multilabel else torch.softmax(logits, dim=1)
        return proba.cpu().numpy()


KipfGCNNodeLabelPrediction = kernel_preset(
    GCNNodeLabelPrediction, "KipfGCNNodeLabelPrediction",
    ["Symmetric Normalized Laplacian"], "Kipf GCN",
)
GraphSAGENodeLabelPrediction = kernel_preset(
    GCNNodeLabelPrediction, "GraphSAGENodeLabelPrediction",
    ["Left Normalized Laplacian"], "GraphSAGE",
)
GNNNodeLabelPrediction = kernel_preset(
    GCNNodeLabelPrediction, "GNNNodeLabelPrediction", [], "GNN")

register_model(GCNNodeLabelPrediction)
