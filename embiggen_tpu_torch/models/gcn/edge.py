"""Edge GCNs — counterpart of `embiggen_tpu/models/gcn/edge.py`
(`_EdgeGCNBase`, `GCNEdgePrediction`, `GCNEdgeLabelPrediction` and their
Kipf GCN / GraphSAGE / GNN presets).

A training step convolves the whole graph (kernel K7 forward, and its
transposed backward), draws an edge minibatch on the device (kernel K6:
uniform positive arcs and scale-free negatives), scores the pairs through
the towers, the edge combination and the head, and takes an Adam step on
the logistic loss. Inference convolves once and scores candidate pairs in
chunks. Edge features join the edge representation before the head, in
the reference's order and with no gradient: lazy edge-feature models
(`edge_feature_models`, or models among `fit`'s `edge_features`, such as
HyperSketching) fitted on the support graph and queried per batch (kernel
K16b); static [arcs, d] matrices looked up by arc id (kernel K5), a zeros
row for non-edges; with `use_edge_metrics`, the edge heuristics of each
pair over the support graph (kernel K8); then each pair's edge type (its
arc's type, looked up by K5; -1 for a non-edge) through the edge-type
feature tables and, with `use_edge_type_embedding`, a learned edge-type
embedding. Node-type features join the node features as per-node rows;
`use_node_type_embedding` adds a learned embedding of each node's primary
type.

With `mesh` (None, "auto", an int or a `parallel.Mesh`) every rank trains
the same model on the same batches and each convolution is the
halo-exchange SpMM (`GCNEncoder.enable_mesh`); the result equals a
single-device fit up to the order of float sums. With `checkpoint_dir`,
`TrainLoop` saves the fit's state every `checkpoint_interval` epochs, the
generators and the edge batch's draws with it, and a later fit of the same
run resumes from it.

The edge-label GCN draws each batch uniformly from the arcs of known type
(`torch.randint` under a generator seeded from the fit's, on the model's
device, then gathers of their ends and types) and takes an Adam step on
the softmax cross-entropy of the types; its edge representation never
holds the edge type, which is the target, so edge-type features and the
edge-type embedding are refused.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.graph import Graph
from ...ops import edge_ops
from ...ops.edge_metrics import N_EDGE_METRICS, edge_metrics
from ...ops.negatives import BatchDraws, edge_prediction_mini_batch
from ...ops.walks import csr_edge_ids
from ...parallel.mesh import Mesh
from ...utils.checkpoint import RandomState
from ..classifier import AbstractClassifierModel
from ..edge_label_prediction.model import AbstractEdgeLabelPredictionModel
from ..edge_prediction.model import AbstractEdgePredictionModel
from ..embedders.walk_based import _device_generator
from ..registry import register_model
from .core import (
    GCNEncoder,
    TrainLoop,
    apply_mlp,
    assemble_node_features,
    graph_fingerprint,
    init_mlp,
    kernel_preset,
    map_params,
)


class _EdgeGCNBase(AbstractClassifierModel):
    """Encoder, towers, edge combination and head."""

    DEFAULT_KERNELS = ["Symmetric Normalized Laplacian"]

    def __init__(
        self,
        kernels: Optional[Sequence[str]] = None,
        units: Sequence[int] = (128, 128),
        tower_units: Sequence[int] = (64,),
        head_units: Sequence[int] = (32,),
        edge_embedding_method: str = "Concatenate",
        siamese_towers: bool = True,
        combiner: str = "sum",
        dropout_rate: float = 0.5,
        residual: bool = False,
        use_node_embedding: bool = False,
        node_embedding_size: int = 50,
        use_node_type_embedding: bool = False,
        node_type_embedding_size: int = 50,
        use_edge_type_embedding: bool = False,
        edge_type_embedding_size: int = 16,
        use_edge_metrics: bool = False,
        edge_feature_models=None,
        batch_size: Optional[int] = None,
        epochs: int = 200,
        learning_rate: float = 0.001,
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
        self._tower_units = list(tower_units)
        self._head_units = list(head_units)
        self._edge_embedding_method = edge_embedding_method
        self._siamese_towers = siamese_towers
        self._combiner = combiner
        self._dropout_rate = dropout_rate
        self._residual = residual
        self._use_node_embedding = use_node_embedding
        self._node_embedding_size = node_embedding_size
        self._use_node_type_embedding = use_node_type_embedding
        self._node_type_embedding_size = node_type_embedding_size
        self._use_edge_type_embedding = use_edge_type_embedding
        self._edge_type_embedding_size = edge_type_embedding_size
        self._use_edge_metrics = use_edge_metrics
        self._edge_feature_models = (
            list(edge_feature_models) if edge_feature_models else [])
        self._batch_size = batch_size
        self._epochs = epochs
        self._learning_rate = learning_rate
        self._early_stopping_patience = early_stopping_patience
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = checkpoint_interval
        edge_ops.resolve(edge_embedding_method, edge_ops.EDGE_GCN_METHODS)
        super().__init__(random_state=random_state, device=device)

    def __getstate__(self) -> Dict[str, Any]:
        # The node representations cached for predictions: a pickle leaves
        # them out, and the first prediction after a load computes them.
        return {**self.__dict__, "_predict_h": None}

    @classmethod
    def can_use_node_type_features(cls) -> bool:
        return True

    @classmethod
    def can_use_edge_type_features(cls) -> bool:
        return True

    @classmethod
    def can_use_edge_features(cls) -> bool:
        return True

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "mesh": self._mesh.size if isinstance(self._mesh, Mesh) else self._mesh,
            "kernels": self._kernels,
            "units": self._units,
            "tower_units": self._tower_units,
            "head_units": self._head_units,
            "edge_embedding_method": self._edge_embedding_method,
            "siamese_towers": self._siamese_towers,
            "combiner": self._combiner,
            "dropout_rate": self._dropout_rate,
            "residual": self._residual,
            "use_node_embedding": self._use_node_embedding,
            "node_embedding_size": self._node_embedding_size,
            "use_node_type_embedding": self._use_node_type_embedding,
            "node_type_embedding_size": self._node_type_embedding_size,
            "use_edge_type_embedding": self._use_edge_type_embedding,
            "edge_type_embedding_size": self._edge_type_embedding_size,
            "use_edge_metrics": self._use_edge_metrics,
            "edge_feature_models": self._edge_feature_models,
            "batch_size": self._batch_size,
            "epochs": self._epochs,
            "learning_rate": self._learning_rate,
            "early_stopping_patience": self._early_stopping_patience,
            "checkpoint_dir": self._checkpoint_dir,
            "checkpoint_interval": self._checkpoint_interval,
            "handling_multi_graph": self._handling_multi_graph,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "units": [8], "tower_units": [8], "head_units": [8],
            "epochs": 5, "batch_size": 64,
        }

    def _resolve_batch_size(self, n_examples: int) -> int:
        """Edges per training step: the explicit value, else (when there are
        convolutions, each step convolving the whole graph) about one edge
        per node, else 1024."""
        if self._batch_size is not None:
            return max(1, min(self._batch_size, max(n_examples, 8)))
        if self._units and self._kernels:
            n_nodes = getattr(self, "_n_nodes_hint", None)
            base = n_nodes if n_nodes else n_examples
            return max(1, min(max(base, 1024), max(n_examples, 8)))
        return max(1, min(1024, max(n_examples, 8)))

    # --------------------------------------------------------------- assembly
    def _build_common(self, graph: Graph, support: Graph, node_features,
                      generator: torch.Generator, edge_features=None,
                      node_type_features=None, edge_type_features=None):
        """Kernels on the device, the node and edge features, and the
        initial parameter tree (drawn on the CPU from `generator`, then
        moved to the device)."""
        self._encoder = GCNEncoder(
            self._kernels if self._units else None,
            self._units,
            combiner=self._combiner,
            dropout_rate=self._dropout_rate,
            residual=self._residual,
            handling_multi_graph=self._handling_multi_graph,
        )
        self._encoder.enable_mesh(self._mesh, self.device)
        kernels = self._encoder.build_kernels(support, self.device)
        self._csr_kernels = kernels
        # A learned node embedding also stands in for no node features.
        use_embedding = self._use_node_embedding or not (
            node_features or node_type_features or self._use_node_type_embedding)
        embed_params, spec = assemble_node_features(
            graph, node_features, use_embedding, self._node_embedding_size,
            self._use_node_type_embedding, self._node_type_embedding_size, generator,
            self.device, node_type_features=node_type_features,
        )
        self._spec = spec
        in_dim = spec.dim(embed_params)
        enc_params = self._encoder.init(generator, in_dim)
        tower_dims = [self._encoder.output_dim(in_dim)] + self._tower_units
        src_tower = init_mlp(tower_dims, generator)
        params = {"embed": embed_params, "enc": enc_params,
                  "src_tower": src_tower}
        if not self._siamese_towers:
            params["dst_tower"] = init_mlp(tower_dims, generator)
        edge_dim = edge_ops.output_dim(self._edge_embedding_method, tower_dims[-1])
        edge_dim += self._build_edge_features(graph, support, edge_features,
                                              edge_type_features)
        # The edge heuristics run on the support graph; their inputs are
        # node ids, so no gradient flows through them.
        self._metrics_tg = (support.device(self.device)
                            if self._use_edge_metrics else None)
        if self._use_edge_metrics:
            edge_dim += N_EDGE_METRICS
        if self._use_edge_type_embedding:
            edge_dim += self._edge_type_embedding_size
        params["head"] = init_mlp(
            [edge_dim] + self._head_units + [self._n_outputs], generator)
        if self._use_edge_type_embedding:
            # [n_edge_types + 1, d]: row 0 for an unknown type or a non-edge.
            params["edge_type_embedding"] = torch.randn(
                (max(graph.number_of_edge_types, 1) + 1, self._edge_type_embedding_size),
                generator=generator) / np.sqrt(self._edge_type_embedding_size)
        self._combine_fn = edge_ops.resolve(
            self._edge_embedding_method, edge_ops.EDGE_GCN_METHODS)
        return map_params(lambda t: t.to(self.device), params), kernels

    def _build_edge_features(self, graph: Graph, support: Graph, edge_features,
                             edge_type_features=None) -> int:
        """Fit the lazy models (`edge_feature_models`, then those of
        `edge_features`, as `normalize_edge_features` splits it into lazy
        models and static matrices) on the support graph, lay the static
        [arcs of graph, d] float32 matrices out on the device with a
        trailing zeros row (index `arcs`, K5's id of a non-edge), and the
        edge-type feature tables [n_edge_types + 1, d] with a leading zeros
        row (type -1). Returns the width they add to the edge
        representation, the edge-type embedding's aside."""
        lazy, static = edge_features or ([], [])
        lazy = list(self._edge_feature_models) + list(lazy)
        width = 0
        self._edge_feature_fns = []
        for ef in lazy:
            if torch.device(ef.device).type != self.device.type:
                raise ValueError(f"Edge feature model {ef.model_name()} is on {ef.device}, "
                                 f"the GCN on {self.device}.")
            ef.fit(support)
            self._edge_feature_fns.append(ef.device_feature_fn())
            width += sum(int(np.prod(shape))
                         for shape in ef.get_feature_dictionary_shapes().values())
        self._static_edge_feats = [
            torch.from_numpy(np.vstack([f, np.zeros((1, f.shape[1]), np.float32)])).to(self.device)
            for f in static]
        width += sum(int(f.shape[1]) for f in static)
        self._edge_type_feat_tables = [
            torch.from_numpy(np.vstack([np.zeros((1, f.shape[1]), np.float32),
                                        np.asarray(f, np.float32)])).to(self.device)
            for f in (edge_type_features or [])]
        width += sum(int(t.shape[1]) for t in self._edge_type_feat_tables)
        # The pairs' arc ids (K5) serve the static matrices and, on a graph
        # with edge types, the pairs' types.
        self._typed_edges = bool(self._edge_type_feat_tables or self._use_edge_type_embedding)
        needs_lookup = bool(static) or (self._typed_edges and graph.has_edge_types)
        self._lookup_tg = graph.device(self.device) if needs_lookup else None
        return width

    def _encode_nodes(self, params, kernels, n_nodes, training=False,
                      generator=None) -> torch.Tensor:
        """Features and the convolution stack → [N, H] node representations."""
        x = self._spec.materialize(params["embed"])
        return self._encoder.apply(params["enc"], kernels, x, n_nodes,
                                   training=training, generator=generator)

    def _score_edges(self, params, h, src, dst, return_representation=False):
        """Towers → edge combination → head for (src, dst) pairs over the
        node representations `h`; with `return_representation`, the edge
        representation before the head (the beheaded model)."""
        src, dst = src.long(), dst.long()
        h_src = apply_mlp(params["src_tower"], h[src], final_activation=torch.relu)
        dst_tower = params.get("dst_tower", params["src_tower"])
        h_dst = apply_mlp(dst_tower, h[dst], final_activation=torch.relu)
        e = self._combine_fn(h_src, h_dst)
        src32, dst32 = src.to(torch.int32), dst.to(torch.int32)
        for fn in self._edge_feature_fns:
            e = torch.cat([e, fn(src32, dst32)], dim=1)
        if self._lookup_tg is not None:
            ids, found = csr_edge_ids(self._lookup_tg.row_ptr, self._lookup_tg.col_idx,
                                      src32, dst32)
            ids = ids.long()
        if self._static_edge_feats:
            e = torch.cat([e] + [t[ids] for t in self._static_edge_feats], dim=1)
        if self._use_edge_metrics:
            m = edge_metrics(self._metrics_tg, src32, dst32)
            # log1p of preferential attachment, as the Perceptron's feature.
            e = torch.cat([e, m[:, :3], torch.log1p(m[:, 3:4])], dim=1)
        if self._typed_edges:
            # Row et + 1 of each table: an arc's type, 0 for a non-edge or a
            # graph without edge types.
            row = torch.zeros_like(src)
            types = None if self._lookup_tg is None else self._lookup_tg.edge_types
            if types is not None:
                row = torch.where(found, types[ids.clamp(max=types.shape[0] - 1)].long() + 1, 0)
            tables = list(self._edge_type_feat_tables)
            if self._use_edge_type_embedding:
                tables.append(params["edge_type_embedding"])
            e = torch.cat([e] + [t[row] for t in tables], dim=1)
        if return_representation:
            return e
        return apply_mlp(params["head"], e)

    def _edge_logits(self, params, kernels, src, dst, n_nodes, training=False,
                     generator=None):
        h = self._encode_nodes(params, kernels, n_nodes, training=training,
                               generator=generator)
        return self._score_edges(params, h, src, dst)

    def _chunked_logits(self, src: np.ndarray, dst: np.ndarray,
                        chunk: int = 1 << 22,
                        representation: bool = False) -> np.ndarray:
        """Inference for any candidate pairs: the convolution runs once per
        fitted parameters, then pairs are scored in chunks of `chunk`, so
        [E, H] tower activations never exist at once."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        with torch.no_grad():
            if self._predict_h is None:
                self._predict_h = self._encode_nodes(
                    self._params, self._csr_kernels, self._n_nodes)
            h = self._predict_h
            outs = [
                self._score_edges(
                    self._params, h,
                    torch.from_numpy(src[i:i + chunk]).to(self.device),
                    torch.from_numpy(dst[i:i + chunk]).to(self.device),
                    return_representation=representation,
                ).cpu()
                for i in range(0, len(src), chunk)
            ]
        if not outs:
            width = (self._params["head"][0]["w"].shape[0] if representation
                     else self._n_outputs)
            return np.zeros((0, width), np.float32)
        return torch.cat(outs).numpy()

    # ------------------------------------------------ beheaded edge model
    def transform_edges_from_edge_node_ids(self, src, dst) -> np.ndarray:
        """Edge representations before the head, for any (src, dst) pairs."""
        return self._chunked_logits(src, dst, representation=True)

    def transform_edges(self, graph: Graph):
        """Edge representations of every arc of `graph` as an
        EmbeddingResult."""
        from ..embedding_result import EmbeddingResult

        return EmbeddingResult(
            embedding_method_name=f"Beheaded {self.model_name()}",
            edge_embeddings=[self.transform_edges_from_edge_node_ids(
                graph.sources, graph.col_idx)],
        )


class GCNEdgePrediction(_EdgeGCNBase, AbstractEdgePredictionModel):
    """Configurable edge-prediction GCN ("Everything Bagel GCN")."""

    @classmethod
    def model_name(cls) -> str:
        return "Everything Bagel GCN"

    def __init__(self, negative_samples_rate: float = 0.5,
                 use_scale_free_distribution: bool = True, **kwargs):
        self._negative_samples_rate = negative_samples_rate
        self._use_scale_free_distribution = use_scale_free_distribution
        super().__init__(**kwargs)

    def parameters(self):
        return {
            **super().parameters(),
            "negative_samples_rate": self._negative_samples_rate,
            "use_scale_free_distribution": self._use_scale_free_distribution,
        }

    def _loss(self, params, kernels, tg, batch, generator, drop_generator, workspace=None):
        """Logistic loss of one minibatch, drawn by K6 (into the fit's
        `workspace`, a `BatchDraws.edges`, where one is given) unless `batch`
        ((src, dst, labels)) is given."""
        src, dst, labels = batch if batch is not None else edge_prediction_mini_batch(
            tg, generator, self._run_batch_size,
            negative_samples_rate=self._negative_samples_rate,
            use_scale_free_distribution=self._use_scale_free_distribution,
            workspace=workspace,
        )
        logits = self._edge_logits(
            params, kernels, src, dst, tg.n_nodes, training=True,
            generator=drop_generator,
        )[:, 0]
        return (F.softplus(logits) - labels * logits).mean()

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        generator = torch.Generator().manual_seed(self.random_state or 0)
        self._n_outputs = 1
        params, kernels = self._build_common(
            graph, support, node_features, generator, kwargs.get("edge_features"),
            kwargs.get("node_type_features"), kwargs.get("edge_type_features"))
        # On the card, K6 reads a positive's two ends from one 8-byte record.
        tg = graph.device(self.device, with_sources=True,
                          with_arc_pairs=torch.device(self.device).type == "cuda")
        self._n_nodes_hint = graph.number_of_nodes
        self._run_batch_size = self._resolve_batch_size(
            graph.number_of_directed_edges)
        drop_generator = _device_generator(generator, self.device)
        # The batch's block and labels, and its Philox key on the card: once a fit.
        draws = BatchDraws.edges(self._run_batch_size, self._negative_samples_rate, tg.device)
        loop = TrainLoop(
            epochs=self._epochs, learning_rate=self._learning_rate,
            early_stopping_patience=self._early_stopping_patience,
            steps_per_epoch=max(
                1, graph.number_of_directed_edges // self._run_batch_size),
            checkpoint_dir=self._checkpoint_dir,
            checkpoint_interval=self._checkpoint_interval,
            mesh=self._encoder._halo_mesh,
        )
        self._params, self._history = loop.run(
            params,
            lambda p: self._loss(p, kernels, tg, None, generator, drop_generator, draws),
            fingerprint=graph_fingerprint(graph),
            rng=RandomState([generator, drop_generator], lambda: [draws]),
        )
        self._epoch_seconds = list(loop.epoch_seconds)
        self._steps_per_epoch = loop.steps_per_epoch
        self._n_nodes = graph.number_of_nodes
        self._predict_h = None

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        """Sigmoid scores of every arc of `graph`, convolving over the
        fitted support's kernels."""
        return self.predict_proba_from_edge_node_ids(graph.sources, graph.col_idx)

    def predict_proba_from_edge_node_ids(self, src: np.ndarray,
                                         dst: np.ndarray) -> np.ndarray:
        logits = self._chunked_logits(src, dst)[:, 0]
        return torch.sigmoid(torch.from_numpy(logits)).numpy()


class GCNEdgeLabelPrediction(_EdgeGCNBase, AbstractEdgeLabelPredictionModel):
    """Configurable edge-label prediction GCN ("Everything Bagel GCN"):
    `max(edge types, 2)` outputs over the towers, the edge combination and
    the head."""

    def __init__(self, **kwargs):
        kwargs.pop("use_edge_type_embedding", None)
        kwargs.pop("edge_type_embedding_size", None)
        super().__init__(**kwargs)

    def parameters(self):
        p = super().parameters()
        p.pop("use_edge_type_embedding", None)
        p.pop("edge_type_embedding_size", None)
        return p

    @classmethod
    def can_use_edge_type_features(cls) -> bool:
        return False

    @classmethod
    def model_name(cls) -> str:
        return "Everything Bagel GCN"

    def is_binary_prediction_task(self) -> bool:
        return self._n_outputs == 2

    def _draw_batch(self, known, generator):
        """(src, dst, types) of `_run_batch_size` arcs drawn uniformly, with
        replacement, from `known` ((src, dst, types) of every arc of known
        type) with `generator`, on their device."""
        src_all, dst_all, y_all = known
        pick = torch.randint(0, src_all.shape[0], (self._run_batch_size,),
                             generator=generator, device=src_all.device)
        return src_all[pick], dst_all[pick], y_all[pick]

    def _loss(self, params, kernels, known, batch, generator, drop_generator):
        """Softmax cross-entropy of one batch of arcs of known type: `batch`
        ((src, dst, types)) when given, else one drawn from `known` with
        `generator`."""
        src, dst, y = batch if batch is not None else self._draw_batch(known, generator)
        logits = self._edge_logits(params, kernels, src, dst, self._n_nodes, training=True,
                                   generator=drop_generator)
        return -F.log_softmax(logits, dim=1).gather(1, y.long()[:, None]).mean()

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        generator = torch.Generator().manual_seed(self.random_state or 0)
        self._n_outputs = max(graph.number_of_edge_types, 2)
        params, kernels = self._build_common(
            graph, support, node_features, generator, kwargs.get("edge_features"),
            kwargs.get("node_type_features"))
        known_idx = np.nonzero(graph.get_known_edge_types_mask())[0]
        if len(known_idx) == 0:
            raise ValueError("Graph has no known edge types to train on.")
        known = tuple(torch.from_numpy(np.ascontiguousarray(a[known_idx], np.int32)).to(self.device)
                      for a in (graph.sources, graph.col_idx, graph.edge_types))
        self._n_nodes = self._n_nodes_hint = graph.number_of_nodes
        self._run_batch_size = self._resolve_batch_size(len(known_idx))
        batch_generator = _device_generator(generator, self.device)
        drop_generator = _device_generator(generator, self.device)
        loop = TrainLoop(
            epochs=self._epochs, learning_rate=self._learning_rate,
            early_stopping_patience=self._early_stopping_patience,
            steps_per_epoch=max(1, len(known_idx) // self._run_batch_size),
            checkpoint_dir=self._checkpoint_dir,
            checkpoint_interval=self._checkpoint_interval,
            mesh=self._encoder._halo_mesh,
        )
        self._params, self._history = loop.run(
            params,
            lambda p: self._loss(p, kernels, known, None, batch_generator, drop_generator),
            fingerprint=graph_fingerprint(graph, known_idx, graph.edge_types[known_idx]),
            rng=RandomState([batch_generator, drop_generator]),
        )
        self._epoch_seconds = list(loop.epoch_seconds)
        self._steps_per_epoch = loop.steps_per_epoch
        self._predict_h = None

    def _predict_proba(self, graph: Graph, **kwargs) -> np.ndarray:
        """[arcs, outputs] softmax of every arc of `graph`."""
        logits = self._chunked_logits(graph.sources, graph.col_idx)
        return torch.softmax(torch.from_numpy(logits), dim=1).numpy()


KipfGCNEdgePrediction = kernel_preset(
    GCNEdgePrediction, "KipfGCNEdgePrediction",
    ["Symmetric Normalized Laplacian"], "Kipf GCN",
)
GraphSAGEEdgePrediction = kernel_preset(
    GCNEdgePrediction, "GraphSAGEEdgePrediction",
    ["Left Normalized Laplacian"], "GraphSAGE",
)
GNNEdgePrediction = kernel_preset(GCNEdgePrediction, "GNNEdgePrediction", [], "GNN")
KipfGCNEdgeLabelPrediction = kernel_preset(
    GCNEdgeLabelPrediction, "KipfGCNEdgeLabelPrediction",
    ["Symmetric Normalized Laplacian"], "Kipf GCN",
)
GraphSAGEEdgeLabelPrediction = kernel_preset(
    GCNEdgeLabelPrediction, "GraphSAGEEdgeLabelPrediction",
    ["Left Normalized Laplacian"], "GraphSAGE",
)
GNNEdgeLabelPrediction = kernel_preset(
    GCNEdgeLabelPrediction, "GNNEdgeLabelPrediction", [], "GNN")

register_model(GCNEdgePrediction)
register_model(GCNEdgeLabelPrediction)
