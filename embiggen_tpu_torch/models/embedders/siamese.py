"""Siamese (triple) embedders: Unstructured, TransE, TransH and Structured
Embedding — counterpart of `embiggen_tpu/models/embedders/siamese.py`.

A step draws uniform arcs, each with one side corrupted by a scale-free
(or uniform) node (kernel K14 on the card, `ops.negatives.
siamese_mini_batch`, into the [4, B] block of int32 rows, or [5, B] with
edge types, that the fit allocates once), takes the margin loss
ReLU(relu_bias + d(pos) - d(neg)) averaged over the batch on the gathered
rows, and scatter-adds the gradients (autograd, as the JAX version takes
them) into the tables. Models declare their tables in three groups, as the
JAX package's do: ENTITY_KEYS (per node, gathered at the four batch index
sets), REL_KEYS (per edge type, gathered at the batch's types) and
GLOBAL_KEYS (dense), plus a `_distance` hook.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...graph.graph import Graph, TorchGraph
from ...ops.losses import l1_distance, squared_l2_distance
from ...ops.negatives import BatchDraws, siamese_mini_batch
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import MinibatchEmbedder, Update, value_and_grad


class SiameseEmbedder(MinibatchEmbedder):
    """Shared skeleton: margin loss over (positive, corrupted) triples.

    - ENTITY_KEYS: per-node tables, updated with scatter-adds;
    - REL_KEYS: per-edge-type tables, [max(edge types, 1), ...];
    - GLOBAL_KEYS: dense parameters, updated with plain SGD.
    """

    NORM = "L2"  # or L1
    ENTITY_KEYS = ("node_embedding",)
    REL_KEYS = ()
    GLOBAL_KEYS = ()
    # Relation tables exported as edge-type embeddings (vectors only).
    EXTRACT_REL = ("edge_type_embedding",)

    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 30,
        batch_size: Optional[int] = None,
        relu_bias: float = 1.0,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.9,
        use_scale_free_distribution: bool = True,
        **kwargs,
    ):
        self._relu_bias = relu_bias
        self._use_scale_free_distribution = use_scale_free_distribution
        super().__init__(
            embedding_size=embedding_size,
            epochs=epochs,
            batch_size=batch_size,
            learning_rate=learning_rate,
            learning_rate_decay=learning_rate_decay,
            **kwargs,
        )

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "relu_bias": self._relu_bias,
            "use_scale_free_distribution": self._use_scale_free_distribution,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5, "epochs": 2, "batch_size": 64}

    def _uses_edge_types(self) -> bool:
        return len(self.REL_KEYS) > 0

    def _distance(self, h, t, rel, glob):
        """Distance of the common single-entity-table case; h, t: [B, D]."""
        if self.NORM == "L1":
            return l1_distance(h, t)
        return squared_l2_distance(h, t)

    def _triple_distance(self, h_dict, t_dict, rel, glob):
        return self._distance(
            h_dict["node_embedding"], t_dict["node_embedding"], rel, glob)

    # --- tables -------------------------------------------------------------
    def _relation_shapes(self, r: int) -> Dict[str, tuple]:
        if not self.REL_KEYS:
            return {}
        return {"edge_type_embedding": (r, self.embedding_size)}

    def _param_shapes(self, n_nodes, n_edge_types):
        shapes = {name: (n_nodes, self.embedding_size) for name in self.ENTITY_KEYS}
        shapes.update(self._relation_shapes(max(n_edge_types, 1)))
        expected = set(self.ENTITY_KEYS) | set(self.REL_KEYS) | set(self.GLOBAL_KEYS)
        assert set(shapes) == expected, (set(shapes), expected)
        return shapes

    # --- training hooks -----------------------------------------------------
    def _pre_fit_check(self, graph: Graph) -> None:
        if self._uses_edge_types() and not graph.has_edge_types:
            raise ValueError(
                f"{self.model_name()} requires edge types; graph "
                f"{graph.name} has none."
            )

    def _prepare_data(self, graph: Graph) -> TorchGraph:
        return graph.device(self.device, with_sources=True)

    def _sample_batch(self, tg: TorchGraph, generator: torch.Generator, batch_size: int):
        """sliceable: the [4, B] block (src, dst, csrc, cdst), [5, B] with
        the edge types, of int32 node ids; no shared leaves."""
        typed = self._uses_edge_types()
        draws = self._fit_buffer("batches",
                                 lambda: BatchDraws.siamese(batch_size, typed, tg.device))
        return siamese_mini_batch(
            tg, generator, batch_size,
            use_scale_free_distribution=self._use_scale_free_distribution,
            with_edge_types=typed, workspace=draws,
        ), ()

    def _batch_updates(self, params, batch, full_batch):
        block, _ = batch
        idx = block[:4]
        flat = idx.reshape(-1)
        etype = block[4] if self._uses_edge_types() else None
        ent_keys, rel_keys, glob_keys = self.ENTITY_KEYS, self.REL_KEYS, self.GLOBAL_KEYS
        leaves = ([params[n].index_select(0, flat).view(*idx.shape, *params[n].shape[1:])
                   for n in ent_keys]
                  + [params[n].index_select(0, etype) for n in rel_keys]
                  + [params[n] for n in glob_keys])
        bias = self._relu_bias
        n_ent, n_rel = len(ent_keys), len(rel_keys)

        def loss_fn(*xs):
            ent = dict(zip(ent_keys, xs[:n_ent]))
            rel = dict(zip(rel_keys, xs[n_ent:n_ent + n_rel]))
            glob = dict(zip(glob_keys, xs[n_ent + n_rel:]))
            row = lambda i: {n: v[i] for n, v in ent.items()}  # noqa: E731
            pos = self._triple_distance(row(0), row(1), rel, glob)
            neg = self._triple_distance(row(2), row(3), rel, glob)
            # The margin mean over the full batch (the reference's
            # reduction); torch.maximum splits the gradient at a tie as
            # jnp.maximum does.
            margin = bias + pos - neg
            return torch.maximum(margin, margin.new_zeros(())).sum() / full_batch

        loss, grads = value_and_grad(loss_fn, leaves)
        updates = [Update(n, flat, g.reshape((-1,) + g.shape[2:]), "add")
                   for n, g in zip(ent_keys, grads[:n_ent])]
        updates += [Update(n, etype, g, "add")
                    for n, g in zip(rel_keys, grads[n_ent:n_ent + n_rel])]
        updates += [Update(n, None, g, "dense")
                    for n, g in zip(glob_keys, grads[n_ent + n_rel:])]
        # The loss is the full-batch mean; scaled back to a sum, so the
        # step's division by the batch reports the margin mean.
        return loss * full_batch, updates

    # --- extraction ---------------------------------------------------------
    def _extract(self, params, graph):
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[params[n].cpu().numpy() for n in self.ENTITY_KEYS],
            edge_type_embeddings=[params[n].cpu().numpy()
                                  for n in self.EXTRACT_REL if n in params],
            node_names=graph.get_node_names(),
        )


@register_model
class Unstructured(SiameseEmbedder):
    """Margin loss on plain node distances, no relation parameters."""

    @classmethod
    def model_name(cls) -> str:
        return "Unstructured"


@register_model
class TransE(SiameseEmbedder):
    """Translation model: d(h + r, t) margin loss."""

    REL_KEYS = ("edge_type_embedding",)

    @classmethod
    def model_name(cls) -> str:
        return "TransE"

    @classmethod
    def requires_edge_types(cls) -> bool:
        return True

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        if self.NORM == "L1":
            return l1_distance(h + r, t)
        return squared_l2_distance(h + r, t)


@register_model
class StructuredEmbedding(SiameseEmbedder):
    """Relation-specific projections: d(W_h^r h, W_t^r t) margin loss."""

    NORM = "L1"
    REL_KEYS = ("source_projection", "destination_projection")
    EXTRACT_REL = ()

    @classmethod
    def model_name(cls) -> str:
        return "Structured Embedding"

    @classmethod
    def requires_edge_types(cls) -> bool:
        return True

    def _relation_shapes(self, r):
        d = self.embedding_size
        return {name: (r, d, d) for name in self.REL_KEYS}

    def _init_table(self, name, shape, g):
        """Projections: the identity plus normal noise of scale
        0.1 / sqrt(D)."""
        if name not in self.REL_KEYS:
            return super()._init_table(name, shape, g)
        d = self.embedding_size
        noise = torch.randn(shape, generator=g, device=self.device).mul_(0.1 / np.sqrt(d))
        return noise.add_(torch.eye(d, device=self.device))

    def _distance(self, h, t, rel, glob):
        a = torch.einsum("bij,bj->bi", rel["source_projection"], h)
        b = torch.einsum("bij,bj->bi", rel["destination_projection"], t)
        return l1_distance(a, b)


@register_model
class TransH(SiameseEmbedder):
    """TransH: translation on a relation-specific hyperplane,
    d(h - (w.h)w + r, t - (w.t)w)."""

    REL_KEYS = ("edge_type_embedding", "normal_vector")

    @classmethod
    def model_name(cls) -> str:
        return "TransH"

    @classmethod
    def requires_edge_types(cls) -> bool:
        return True

    def _relation_shapes(self, r):
        return {name: (r, self.embedding_size) for name in self.REL_KEYS}

    def _distance(self, h, t, rel, glob):
        e_r = rel["edge_type_embedding"]
        w = rel["normal_vector"]
        w = w / torch.linalg.norm(w, dim=1, keepdim=True).clamp(min=1e-9)

        def prj(e):
            return e - (w * e).sum(dim=1, keepdim=True) * w
        if self.NORM == "L1":
            return l1_distance(prj(h) + e_r, prj(t))
        return squared_l2_distance(prj(h) + e_r, prj(t))
