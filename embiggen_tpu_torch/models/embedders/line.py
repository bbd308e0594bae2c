"""First- and second-order LINE — counterpart of
`embiggen_tpu/models/embedders/line.py` (`_LINEBase`, `FirstOrderLINE`,
`SecondOrderLINE`).

A step draws a batch of uniform arcs with K scale-free (or uniform)
negatives each (kernel K14 on the card, `ops.negatives.line_mini_batch`),
takes the logistic loss of the dot products, SUMMED over the batch, with
the logits straight-through-clipped at +-clipping_value, and applies the
per-row mean update to the gathered rows (kernel K4 standalone on the
card). The gradients with respect to the gathered rows are taken by
autograd, as the JAX version takes them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...graph.graph import Graph, TorchGraph
from ...ops.negatives import line_mini_batch
from ...ops.skipgram import _st_clip
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import MinibatchEmbedder, Update, value_and_grad


class _LINEBase(MinibatchEmbedder):
    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 30,
        batch_size: Optional[int] = None,
        number_of_negative_samples: int = 5,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.9,
        use_scale_free_distribution: bool = True,
        avoid_false_negatives: bool = False,
        clipping_value: float = 6.0,
        **kwargs,
    ):
        self._number_of_negative_samples = number_of_negative_samples
        self._use_scale_free_distribution = use_scale_free_distribution
        self._avoid_false_negatives = avoid_false_negatives
        self._clipping_value = clipping_value
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
            "number_of_negative_samples": self._number_of_negative_samples,
            "use_scale_free_distribution": self._use_scale_free_distribution,
            "avoid_false_negatives": self._avoid_false_negatives,
            "clipping_value": self._clipping_value,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5, "epochs": 2, "batch_size": 64}

    def _prepare_data(self, graph: Graph) -> TorchGraph:
        return graph.device(self.device, with_sources=True)

    def _sample_batch(self, tg: TorchGraph, generator: torch.Generator, batch_size: int):
        """sliceable (src [B], dst [B], neg [B, K]); no shared leaves."""
        return line_mini_batch(
            tg, generator, batch_size, self._number_of_negative_samples,
            self._use_scale_free_distribution, self._avoid_false_negatives,
        ), ()

    def _grads(self, e_src, c_dst, c_neg):
        """(loss sum, (g_src [B, D], g_dst [B, D], g_neg [B, K, D])) of the
        batch's logistic loss over the gathered rows."""
        clip = self._clipping_value

        def loss_fn(a, b, c):
            pos_logit = _st_clip((a * b).sum(dim=1), clip)
            neg_logit = _st_clip(torch.einsum("bd,bkd->bk", a, c), clip)
            return F.softplus(-pos_logit).sum() + F.softplus(neg_logit).sum()

        return value_and_grad(loss_fn, (e_src, c_dst, c_neg))


@register_model
class FirstOrderLINE(_LINEBase):
    """LINE first order: sigmoid(u_i . u_j) over one embedding table."""

    @classmethod
    def model_name(cls) -> str:
        return "First-order LINE"

    def _param_shapes(self, n_nodes, n_edge_types):
        return {"node_embedding": (n_nodes, self.embedding_size)}

    def _batch_updates(self, params, batch, full_batch):
        (src, dst, neg), _ = batch
        emb = params["node_embedding"]
        loss, (g_s, g_d, g_n) = self._grads(
            emb[src.long()], emb[dst.long()], emb[neg.long()])
        # One mean update over the whole multiset src + dst + negatives, as
        # aligned segments that share one count vector.
        return loss, [Update("node_embedding", (src, dst, neg.reshape(-1)),
                             (g_s, g_d, g_n.reshape(-1, self.embedding_size)), "mean")]

    def _extract(self, params, graph):
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[params["node_embedding"].cpu().numpy()],
            node_names=graph.get_node_names(),
        )


@register_model
class SecondOrderLINE(_LINEBase):
    """LINE second order: sigmoid(u_i . c_j) with a separate context table."""

    @classmethod
    def model_name(cls) -> str:
        return "Second-order LINE"

    def _param_shapes(self, n_nodes, n_edge_types):
        d = self.embedding_size
        return {"node_embedding": (n_nodes, d), "context_embedding": (n_nodes, d)}

    def _batch_updates(self, params, batch, full_batch):
        (src, dst, neg), _ = batch
        emb, ctx = params["node_embedding"], params["context_embedding"]
        loss, (g_s, g_d, g_n) = self._grads(
            emb[src.long()], ctx[dst.long()], ctx[neg.long()])
        return loss, [
            Update("node_embedding", src, g_s, "mean"),
            Update("context_embedding", (dst, neg.reshape(-1)),
                   (g_d, g_n.reshape(-1, self.embedding_size)), "mean"),
        ]

    def _extract(self, params, graph):
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[params["node_embedding"].cpu().numpy(),
                             params["context_embedding"].cpu().numpy()],
            node_names=graph.get_node_names(),
        )
