"""Role2Vec — counterpart of
`embiggen_tpu/models/embedders/factorization.py::Role2Vec`, single device.
The module's other models (NetMF ... NNSED) come with ROADMAP A11b.

Walks are drawn as SkipGram's are (K2 for the starts, then K1, or K9 / K10
for p/q walks) and cut into windows; each context node is replaced by its
Weisfeiler-Lehman structural role, and each centre node learns to predict
the roles around it against K uniformly drawn roles, by a sigmoid NCE whose
two terms are means over the pairs' positives and negatives. The updates
are "add" updates through `apply_updates` (`index_add_`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.graph import Graph
from ...ops.negatives import sample_nodes_uniform
from ...ops.walks import node2vec_batch
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import Update, apply_updates, value_and_grad
from .walk_based import WalkBasedEmbedder, _device_generator


@register_model
class Role2Vec(WalkBasedEmbedder):
    """Structural-role embeddings: nodes are trained to predict the WL role
    ids of their walk contexts with a sigmoid-NCE objective."""

    def __init__(
        self,
        embedding_size: int = 100,
        weisfeiler_lehman_hashing_iterations: int = 2,
        erase_base_features: bool = False,
        **kwargs,
    ):
        self._wl_iterations = weisfeiler_lehman_hashing_iterations
        self._erase_base_features = erase_base_features
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "Role2Vec"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "weisfeiler_lehman_hashing_iterations": self._wl_iterations,
            "erase_base_features": self._erase_base_features,
        }

    def _wl_roles(self, graph: Graph) -> np.ndarray:
        """Compact structural role id per node: log-degree bins refined by
        WL iterations with a commutative multiset hash (host numpy, the
        reference's draws from default_rng(7))."""
        n = graph.number_of_nodes
        row_ptr, col_idx = graph.row_ptr, graph.col_idx
        labels = np.floor(
            np.log2(np.maximum(graph.degrees, 1))
        ).astype(np.int64)
        base = labels.copy()
        rng = np.random.default_rng(7)
        for _ in range(self._wl_iterations):
            _, labels = np.unique(labels, return_inverse=True)
            salt = rng.integers(1, 2**62, labels.max() + 1)
            hashed = salt[labels]
            neigh_sum = np.zeros(n, np.int64)
            np.add.at(
                neigh_sum,
                np.repeat(np.arange(n), np.diff(row_ptr)),
                hashed[col_idx],
            )
            labels = hashed * 31 + neigh_sum
        if not self._erase_base_features:
            labels = labels * 131 + base
        _, roles = np.unique(labels, return_inverse=True)
        return roles.astype(np.int32)

    # ------------------------------------------------------------- the tables
    def _param_shapes(self, graph: Graph) -> Dict[str, Tuple[int, ...]]:
        d = self.embedding_size
        return {"node_embedding": (graph.number_of_nodes, d),
                "role_embedding": (self._n_roles, d)}

    def _initial_tables(self, graph: Graph, generator: torch.Generator):
        roles = self._wl_roles(graph)
        self._roles = torch.from_numpy(roles).to(self.device)
        self._n_roles = int(roles.max()) + 1
        # Negative roles are drawn on the model's device.
        self._role_generator = (generator if self.device.type == "cpu"
                                else _device_generator(generator, self.device))
        return super()._initial_tables(graph, generator)

    def _new_sums(self, params) -> None:
        return None

    # ------------------------------------------------------------- the step
    def _sample_role_pairs(self, tg, generator: torch.Generator):
        """(words [M], roles [M, 2w], neg_roles [M, K]) for one step: the
        windows of fresh walks, their contexts' roles, and K uniform roles
        per pair from a generator on the model's device."""
        starts = sample_nodes_uniform(tg, generator, (self._run_batch_size,))
        contexts, words = node2vec_batch(
            tg, starts, self._walk_length, self._window_size, generator,
            iterations=self._iterations, return_weight=self._return_weight,
            explore_weight=self._explore_weight, max_neighbours=self._max_neighbours)
        neg_roles = torch.randint(0, self._n_roles,
                                  (words.shape[0], self._number_of_negative_samples),
                                  generator=self._role_generator, device=self.device,
                                  dtype=torch.int32)
        return words, self._roles[contexts.long()], neg_roles

    def _pair_updates(self, params, words, roles, neg_roles, n_full):
        """(loss, updates) for the pairs; each loss term is a mean over the
        `n_full` pairs' positives or negatives."""
        w, k = roles.shape[1], neg_roles.shape[1]

        def loss_fn(w_rows, pos_rows, neg_rows):
            pos_logit = torch.einsum("nd,nwd->nw", w_rows, pos_rows)
            neg_logit = torch.einsum("nd,nkd->nk", w_rows, neg_rows)
            return (F.softplus(-pos_logit).sum() / (n_full * w)
                    + F.softplus(neg_logit).sum() / (n_full * k))

        emb, role = params["node_embedding"], params["role_embedding"]
        loss, (g_w, g_pos, g_neg) = value_and_grad(
            loss_fn, [emb[words.long()], role[roles.long()], role[neg_roles.long()]])
        d = emb.shape[1]
        return loss, [
            Update("node_embedding", words, g_w, "add"),
            Update("role_embedding", roles.reshape(-1), g_pos.reshape(-1, d), "add"),
            Update("role_embedding", neg_roles.reshape(-1), g_neg.reshape(-1, d), "add"),
        ]

    def _step(self, tg, params, generator, lr, batch=None, sums=None) -> torch.Tensor:
        """One step on `params`, in place, from fresh pairs (or the injected
        `batch` of (words, roles, neg_roles)); returns the loss."""
        words, roles, neg_roles = (self._sample_role_pairs(tg, generator)
                                   if batch is None else batch)
        loss, updates = self._pair_updates(params, words, roles, neg_roles,
                                           words.shape[0])
        apply_updates(params, updates, lr)
        return loss

    def _extract(self, params, graph: Graph) -> EmbeddingResult:
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[params["node_embedding"].cpu().numpy()],
            node_names=graph.get_node_names(),
        )
