"""Spectral embedders: HOPE, Laplacian Eigenmaps, GLEE (Geometric Laplacian
Eigenmaps) and SocioDim — counterpart of
`embiggen_tpu/models/embedders/spectral.py`, with HOPE's 11 similarity
metrics (three of them on DAGs, through `similarities`).

These rows compute on the host on every device, as the reference does:
scipy sparse operators and ARPACK in float64 (`svds`, `eigsh`), with the
reference's arguments, sort orders, √σ scaling and zero padding. They are
deterministic; `device` is taken as every row takes it, and the result is
numpy whatever it is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ...graph.graph import Graph
from ...graph.laplacians import kernel_coo
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from ..registry import register_model

HOPE_METRICS = [
    "Jaccard",
    "Neighbours Intersection size",
    "Ancestors Jaccard",
    "Ancestors size",
    "Adamic-Adar",
    "Adjacency",
    "Laplacian",
    "Left Normalized Laplacian",
    "Right Normalized Laplacian",
    "Symmetric Normalized Laplacian",
    "Resnik",
]

# Metrics that read the graph as a DAG (an ontology) with arcs child -> parent.
DAG_METRICS = ("Ancestors Jaccard", "Ancestors size", "Resnik")


def _dag_similarity_matrix(graph: Graph, metric: str):
    import scipy.sparse as sp

    n = graph.number_of_nodes
    if metric == "Resnik":
        # The IC of each pair's most informative common ancestor.
        from ...similarities import DAGResnik

        sim = DAGResnik().fit(graph).get_similarities_from_clique_graph_node_ids(
            np.arange(n)
        )
        return sp.csr_matrix(sim)
    # Z[v, a] = 1 iff a is an ancestor of v (v included), arcs child -> parent.
    from ...similarities import ancestors_csr

    z = ancestors_csr(graph)
    inter = (z @ z.T).tocoo()
    if metric == "Ancestors size":
        return inter.tocsr()
    # Ancestors Jaccard.
    sizes = np.asarray(z.sum(axis=1)).reshape(-1)
    union = sizes[inter.row] + sizes[inter.col] - inter.data
    data = inter.data / np.maximum(union, 1)
    return sp.csr_matrix((data, (inter.row, inter.col)), shape=(n, n))


def _adjacency(graph: Graph, weighted: bool = False):
    import scipy.sparse as sp

    vals = (
        graph.weights
        if (weighted and graph.weights is not None)
        else np.ones(graph.number_of_directed_edges, np.float32)
    )
    n = graph.number_of_nodes
    return sp.csr_matrix(
        (vals, graph.col_idx, graph.row_ptr), shape=(n, n)
    ).astype(np.float64)


def _similarity_matrix(graph: Graph, metric: str):
    import scipy.sparse as sp

    a = _adjacency(graph)
    n = graph.number_of_nodes
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    if metric == "Adjacency":
        return a
    if metric == "Laplacian":
        return sp.diags(deg) - a
    if metric in (
        "Left Normalized Laplacian",
        "Right Normalized Laplacian",
        "Symmetric Normalized Laplacian",
    ):
        rows, cols, vals = kernel_coo(graph, metric)
        return sp.csr_matrix((vals, (rows, cols)), shape=(n, n)).astype(
            np.float64
        )
    if metric == "Neighbours Intersection size":
        return (a @ a.T).tocsr()
    if metric == "Jaccard":
        inter = (a @ a.T).tocoo()
        union = deg[inter.row] + deg[inter.col] - inter.data
        data = inter.data / np.maximum(union, 1)
        return sp.csr_matrix((data, (inter.row, inter.col)), shape=(n, n))
    if metric == "Adamic-Adar":
        inv_log = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2)), 0.0)
        return (a @ sp.diags(inv_log) @ a.T).tocsr()
    if metric in DAG_METRICS:
        return _dag_similarity_matrix(graph, metric)
    raise ValueError(
        f"Unknown HOPE metric {metric!r}; available: {HOPE_METRICS}"
    )


@register_model
class HOPE(AbstractEmbeddingModel):
    """Truncated-SVD embedding of a node-similarity matrix: (source,
    destination) embeddings U√Σ and V√Σ."""

    def __init__(
        self,
        embedding_size: int = 100,
        metric: str = "Neighbours Intersection size",
        root_node_name: Optional[str] = None,
        enable_cache: bool = False,
        device="cuda",
    ):
        if metric not in HOPE_METRICS:
            raise ValueError(
                f"Unknown HOPE metric {metric!r}; available: {HOPE_METRICS}"
            )
        self._metric = metric
        # The DAG metrics read the ancestors from the arcs' closure, so the
        # root is implicit; a given root must be a node of the graph.
        self._root_node_name = root_node_name
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=None, device=device,
        )

    @classmethod
    def is_stochastic(cls) -> bool:
        return False

    @classmethod
    def model_name(cls) -> str:
        return "HOPE"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "metric": self._metric,
            "root_node_name": self._root_node_name,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        from scipy.sparse.linalg import svds

        if self._root_node_name is not None:
            if self._root_node_name not in graph.node_name_to_id:
                raise ValueError(
                    f"Root node {self._root_node_name!r} not in graph "
                    f"{graph.name}."
                )
        sim = _similarity_matrix(graph, self._metric)
        k = min(self.embedding_size, graph.number_of_nodes - 1)
        u, s, vt = svds(sim, k=k)
        order = np.argsort(-s)
        u, s, vt = u[:, order], s[order], vt[order]
        sqrt_s = np.sqrt(np.maximum(s, 0))
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[
                (u * sqrt_s).astype(np.float32),
                (vt.T * sqrt_s).astype(np.float32),
            ],
            node_names=graph.get_node_names(),
        )


@register_model
class LaplacianEigenmaps(AbstractEmbeddingModel):
    """Smallest non-trivial eigenvectors of the symmetric normalized
    Laplacian."""

    def __init__(self, embedding_size: int = 100, enable_cache: bool = False,
                 device="cuda"):
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=None, device=device,
        )

    @classmethod
    def is_stochastic(cls) -> bool:
        return False

    @classmethod
    def model_name(cls) -> str:
        return "Laplacian Eigenmaps"

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        import scipy.sparse as sp
        from scipy.sparse.linalg import eigsh

        rows, cols, vals = kernel_coo(graph, "Symmetric Normalized Laplacian")
        n = graph.number_of_nodes
        norm_adj = sp.csr_matrix((vals, (rows, cols)), shape=(n, n)).astype(
            np.float64
        )
        lap = sp.identity(n) - norm_adj
        k = min(self.embedding_size + 1, n - 1)
        vals_, vecs = eigsh(lap, k=k, which="SM")
        order = np.argsort(vals_)
        # drop the trivial (near-zero) first eigenvector
        emb = vecs[:, order[1: self.embedding_size + 1]]
        if emb.shape[1] < self.embedding_size:
            emb = np.pad(emb, ((0, 0), (0, self.embedding_size - emb.shape[1])))
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[emb.astype(np.float32)],
            node_names=graph.get_node_names(),
        )


@register_model
class GeometricLaplacianEigenmaps(AbstractEmbeddingModel):
    """GLEE: top eigenvectors of the unnormalized Laplacian L = D - A,
    scaled by the square roots of their eigenvalues."""

    def __init__(self, embedding_size: int = 100, enable_cache: bool = False,
                 device="cuda"):
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=None, device=device,
        )

    @classmethod
    def is_stochastic(cls) -> bool:
        return False

    @classmethod
    def model_name(cls) -> str:
        return "GLEE"

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        import scipy.sparse as sp
        from scipy.sparse.linalg import eigsh

        a = _adjacency(graph)
        deg = np.asarray(a.sum(axis=1)).reshape(-1)
        lap = sp.diags(deg) - a
        k = min(self.embedding_size, graph.number_of_nodes - 1)
        vals_, vecs = eigsh(lap, k=k, which="LM")
        order = np.argsort(-vals_)
        emb = vecs[:, order] * np.sqrt(np.maximum(vals_[order], 0))
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[emb.astype(np.float32)],
            node_names=graph.get_node_names(),
        )


@register_model
class SocioDim(AbstractEmbeddingModel):
    """Top eigenvectors of the modularity matrix B = A - d dᵀ / 2m, through
    a matrix-free operator, so B is never dense."""

    def __init__(self, embedding_size: int = 100, enable_cache: bool = False,
                 device="cuda"):
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=None, device=device,
        )

    @classmethod
    def is_stochastic(cls) -> bool:
        return False

    @classmethod
    def model_name(cls) -> str:
        return "SocioDim"

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 5}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        import scipy.sparse as sp
        from scipy.sparse.linalg import LinearOperator, eigsh

        a = _adjacency(graph)
        deg = np.asarray(a.sum(axis=1)).reshape(-1)
        two_m = max(deg.sum(), 1.0)
        n = graph.number_of_nodes

        def matvec(x):
            return a @ x - deg * (deg @ x) / two_m

        op = LinearOperator((n, n), matvec=matvec, dtype=np.float64)
        k = min(self.embedding_size, n - 2)
        vals_, vecs = eigsh(op, k=k, which="LA")
        order = np.argsort(-vals_)
        emb = vecs[:, order]
        if emb.shape[1] < self.embedding_size:
            emb = np.pad(emb, ((0, 0), (0, self.embedding_size - emb.shape[1])))
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[emb.astype(np.float32)],
            node_names=graph.get_node_names(),
        )
