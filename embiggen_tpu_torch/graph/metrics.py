"""Per-edge topological heuristics and node counts on the host —
counterpart of `embiggen_tpu/graph/metrics.py`, in numpy and scipy:
Adamic-Adar, Jaccard coefficient, resource allocation and preferential
attachment of (src, dst) pairs (exact: no cap on the expanded row), the
triangles and 4-cycles through each node, and the closeness and harmonic
centralities approximated from a sample of sources.

`edge_metrics` is the plain version of K8 (`ops/edge_metrics.py`) at a cap
that covers the largest degree: the sklearn adapters' metric columns come
from it on the CPU and from K8 on the card.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .graph import Graph

EDGE_METRIC_NAMES = [
    "AdamicAdar",
    "JaccardCoefficient",
    "ResourceAllocationIndex",
    "PreferentialAttachment",
]


def _neighbour_intersections(
    graph: Graph, src: np.ndarray, dst: np.ndarray
) -> Dict[str, np.ndarray]:
    """For each query pair, reduce over common neighbours — fully vectorized:
    expand the lower-degree endpoint's neighbour list per pair, test
    membership in the other endpoint's row with one batched searchsorted over
    the sorted arc keys, then bincount-reduce per pair. O(sum min-degree ·
    log E) total, no per-pair Python loop."""
    deg = graph.degrees.astype(np.float64)
    inv_log_deg = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2)), 0.0)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)

    n_q = len(src)
    if n_q == 0:
        z = np.zeros(0)
        return {"intersection": z, "adamic_adar": z, "resource_allocation": z}
    degs = graph.degrees
    # Intersection is symmetric: expand the cheaper endpoint.
    swap = degs[dst] < degs[src]
    a = np.where(swap, dst, src)
    b = np.where(swap, src, dst)
    counts = degs[a].astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(n_q)
        return {"intersection": z, "adamic_adar": z, "resource_allocation": z}
    pair_of = np.repeat(np.arange(n_q, dtype=np.int64), counts)
    # Global CSR index of every expanded neighbour slot.
    starts = graph.row_ptr[a]
    ends = np.cumsum(counts)
    local = np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)
    cand = graph.col_idx[np.repeat(starts, counts) + local]
    member = graph.has_edges(np.repeat(b, counts), cand)
    cm = cand[member]
    pm = pair_of[member]
    inter = np.bincount(pm, minlength=n_q).astype(np.float64)
    aa = np.bincount(pm, weights=inv_log_deg[cm], minlength=n_q)
    ra = np.bincount(pm, weights=inv_deg[cm], minlength=n_q)
    return {"intersection": inter, "adamic_adar": aa, "resource_allocation": ra}


def edge_metrics(
    graph: Graph, src: np.ndarray, dst: np.ndarray
) -> np.ndarray:
    """[B, 4] float32: Adamic-Adar, Jaccard, Resource Allocation, Preferential
    Attachment for each (src, dst) pair."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    parts = _neighbour_intersections(graph, src, dst)
    deg = graph.degrees.astype(np.float64)
    union = deg[src] + deg[dst] - parts["intersection"]
    jaccard = np.where(union > 0, parts["intersection"] / np.maximum(union, 1), 0.0)
    pa = deg[src] * deg[dst]
    return np.stack(
        [parts["adamic_adar"], jaccard, parts["resource_allocation"], pa], axis=1
    ).astype(np.float32)


def all_edge_metrics(graph: Graph) -> np.ndarray:
    """[E, 4] metrics for every arc of the graph."""
    return edge_metrics(graph, graph.sources, graph.col_idx)


def _sparse_adjacency(graph: Graph):
    import scipy.sparse as sp

    n = graph.number_of_nodes
    a = sp.csr_matrix(
        (
            np.ones(graph.number_of_directed_edges, np.float64),
            graph.col_idx,
            graph.row_ptr,
        ),
        shape=(n, n),
    )
    a.data[:] = 1.0  # collapse multi-arcs
    return a


def triangle_counts(graph: Graph) -> np.ndarray:
    """Triangles through each node: diag(A³)/2 computed as the row-sum of
    (A·A)∘A (reference visualizer `plot_node_triangles`,
    `graph_visualizer.py:3770`, backed by an ensmallen kernel)."""
    a = _sparse_adjacency(graph)
    return np.asarray((a @ a).multiply(a).sum(axis=1)).reshape(-1) / 2.0


def square_counts(graph: Graph) -> np.ndarray:
    """4-cycles through each node: with P2 = (A·A) the length-2 path counts,
    squares(v) = Σ_{w≠v} C(P2[v,w], 2) — each 4-cycle v-x-w-y is counted
    exactly once, at its unique opposite corner w, via the unordered {x, y}
    pair (reference `plot_node_squares`, `graph_visualizer.py:3862`).
    Verified against brute-force enumeration on karate club."""
    a = _sparse_adjacency(graph)
    p2 = (a @ a).tocoo()
    off = p2.row != p2.col
    vals = p2.data[off]
    contrib = vals * (vals - 1) / 2.0
    return np.bincount(
        p2.row[off], weights=contrib, minlength=graph.number_of_nodes
    )


def _sampled_distances(graph: Graph, n_sources: int, random_state: int):
    import scipy.sparse.csgraph as csgraph

    rng = np.random.default_rng(random_state)
    n = graph.number_of_nodes
    sources = (
        rng.choice(n, size=n_sources, replace=False) if n > n_sources
        else np.arange(n)
    )
    dist = csgraph.shortest_path(
        _sparse_adjacency(graph), method="D", unweighted=True,
        indices=sources,
    )
    return dist  # [S, N], inf where unreachable


def approximated_closeness_centrality(
    graph: Graph, n_sources: int = 100, random_state: int = 42
) -> np.ndarray:
    """Closeness ≈ (reachable sources) / Σ d(s, v) over a random source
    sample (reference `plot_approximated_closeness_centrality`,
    `graph_visualizer.py:3954`)."""
    dist = _sampled_distances(graph, n_sources, random_state)
    finite = np.isfinite(dist) & (dist > 0)
    tot = np.where(finite, dist, 0.0).sum(axis=0)
    cnt = finite.sum(axis=0)
    return np.where(tot > 0, cnt / np.maximum(tot, 1e-12), 0.0)


def approximated_harmonic_centrality(
    graph: Graph, n_sources: int = 100, random_state: int = 42
) -> np.ndarray:
    """Harmonic ≈ Σ 1/d(s, v) over a random source sample (reference
    `plot_approximated_harmonic_centrality`, `graph_visualizer.py:4046`)."""
    dist = _sampled_distances(graph, n_sources, random_state)
    finite = np.isfinite(dist) & (dist > 0)
    return np.where(finite, 1.0 / np.maximum(dist, 1e-12), 0.0).sum(axis=0)
