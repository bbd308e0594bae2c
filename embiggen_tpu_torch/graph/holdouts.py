"""Edge holdouts — counterpart of `embiggen_tpu/graph/holdouts.py`
(`connected_holdout`, `random_holdout`, `edge_prediction_kfold`). Host
numpy, with the same RNG calls in the same order, so a seed gives the
reference's split. The spanning forest is the native union-find
(`native.spanning_forest`); the label splits come with ROADMAP A10."""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from .. import native
from .graph import Graph


def _canonical_edges(graph: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, arc index) of one arc per edge: src <= dst on an
    undirected graph, every arc on a directed one."""
    if graph.directed:
        idx = np.arange(graph.number_of_directed_edges)
        return graph.sources, graph.col_idx, idx
    idx = np.nonzero(graph.sources <= graph.col_idx)[0]
    return graph.sources[idx], graph.col_idx[idx], idx


def _subgraph_from_canonical(graph: Graph, keep: np.ndarray, name: str) -> Graph:
    """The graph of the canonical edges selected by the mask `keep`."""
    _, _, idx = _canonical_edges(graph)
    sel = idx[keep]
    return Graph.from_edge_arrays(
        graph.sources[sel],
        graph.col_idx[sel],
        n_nodes=graph.number_of_nodes,
        weights=None if graph.weights is None else graph.weights[sel],
        edge_types=None if graph.edge_types is None else graph.edge_types[sel],
        directed=graph.directed,
        name=name,
        node_names=graph.node_names,
        edge_type_names=graph.edge_type_names,
        node_type_ptr=graph.node_type_ptr,
        node_type_ids=graph.node_type_ids,
        node_type_names=graph.node_type_names,
    )


def spanning_forest_arcs(graph: Graph, random_state: int = 42) -> np.ndarray:
    """Random spanning forest by union-find over the canonical edges in a
    seeded random order. Returns a mask over canonical edges: True for the
    forest's edges."""
    src, dst, _ = _canonical_edges(graph)
    order = np.random.default_rng(random_state).permutation(len(src))
    return native.spanning_forest(src, dst, order, graph.number_of_nodes)


def connected_holdout(
    graph: Graph, train_size: float = 0.8, random_state: int = 42,
) -> Tuple[Graph, Graph]:
    """(train, test) split of the edges in which train keeps the connected
    components of `graph`: a random spanning forest goes to train, then
    shuffled other edges until `train_size` of the edges are in train."""
    src, _, _ = _canonical_edges(graph)
    forest = spanning_forest_arcs(graph, random_state)
    n_train_target = int(round(train_size * len(src)))
    n_forest = int(forest.sum())
    if n_forest > n_train_target:
        warnings.warn(
            f"Spanning forest has {n_forest} edges > train target "
            f"{n_train_target}; train split will be larger than requested."
        )
    rng = np.random.default_rng(random_state)
    rest = np.nonzero(~forest)[0]
    rng.shuffle(rest)
    train_mask = forest.copy()
    train_mask[rest[:max(0, n_train_target - n_forest)]] = True
    return (
        _subgraph_from_canonical(graph, train_mask, f"{graph.name}_train"),
        _subgraph_from_canonical(graph, ~train_mask, f"{graph.name}_test"),
    )


def random_holdout(
    graph: Graph, train_size: float = 0.8, random_state: int = 42
) -> Tuple[Graph, Graph]:
    """Uniform Monte Carlo split of the edges."""
    src, _, _ = _canonical_edges(graph)
    perm = np.random.default_rng(random_state).permutation(len(src))
    train_mask = np.zeros(len(src), dtype=bool)
    train_mask[perm[:int(round(train_size * len(src)))]] = True
    return (
        _subgraph_from_canonical(graph, train_mask, f"{graph.name}_train"),
        _subgraph_from_canonical(graph, ~train_mask, f"{graph.name}_test"),
    )


def edge_prediction_kfold(
    graph: Graph, k: int, holdout_number: int, random_state: int = 42
) -> Tuple[Graph, Graph]:
    """(train, test) of fold `holdout_number` (mod k) of a seeded k-fold
    split of the edges: that fold is the test graph."""
    src, _, _ = _canonical_edges(graph)
    perm = np.random.default_rng(random_state).permutation(len(src))
    test_mask = np.zeros(len(src), dtype=bool)
    test_mask[np.array_split(perm, k)[holdout_number % k]] = True
    return (
        _subgraph_from_canonical(graph, ~test_mask, f"{graph.name}_train"),
        _subgraph_from_canonical(graph, test_mask, f"{graph.name}_test"),
    )
