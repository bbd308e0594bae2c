"""Holdouts — counterpart of `embiggen_tpu/graph/holdouts.py`: the edge
splits (`connected_holdout`, `random_holdout`, `edge_prediction_kfold`) and
the label splits (`node_label_holdout`, `node_label_kfold`,
`edge_label_holdout`, `edge_label_kfold`). Host numpy, with the same RNG
calls in the same order, so a seed gives the reference's split. The
spanning forest is the native union-find (`native.spanning_forest`). A
label split keeps the graph's topology and hides the labels of the other
side: node types become empty label sets, edge types -1."""
from __future__ import annotations

import dataclasses
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


# ------------------------------------------------------------------ node-label
def _node_label_split_graphs(graph: Graph, train_nodes_mask: np.ndarray) -> Tuple[Graph, Graph]:
    """(train, test): the graph with the node types of the masked nodes
    only, and with those of the other nodes only."""

    def masked(mask: np.ndarray, name: str) -> Graph:
        counts = np.diff(graph.node_type_ptr)
        new_ptr = np.concatenate([[0], np.cumsum(np.where(mask, counts, 0))]).astype(np.int64)
        return dataclasses.replace(
            graph, node_type_ptr=new_ptr,
            node_type_ids=graph.node_type_ids[np.repeat(mask, counts)],
            name=f"{graph.name}_{name}")

    return masked(train_nodes_mask, "train"), masked(~train_nodes_mask, "test")


def _stratified(graph: Graph, use_stratification: bool):
    """The groups of labelled nodes drawn apart: one per primary type when
    stratified (never on a multilabel graph), else all labelled nodes."""
    known = graph.get_known_node_types_mask()
    if use_stratification and not graph.has_multilabel_node_types():
        labels = graph.get_single_label_node_type_ids()
        return [np.nonzero(known & (labels == t))[0] for t in np.unique(labels[known])]
    return [np.nonzero(known)[0]]


def node_label_holdout(
    graph: Graph, train_size: float = 0.8, random_state: int = 42,
    use_stratification: bool = True,
) -> Tuple[Graph, Graph]:
    """(Stratified) Monte Carlo split of the labelled nodes: `train_size`
    of each group goes to train."""
    rng = np.random.default_rng(random_state)
    train_mask = np.zeros(graph.number_of_nodes, dtype=bool)
    for nodes in _stratified(graph, use_stratification):
        perm = rng.permutation(len(nodes))
        train_mask[nodes[perm[:int(round(train_size * len(nodes)))]]] = True
    return _node_label_split_graphs(graph, train_mask)


def node_label_kfold(
    graph: Graph, k: int, holdout_number: int, random_state: int = 42,
    use_stratification: bool = True,
) -> Tuple[Graph, Graph]:
    """(train, test) of fold `holdout_number` (mod k) of a seeded
    (stratified) k-fold split of the labelled nodes."""
    rng = np.random.default_rng(random_state)
    test_mask = np.zeros(graph.number_of_nodes, dtype=bool)
    for nodes in _stratified(graph, use_stratification):
        perm = rng.permutation(len(nodes))
        test_mask[nodes[np.array_split(perm, k)[holdout_number % k]]] = True
    return _node_label_split_graphs(graph, graph.get_known_node_types_mask() & ~test_mask)


# ------------------------------------------------------------------ edge-label
def _edge_label_split_graphs(graph: Graph, idx: np.ndarray, train: np.ndarray,
                             test: np.ndarray) -> Tuple[Graph, Graph]:
    """(train, test): the graph with the edge types of the canonical edges
    `idx[train]` only (and their reverse arcs on an undirected graph), -1
    elsewhere; the same for `test`."""

    def masked(mask_canon: np.ndarray, name: str) -> Graph:
        new_types = np.full(graph.number_of_directed_edges, -1, dtype=np.int32)
        sel = idx[mask_canon]
        new_types[sel] = graph.edge_types[sel]
        if not graph.directed:
            rev = graph.get_edge_ids(graph.col_idx[sel], graph.sources[sel])
            ok = rev >= 0
            new_types[rev[ok]] = graph.edge_types[sel][ok]
        return dataclasses.replace(graph, edge_types=new_types, name=f"{graph.name}_{name}")

    return masked(train, "train"), masked(test, "test")


def _known_canonical_types(graph: Graph) -> Tuple[np.ndarray, np.ndarray]:
    if graph.edge_types is None:
        raise ValueError("Graph has no edge types to split.")
    _, _, idx = _canonical_edges(graph)
    return idx, graph.edge_types[idx]


def edge_label_holdout(
    graph: Graph, train_size: float = 0.8, random_state: int = 42,
    use_stratification: bool = True,
) -> Tuple[Graph, Graph]:
    """(Stratified) Monte Carlo split of the typed edges: `train_size` of
    each edge type (of all typed edges, unstratified) keeps its type in
    train, the rest in test."""
    idx, etypes = _known_canonical_types(graph)
    known = etypes >= 0
    rng = np.random.default_rng(random_state)
    train_edge = np.zeros(len(idx), dtype=bool)
    groups = ([np.nonzero(known & (etypes == t))[0] for t in np.unique(etypes[known])]
              if use_stratification else [np.nonzero(known)[0]])
    for edges in groups:
        perm = rng.permutation(len(edges))
        train_edge[edges[perm[:int(round(train_size * len(edges)))]]] = True
    return _edge_label_split_graphs(graph, idx, train_edge, ~train_edge)


def edge_label_kfold(
    graph: Graph, k: int, holdout_number: int, random_state: int = 42,
) -> Tuple[Graph, Graph]:
    """(train, test) of fold `holdout_number` (mod k) of a seeded k-fold
    split of the typed edges."""
    idx, etypes = _known_canonical_types(graph)
    known = np.nonzero(etypes >= 0)[0]
    perm = np.random.default_rng(random_state).permutation(len(known))
    test = np.zeros(len(idx), dtype=bool)
    test[known[np.array_split(perm, k)[holdout_number % k]]] = True
    train = np.zeros(len(idx), dtype=bool)
    train[known] = True
    return _edge_label_split_graphs(graph, idx, train & ~test, test)
