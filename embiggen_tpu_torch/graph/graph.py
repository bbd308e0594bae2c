"""Immutable CSR graph container and its device export — the counterpart of
`embiggen_tpu/graph/graph.py`, cut to what SkipGram training and the edge
predictors use.

The host side is numpy, as in the JAX package: `Graph.from_edge_arrays`
symmetrizes, sorts and deduplicates arcs into a CSR. `Graph.device(device)`
exports a `TorchGraph` of tensors on an explicit device — the counterpart of
`DeviceGraph` — for the sampling kernels.

Undirected graphs store both arcs, so `number_of_directed_edges` counts arcs.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TorchGraph:
    """CSR arrays of a Graph as tensors on one device."""

    row_ptr: torch.Tensor                # [N+1] int32
    col_idx: torch.Tensor                # [E] int32, sorted within each row
    degrees: torch.Tensor                # [N] int32
    weights: Optional[torch.Tensor]      # [E] f32 or None
    # Walker alias tables for O(1) weighted neighbour draws, aligned with
    # col_idx; alias_idx holds offsets inside the row.
    alias_prob: Optional[torch.Tensor]   # [E] f32
    alias_idx: Optional[torch.Tensor]    # [E] int32
    n_nodes: int
    n_arcs: int
    max_degree: int = 0
    # [E] int32 source of each arc, for arc-id -> (src, dst) lookups;
    # exported by `Graph.device(with_sources=True)`.
    sources: Optional[torch.Tensor] = None
    # The capped ELLPACK adjacency of the p/q walk kernel K9, exported by
    # `Graph.device(ell_cap=...)`: [N, ell_cap] int32 neighbours, -1 padded,
    # and their weights [N, ell_cap] f32 on weighted graphs (0 padded).
    ell_cols: Optional[torch.Tensor] = None
    ell_w: Optional[torch.Tensor] = None
    ell_cap: int = 0

    @property
    def device(self) -> torch.device:
        return self.col_idx.device


def _as_names(names: Optional[Sequence[str]], count: int, prefix: str) -> np.ndarray:
    if names is None:
        return np.asarray([f"{prefix}{i}" for i in range(count)], dtype=object)
    arr = np.asarray(names, dtype=object)
    if arr.shape[0] != count:
        raise ValueError(f"Expected {count} {prefix} names, got {arr.shape[0]}")
    return arr


def build_alias_tables(
    row_ptr: np.ndarray, weights: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables for every node's neighbour distribution at once.
    Returns (prob, alias) aligned with col_idx; alias holds offsets inside
    the row. Rows with uniform weights resolve vectorized; only rows with
    truly non-uniform weights run the two-stack pairing loop."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    n_edges = weights.shape[0]
    prob = np.ones(n_edges, dtype=np.float32)
    degrees = np.diff(row_ptr)
    row_of_edge = np.repeat(np.arange(len(degrees)), degrees)
    row_sums = np.zeros(len(degrees), dtype=np.float64)
    np.add.at(row_sums, row_of_edge, weights.astype(np.float64))
    safe = np.where(row_sums == 0, 1.0, row_sums)
    scaled = weights.astype(np.float64) * degrees[row_of_edge] / safe[row_of_edge]

    # Identity alias per edge (offsets inside the row): right for uniform rows.
    alias = (
        np.arange(n_edges, dtype=np.int64) - np.repeat(row_ptr[:-1], degrees)
    ).astype(np.int32)

    non_uniform_edges = np.abs(scaled - 1.0) > 1e-9
    for r in np.unique(row_of_edge[non_uniform_edges]):
        s, e = row_ptr[r], row_ptr[r + 1]
        p = scaled[s:e].copy()
        pr = prob[s:e]
        al = alias[s:e]
        small = [i for i in range(e - s) if p[i] < 1.0]
        large = [i for i in range(e - s) if p[i] >= 1.0]
        while small and large:
            sm = small.pop()
            lg = large.pop()
            pr[sm] = p[sm]
            al[sm] = lg
            p[lg] = p[lg] - (1.0 - p[sm])
            (small if p[lg] < 1.0 else large).append(lg)
        for i in large + small:
            pr[i] = 1.0
            al[i] = i
    return prob, alias


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable graph: CSR adjacency, optional weights, names. Edge and node
    types come with typed walks (ROADMAP A6)."""

    row_ptr: np.ndarray                      # [N+1] int64
    col_idx: np.ndarray                      # [E] int32, sorted per row
    directed: bool = True
    name: str = "Graph"
    weights: Optional[np.ndarray] = None     # [E] f32
    node_names: Optional[np.ndarray] = None

    @property
    def number_of_nodes(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    @property
    def number_of_directed_edges(self) -> int:
        return int(self.col_idx.shape[0])

    @cached_property
    def sources(self) -> np.ndarray:
        """[E] source node of each arc (CSR row expansion)."""
        return np.repeat(
            np.arange(self.number_of_nodes, dtype=self.col_idx.dtype), self.degrees
        )

    @property
    def number_of_edges(self) -> int:
        """Edges: arcs for a directed graph, arc pairs plus self-loops for an
        undirected one."""
        if self.directed:
            return self.number_of_directed_edges
        n_self = int(np.sum(self.sources == self.col_idx))
        return (self.number_of_directed_edges - n_self) // 2 + n_self

    @cached_property
    def arcs_fingerprint(self) -> str:
        """Content hash of the adjacency and weights: the cache key of
        layouts derived from the arcs (GCN kernels, negative graphs), so two
        graph objects with the same arcs share them."""
        import hashlib

        h = hashlib.sha1()
        h.update(np.int64(self.number_of_nodes).tobytes())
        h.update(np.ascontiguousarray(self.row_ptr).tobytes())
        h.update(np.ascontiguousarray(self.col_idx).tobytes())
        if self.weights is not None:
            h.update(np.ascontiguousarray(self.weights).tobytes())
        return h.hexdigest()

    @cached_property
    def _sorted_arc_keys(self) -> np.ndarray:
        # CSR rows are in order and sorted inside, so src * N + dst is sorted.
        return (self.sources.astype(np.int64) * self.number_of_nodes
                + self.col_idx.astype(np.int64))

    def has_edges(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Vectorized membership test of (src[i], dst[i]) by binary search
        over the sorted arc keys."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        if self.number_of_directed_edges == 0:
            return np.zeros(len(src), dtype=bool)
        q = src.astype(np.int64) * self.number_of_nodes + dst.astype(np.int64)
        keys = self._sorted_arc_keys
        idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return keys[idx] == q

    has_edges_fast = has_edges

    def is_multigraph(self) -> bool:
        keys = self._sorted_arc_keys
        return bool(len(keys) > 1 and np.any(np.diff(keys) == 0))

    def has_singleton_nodes(self) -> bool:
        return bool(np.any(self.degrees == 0))

    def get_number_of_singleton_nodes(self) -> int:
        return int(np.sum(self.degrees == 0))

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def has_edge_weights(self) -> bool:
        return self.weights is not None

    def get_node_names(self) -> np.ndarray:
        return _as_names(self.node_names, self.number_of_nodes, "node_")

    @cached_property
    def node_name_to_id(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.get_node_names())}

    def get_node_ids_from_names(self, names: Sequence[str]) -> np.ndarray:
        m = self.node_name_to_id
        return np.asarray([m[n] for n in names], dtype=np.int32)

    def get_node_ids_from_prefixes(self, prefixes: Sequence[str]) -> np.ndarray:
        """Ids of the nodes whose name starts with any of `prefixes`."""
        if isinstance(prefixes, str):
            prefixes = [prefixes]
        names = self.get_node_names().astype(str)
        mask = np.zeros(self.number_of_nodes, dtype=bool)
        for p in prefixes:
            mask |= np.char.startswith(names, p)
        return np.nonzero(mask)[0].astype(np.int32)

    def filter_edges(self, keep_mask: np.ndarray, name: Optional[str] = None) -> "Graph":
        """The graph on the same nodes with only the arcs where `keep_mask`."""
        return Graph.from_edge_arrays(
            self.sources[keep_mask],
            self.col_idx[keep_mask],
            n_nodes=self.number_of_nodes,
            weights=None if self.weights is None else self.weights[keep_mask],
            directed=True,
            directed_flag=self.directed,
            name=name or self.name,
            node_names=self.node_names,
        )

    def __and__(self, other: "Graph") -> "Graph":
        """The arcs of this graph that are also arcs of `other`, whose node
        ids must be this graph's."""
        mask = other.has_edges(self.sources, self.col_idx)
        return self.filter_edges(mask, name=f"{self.name}&{other.name}")

    @staticmethod
    def from_edge_arrays(
        src: np.ndarray,
        dst: np.ndarray,
        n_nodes: Optional[int] = None,
        weights: Optional[np.ndarray] = None,
        directed: bool = False,
        name: str = "Graph",
        node_names: Optional[Sequence[str]] = None,
        directed_flag: Optional[bool] = None,
    ) -> "Graph":
        """Build the CSR from (src, dst[, weights]) arc arrays.

        If directed=False, arcs are symmetrized. Arcs sort by the key
        src * N + dst; a duplicate arc keeps the attributes of its first
        occurrence. `directed_flag`, when given, is the stored
        directedness in place of `directed` (for arcs that are already
        symmetrized)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if n_nodes is None:
            n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        if not directed:
            non_loop = src != dst
            src, dst = (np.concatenate([src, dst[non_loop]]),
                        np.concatenate([dst, src[non_loop]]))
            if weights is not None:
                weights = np.concatenate([weights, weights[non_loop]])
        keys, order = np.unique(src * n_nodes + dst, return_index=True)
        src = keys // max(n_nodes, 1)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32)[order]
        counts = np.bincount(src, minlength=n_nodes)
        return Graph(
            row_ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
            col_idx=(keys - src * n_nodes).astype(np.int32),
            directed=directed if directed_flag is None else directed_flag,
            name=name,
            weights=weights,
            node_names=(None if node_names is None
                        else np.asarray(node_names, dtype=object)),
        )

    def device(
        self,
        device: Union[str, torch.device],
        with_alias: bool = False,
        with_sources: bool = False,
        ell_cap: Optional[int] = None,
        ell_seed: int = 0,
    ) -> TorchGraph:
        """Export the CSR as a TorchGraph on `device`, with alias tables when
        `with_alias` and the graph is weighted, each arc's source when
        `with_sources`, and the capped ELLPACK adjacency when `ell_cap` is
        given (`ell_arrays`)."""
        device = torch.device(device)
        if self.number_of_directed_edges >= 2**31:
            raise ValueError("The kernels index arcs with int32; this graph "
                             f"has {self.number_of_directed_edges} arcs.")

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        alias_prob = alias_idx = None
        if with_alias and self.weights is not None:
            prob, alias = build_alias_tables(self.row_ptr, self.weights)
            alias_prob, alias_idx = put(prob, np.float32), put(alias, np.int32)
        ecols, ew, cap = self.ell_arrays(ell_cap, ell_seed)
        return TorchGraph(
            row_ptr=put(self.row_ptr, np.int32),
            col_idx=put(self.col_idx, np.int32),
            degrees=put(self.degrees, np.int32),
            weights=None if self.weights is None else put(self.weights, np.float32),
            alias_prob=alias_prob,
            alias_idx=alias_idx,
            n_nodes=self.number_of_nodes,
            n_arcs=self.number_of_directed_edges,
            max_degree=int(self.degrees.max(initial=0)),
            sources=put(self.sources, np.int32) if with_sources else None,
            ell_cols=None if ecols is None else put(ecols, np.int32),
            ell_w=None if ew is None else put(ew, np.float32),
            ell_cap=cap,
        )

    def ell_arrays(
        self, ell_cap: Optional[int], ell_seed: int = 0
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
        """(ell_cols [N, cap] int32 -1 padded, ell_w [N, cap] f32 or None,
        cap) with cap = min(ell_cap, max degree); (None, None, 0) when
        `ell_cap` is None or not positive. A row of at most cap neighbours
        keeps its CSR order; a longer row holds a seeded uniform subsample
        of its neighbours in random order (the first cap of a random
        within-row order), so that a capped walk can reach every neighbour
        of a hub. The same arrays, byte for byte, as the JAX package's
        `Graph.device(ell_cap=..., ell_seed=...)`."""
        if ell_cap is None or ell_cap <= 0:
            return None, None, 0
        cap = int(min(ell_cap, max(int(self.degrees.max(initial=1)), 1)))
        n = self.number_of_nodes
        degrees = self.degrees.astype(np.int64)
        row_start = self.row_ptr[:-1].astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), degrees)
        pos = np.arange(rows.shape[0], dtype=np.int64) - row_start[rows]
        over = degrees > cap
        if over.any():
            sub = over[rows]
            rng = np.random.default_rng(ell_seed)
            order = np.lexsort((rng.random(int(sub.sum())), rows[sub]))
            ranks = np.empty(order.shape[0], dtype=np.int64)
            sub_rows = rows[sub][order]
            starts = np.concatenate(
                [[0], np.flatnonzero(sub_rows[1:] != sub_rows[:-1]) + 1])
            ranks[order] = (np.arange(order.shape[0], dtype=np.int64)
                            - np.repeat(starts, np.diff(np.concatenate(
                                [starts, [order.shape[0]]]))))
            pos = pos.copy()
            pos[sub] = ranks
        keep = pos < cap
        ecols = np.full((n, cap), -1, np.int32)
        ecols[rows[keep], pos[keep]] = self.col_idx[keep]
        ew = None
        if self.weights is not None:
            ew = np.zeros((n, cap), np.float32)
            ew[rows[keep], pos[keep]] = self.weights[keep]
        return ecols, ew, cap

    def __repr__(self) -> str:
        return (
            f"Graph(name={self.name!r}, nodes={self.number_of_nodes}, "
            f"arcs={self.number_of_directed_edges}, directed={self.directed}, "
            f"weighted={self.has_edge_weights})"
        )
