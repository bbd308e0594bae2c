"""Immutable CSR graph container and its device export — the counterpart of
`embiggen_tpu/graph/graph.py`.

The host side is numpy and the port's native helpers (`native`), as in the
JAX package: `Graph.from_edge_arrays` symmetrizes, sorts and deduplicates
arcs into a CSR. `Graph.device(device)` exports a `TorchGraph` of tensors on
an explicit device — the counterpart of `DeviceGraph` — for the sampling
kernels.

Undirected graphs store both arcs, so `number_of_directed_edges` counts arcs.
`ReferenceGraphAPI` (`compat.py`) adds the reference's method names.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import native
from ..ops.rowplan import RowPlan, row_plan


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
    # [E, 4] int32 record of each arc for the first-order walk kernels: its
    # head, the head's row start and degree, and 0; exported by
    # `Graph.device(with_walk_arcs=True)` when no alias tables are.
    walk_arcs: Optional[torch.Tensor] = None
    # [E, 2] int32 (source, head) of each arc, so the edge batch (K6) reads a
    # positive's ends in one load; exported by `Graph.device(with_arc_pairs=
    # True)`.
    arc_pairs: Optional[torch.Tensor] = None
    # The capped ELLPACK adjacency of the p/q walk kernel K9, exported by
    # `Graph.device(ell_cap=...)`: [N, ell_cap] int32 neighbours, -1 padded,
    # and their weights [N, ell_cap] f32 on weighted graphs (0 padded).
    ell_cols: Optional[torch.Tensor] = None
    ell_w: Optional[torch.Tensor] = None
    ell_cap: int = 0
    # [E] int32 edge type of each arc, aligned with col_idx; exported by
    # `Graph.device` when the graph has edge types.
    edge_types: Optional[torch.Tensor] = None
    # The typed walks' tables, exported by `Graph.device(with_walk_types=
    # True)`: each node's primary node type [N] int32 (-1 unknown) when the
    # graph has node types, and with an ELL table the node type of each
    # slot's neighbour and the edge type of each slot's arc [N, ell_cap]
    # int32 (-1 padded).
    node_type_of: Optional[torch.Tensor] = None
    ell_ntypes: Optional[torch.Tensor] = None
    ell_etypes: Optional[torch.Tensor] = None
    # Row plans of this export by split (`row_plan`), built at first use; a
    # `dataclasses.replace` of the export starts without them.
    _row_plans: Dict[int, RowPlan] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.col_idx.device

    def row_plan(self, split: int) -> RowPlan:
        """The rows of more than `split` arcs cut into chunks
        (`ops.rowplan.row_plan`), on this export's device; built once per
        export and split."""
        if split not in self._row_plans:
            self._row_plans[split] = row_plan(self.row_ptr, split)
        return self._row_plans[split]


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
    """Walker alias tables for every node's neighbour distribution at once,
    built by the native helpers (`native.alias_tables`). Returns (prob,
    alias) aligned with col_idx; alias holds offsets inside the row."""
    return native.alias_tables(row_ptr, weights)


from .compat import ReferenceGraphAPI  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Graph(ReferenceGraphAPI):
    """Immutable graph: CSR adjacency, optional weights, optional edge types,
    optional (multilabel) node types, names."""

    row_ptr: np.ndarray                      # [N+1] int64
    col_idx: np.ndarray                      # [E] int32, sorted per row
    directed: bool = True
    name: str = "Graph"
    weights: Optional[np.ndarray] = None     # [E] f32
    node_names: Optional[np.ndarray] = None
    edge_types: Optional[np.ndarray] = None  # [E] int32, aligned with col_idx
    edge_type_names: Optional[np.ndarray] = None
    # Node types as a CSR of type ids per node: node i's types are
    # node_type_ids[node_type_ptr[i]:node_type_ptr[i + 1]], its first one
    # its primary type; a node with none has an unknown type.
    node_type_ptr: Optional[np.ndarray] = None   # [N+1]
    node_type_ids: Optional[np.ndarray] = None   # [sum of labels]
    node_type_names: Optional[np.ndarray] = None

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

    @property
    def destinations(self) -> np.ndarray:
        return self.col_idx

    @property
    def density(self) -> float:
        """Arcs over N (N - 1); 0 below two nodes."""
        n = self.number_of_nodes
        if n < 2:
            return 0.0
        return self.number_of_directed_edges / (n * (n - 1))

    def neighbors(self, node: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[node]: self.row_ptr[node + 1]]

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
        """Vectorized membership test of (src[i], dst[i])."""
        return self.get_edge_ids(src, dst) >= 0

    has_edges_fast = has_edges

    def get_edge_ids(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Arc index (CSR order) of each (src[i], dst[i]), -1 where there
        is no such arc, by binary search over the sorted arc keys."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        keys = self._sorted_arc_keys
        if len(keys) == 0:
            return np.full(len(src), -1, dtype=np.int64)
        q = src.astype(np.int64) * self.number_of_nodes + dst.astype(np.int64)
        idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return np.where(keys[idx] == q, idx, -1)

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def has_edge_weights(self) -> bool:
        return self.weights is not None

    @property
    def has_node_types(self) -> bool:
        return self.node_type_ids is not None

    @property
    def has_edge_types(self) -> bool:
        return self.edge_types is not None

    @property
    def number_of_edge_types(self) -> int:
        """The largest edge type id plus one; 0 without edge types."""
        if self.edge_types is None or len(self.edge_types) == 0:
            return 0
        return int(self.edge_types.max()) + 1

    def get_edge_type_names(self) -> Optional[np.ndarray]:
        if self.edge_types is None:
            return None
        return _as_names(self.edge_type_names, self.number_of_edge_types, "edge_type_")

    def get_node_names(self) -> np.ndarray:
        return _as_names(self.node_names, self.number_of_nodes, "node_")

    # ------------------------------------------------------------ node types
    @property
    def number_of_node_types(self) -> int:
        """The largest node type id plus one; 0 without node types."""
        if self.node_type_ids is None or len(self.node_type_ids) == 0:
            return 0
        return int(self.node_type_ids.max()) + 1

    def get_node_type_names(self) -> Optional[np.ndarray]:
        if self.node_type_ids is None:
            return None
        return _as_names(self.node_type_names, self.number_of_node_types, "node_type_")

    def has_multilabel_node_types(self) -> bool:
        if self.node_type_ptr is None:
            return False
        return bool(np.any(np.diff(self.node_type_ptr) > 1))

    def get_maximum_multilabel_count(self) -> int:
        if self.node_type_ptr is None:
            return 0
        return int(np.max(np.diff(self.node_type_ptr), initial=0))

    def get_one_hot_encoded_node_types(self) -> np.ndarray:
        """[N, n_node_types] float32: 1 where the node has the type."""
        n, t = self.number_of_nodes, self.number_of_node_types
        out = np.zeros((n, t), dtype=np.float32)
        if t == 0:
            return out
        rows = np.repeat(np.arange(n), np.diff(self.node_type_ptr))
        out[rows, self.node_type_ids] = 1.0
        return out

    def get_single_label_node_type_ids(self) -> np.ndarray:
        """[N] int32 primary (first) node type of each node, -1 where the
        node has none or the graph has no node types."""
        out = np.full(self.number_of_nodes, -1, dtype=np.int32)
        if self.node_type_ptr is None:
            return out
        has = np.diff(self.node_type_ptr) > 0
        out[has] = self.node_type_ids[self.node_type_ptr[:-1][has]]
        return out

    def get_known_node_types_mask(self) -> np.ndarray:
        if self.node_type_ptr is None:
            return np.zeros(self.number_of_nodes, dtype=bool)
        return np.diff(self.node_type_ptr) > 0

    def get_known_edge_types_mask(self) -> np.ndarray:
        """[arcs] bool: True where the arc's type is known (not -1)."""
        if self.edge_types is None:
            return np.zeros(self.number_of_directed_edges, dtype=bool)
        return self.edge_types >= 0

    def get_node_ids_from_node_type_names(self, type_names: Sequence[str]) -> np.ndarray:
        """Ids of the nodes that have at least one of the named types."""
        if isinstance(type_names, str):
            type_names = [type_names]
        if self.node_type_ptr is None:
            raise ValueError(f"Graph {self.name} has no node types.")
        all_names = list(self.get_node_type_names())
        wanted = set()
        for t in type_names:
            if t not in all_names:
                raise ValueError(f"Unknown node type {t!r}; available: {all_names}")
            wanted.add(all_names.index(t))
        rows = np.repeat(np.arange(self.number_of_nodes), np.diff(self.node_type_ptr))
        mask = np.zeros(self.number_of_nodes, dtype=bool)
        mask[rows[np.isin(self.node_type_ids, list(wanted))]] = True
        return np.nonzero(mask)[0].astype(np.int32)

    def is_sorted_by_decreasing_outbound_node_degree(self) -> bool:
        d = self.degrees
        return bool(np.all(d[:-1] >= d[1:]))

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
            edge_types=None if self.edge_types is None else self.edge_types[keep_mask],
            directed=True,
            directed_flag=self.directed,
            name=name or self.name,
            node_names=self.node_names,
            edge_type_names=self.edge_type_names,
            node_type_ptr=self.node_type_ptr,
            node_type_ids=self.node_type_ids,
            node_type_names=self.node_type_names,
        )

    def intersection(self, other: "Graph") -> "Graph":
        """The arcs of this graph that are also arcs of `other`, whose node
        ids must be this graph's."""
        mask = other.has_edges(self.sources, self.col_idx)
        return self.filter_edges(mask, name=f"{self.name}&{other.name}")

    def __and__(self, other: "Graph") -> "Graph":
        return self.intersection(other)

    def difference(self, other: "Graph") -> "Graph":
        """The arcs of this graph that are not arcs of `other`."""
        mask = ~other.has_edges(self.sources, self.col_idx)
        return self.filter_edges(mask, name=f"{self.name}-{other.name}")

    def remove_selfloops(self) -> "Graph":
        return self.filter_edges(self.sources != self.col_idx)

    def set_name(self, name: str) -> "Graph":
        return dataclasses.replace(self, name=name)

    def drop_weights(self) -> "Graph":
        return dataclasses.replace(self, weights=None)

    def relabel(self, order: np.ndarray) -> "Graph":
        """The graph with node order[i] renamed i; node names and types
        follow their nodes (generated names are written out)."""
        order = np.asarray(order)
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        node_type_ptr = node_type_ids = None
        if self.node_type_ptr is not None:
            node_type_ptr = np.concatenate(
                [[0], np.cumsum(np.diff(self.node_type_ptr)[order])]
            ).astype(self.node_type_ptr.dtype)
            node_type_ids = (np.concatenate(
                [self.node_type_ids[self.node_type_ptr[o]: self.node_type_ptr[o + 1]]
                 for o in order]).astype(self.node_type_ids.dtype)
                if len(self.node_type_ids) else self.node_type_ids)
        return Graph.from_edge_arrays(
            inverse[self.sources], inverse[self.col_idx], n_nodes=self.number_of_nodes,
            weights=self.weights, edge_types=self.edge_types, directed=True,
            directed_flag=self.directed, name=self.name,
            node_names=self.get_node_names()[order], node_type_ptr=node_type_ptr,
            node_type_ids=node_type_ids, node_type_names=self.node_type_names,
            edge_type_names=self.edge_type_names,
        )

    def sort_by_decreasing_outbound_node_degree(self) -> "Graph":
        """The graph relabelled so that node ids fall with out-degree (stable
        among equal degrees)."""
        return self.relabel(np.argsort(-self.degrees, kind="stable"))

    def _node_subgraph(self, keep: np.ndarray, node_names) -> "Graph":
        """The graph on the nodes where `keep`, renumbered in order, with the
        arcs between them; node types are dropped, as in the reference."""
        ids = np.nonzero(keep)[0]
        remap = np.full(self.number_of_nodes, -1, dtype=np.int64)
        remap[ids] = np.arange(len(ids))
        mask = keep[self.sources] & keep[self.col_idx]
        return Graph.from_edge_arrays(
            remap[self.sources[mask]], remap[self.col_idx[mask]], n_nodes=len(ids),
            weights=None if self.weights is None else self.weights[mask],
            edge_types=None if self.edge_types is None else self.edge_types[mask],
            directed=True, directed_flag=self.directed, name=self.name,
            node_names=node_names,
        )

    def remove_disconnected_nodes(self) -> "Graph":
        """The graph without the nodes that have neither outbound nor inbound
        arcs."""
        keep = self.degrees > 0
        keep[self.col_idx] = True
        return self._node_subgraph(
            keep, None if self.node_names is None else self.get_node_names()[keep])

    def filter_from_names(self, node_names_to_keep: Optional[Sequence[str]] = None,
                          node_names_to_remove: Optional[Sequence[str]] = None) -> "Graph":
        """The graph on the named nodes to keep (default: all) less those to
        remove."""
        keep = np.ones(self.number_of_nodes, dtype=bool)
        if node_names_to_keep is not None:
            keep[:] = False
            keep[self.get_node_ids_from_names(node_names_to_keep)] = True
        if node_names_to_remove is not None:
            keep[self.get_node_ids_from_names(node_names_to_remove)] = False
        return self._node_subgraph(keep, self.get_node_names()[keep])

    def connected_components(self) -> Tuple[np.ndarray, int]:
        """(component of each node [N] int32, number of components), arcs
        read as undirected, by the native union-find; components are
        numbered in the order of their smallest node, as scipy's are."""
        return native.connected_components(self.sources, self.col_idx, self.number_of_nodes)

    @property
    def number_of_connected_components(self) -> int:
        return self.connected_components()[1]

    def is_connected(self) -> bool:
        return self.number_of_connected_components == 1

    def to_dot(self) -> str:
        """The GraphViz text of the graph (each undirected edge once)."""
        names = np.asarray(self.get_node_names(), dtype=object)
        kind, arrow = ("digraph", "->") if self.directed else ("graph", "--")
        src, dst = self.sources, self.col_idx
        if not self.directed:
            keep = src <= dst
            src, dst = src[keep], dst[keep]
        body = "".join(
            np.char.add(np.char.add(np.char.add('  "', names[src].astype(str)),
                                    f'" {arrow} "'),
                        np.char.add(names[dst].astype(str), '";\n'))
        ) if len(src) else ""
        return f"{kind} {{\n{body}}}"

    def consistent_hash(self) -> str:
        """sha256 of the name, the CSR, the weights and the edge types."""
        import hashlib

        h = hashlib.sha256()
        h.update(self.name.encode())
        for arr in (self.row_ptr, self.col_idx, self.weights, self.edge_types):
            if arr is not None:
                h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

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
        edge_types: Optional[np.ndarray] = None,
        edge_type_names: Optional[Sequence[str]] = None,
        node_type_ptr: Optional[np.ndarray] = None,
        node_type_ids: Optional[np.ndarray] = None,
        node_type_names: Optional[Sequence[str]] = None,
    ) -> "Graph":
        """Build the CSR from (src, dst[, weights, edge types]) arc arrays.

        If directed=False, arcs are symmetrized, each reverse arc with its
        edge's weight and type. Arcs sort by source, then destination; a
        duplicate arc keeps the attributes of its first occurrence. An
        undirected build without weights or types is `native.build_sym_csr`,
        any other `native.sort_pairs` and a first-occurrence dedup.
        `directed_flag`, when given, is the stored directedness in place of
        `directed` (for arcs that are already symmetrized). The node types
        (`node_type_ptr`, `node_type_ids`) are stored as given."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if n_nodes is None:
            n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        if not directed and weights is None and edge_types is None:
            row_ptr, col_idx = native.build_sym_csr(src, dst, n_nodes)
        else:
            if not directed:
                non_loop = src != dst
                src, dst = (np.concatenate([src, dst[non_loop]]),
                            np.concatenate([dst, src[non_loop]]))
                if weights is not None:
                    weights = np.concatenate([weights, weights[non_loop]])
                if edge_types is not None:
                    edge_types = np.concatenate([edge_types, edge_types[non_loop]])
            order = native.sort_pairs(src, dst, n_nodes)
            src, dst = src[order], dst[order]
            # The stable sort leaves each pair's first occurrence first.
            first = np.ones(len(src), dtype=bool)
            first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
            src, dst, order = src[first], dst[first], order[first]
            if weights is not None:
                weights = np.asarray(weights, dtype=np.float32)[order]
            if edge_types is not None:
                edge_types = np.asarray(edge_types, dtype=np.int32)[order]
            row_ptr = np.concatenate(
                [[0], np.cumsum(np.bincount(src, minlength=n_nodes))]).astype(np.int64)
            col_idx = dst.astype(np.int32)
        return Graph(
            row_ptr=row_ptr,
            col_idx=col_idx,
            directed=directed if directed_flag is None else directed_flag,
            name=name,
            weights=weights,
            node_names=(None if node_names is None
                        else np.asarray(node_names, dtype=object)),
            edge_types=edge_types,
            edge_type_names=(None if edge_type_names is None
                             else np.asarray(edge_type_names, dtype=object)),
            node_type_ptr=None if node_type_ptr is None else np.asarray(node_type_ptr),
            node_type_ids=None if node_type_ids is None else np.asarray(node_type_ids),
            node_type_names=(None if node_type_names is None
                             else np.asarray(node_type_names, dtype=object)),
        )

    def device(
        self,
        device: Union[str, torch.device],
        with_alias: bool = False,
        with_sources: bool = False,
        ell_cap: Optional[int] = None,
        ell_seed: int = 0,
        with_walk_types: bool = False,
        with_walk_arcs: bool = False,
        with_arc_pairs: bool = False,
    ) -> TorchGraph:
        """Export the CSR as a TorchGraph on `device`, with alias tables when
        `with_alias` and the graph is weighted, each arc's source when
        `with_sources`, the capped ELLPACK adjacency when `ell_cap` is
        given (`ell_arrays`), and the edge types when the graph has them.
        `with_walk_types` adds the typed walks' tables: each node's primary
        type when the graph has node types and, with an ELL table, [N, cap]
        int32 tables (-1 padded), slot for slot with it, of the primary node
        type of each slot's neighbour (with node types) and of the edge type
        of its arc (with edge types), the JAX package's `ell_ntypes` and
        `ell_etypes`. `with_walk_arcs` adds a 16-byte record an arc (its
        head, the head's row start and degree), with which a first-order
        walk step is one dependent load on the card, unless alias tables
        are exported (weighted steps read the alias entry first).
        `with_arc_pairs` adds an 8-byte record an arc (its source and head),
        from which the edge batch reads a positive in one load."""
        device = torch.device(device)
        if self.number_of_directed_edges >= 2**31:
            raise ValueError("The kernels index arcs with int32; this graph "
                             f"has {self.number_of_directed_edges} arcs.")

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        def maybe(a, dtype):
            return None if a is None else put(a, dtype)

        alias_prob = alias_idx = None
        if with_alias and self.weights is not None:
            prob, alias = build_alias_tables(self.row_ptr, self.weights)
            alias_prob, alias_idx = put(prob, np.float32), put(alias, np.int32)
        cap, ell = self._ell_tables(ell_cap, ell_seed, with_walk_types)
        node_type_of = (self.get_single_label_node_type_ids()
                        if with_walk_types and self.has_node_types else None)
        row_ptr, col_idx = put(self.row_ptr, np.int32), put(self.col_idx, np.int32)
        degrees = put(self.degrees, np.int32)
        walk_arcs = None
        if with_walk_arcs and alias_prob is None:
            heads = col_idx.long()
            walk_arcs = torch.stack([col_idx, row_ptr[heads], degrees[heads],
                                     torch.zeros_like(col_idx)], dim=1).contiguous()
        return TorchGraph(
            row_ptr=row_ptr,
            col_idx=col_idx,
            degrees=degrees,
            weights=maybe(self.weights, np.float32),
            alias_prob=alias_prob,
            alias_idx=alias_idx,
            n_nodes=self.number_of_nodes,
            n_arcs=self.number_of_directed_edges,
            max_degree=int(self.degrees.max(initial=0)),
            sources=put(self.sources, np.int32) if with_sources else None,
            walk_arcs=walk_arcs,
            arc_pairs=(torch.stack([put(self.sources, np.int32), col_idx], dim=1).contiguous()
                       if with_arc_pairs else None),
            ell_cols=maybe(ell.get("ell_cols"), np.int32),
            ell_w=maybe(ell.get("ell_w"), np.float32),
            ell_cap=cap,
            edge_types=maybe(self.edge_types, np.int32),
            node_type_of=maybe(node_type_of, np.int32),
            ell_ntypes=maybe(ell.get("ell_ntypes"), np.int32),
            ell_etypes=maybe(ell.get("ell_etypes"), np.int32),
        )

    def _ell_tables(self, ell_cap: Optional[int], ell_seed: int, with_types: bool):
        """(cap, {name: [N, cap] array}) with cap = min(ell_cap, max
        degree): "ell_cols" (-1 padded), "ell_w" on weighted graphs (0
        padded) and, `with_types`, "ell_ntypes" (with node types) and
        "ell_etypes" (with edge types), -1 padded; (0, {}) when `ell_cap` is
        None or not positive. A row of at most cap arcs keeps its CSR order;
        a longer row keeps the first cap of a seeded random within-row
        order."""
        if ell_cap is None or ell_cap <= 0:
            return 0, {}
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

        def table(values, fill, dtype):
            out = np.full((n, cap), fill, dtype)
            out[rows[keep], pos[keep]] = values[keep]
            return out

        tables = {"ell_cols": table(self.col_idx, -1, np.int32)}
        if self.weights is not None:
            tables["ell_w"] = table(self.weights, 0, np.float32)
        if with_types and self.has_node_types:
            ntypes = self.get_single_label_node_type_ids()
            tables["ell_ntypes"] = table(ntypes[self.col_idx], -1, np.int32)
        if with_types and self.edge_types is not None:
            tables["ell_etypes"] = table(self.edge_types, -1, np.int32)
        return cap, tables

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
        cap, tables = self._ell_tables(ell_cap, ell_seed, False)
        return tables.get("ell_cols"), tables.get("ell_w"), cap

    def __repr__(self) -> str:
        return (
            f"Graph(name={self.name!r}, nodes={self.number_of_nodes}, "
            f"arcs={self.number_of_directed_edges}, directed={self.directed}, "
            f"weighted={self.has_edge_weights}, "
            f"node_types={self.number_of_node_types}, "
            f"edge_types={self.number_of_edge_types})"
        )
