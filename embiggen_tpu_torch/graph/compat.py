"""The reference-named Graph surface — counterpart of
`embiggen_tpu/graph/compat.py`: every method of its `ReferenceGraphAPI`
mixin, under the same name and signature, delegating to the CSR container,
the holdout, sampling, laplacian and metric modules, the spectral
similarity builders and the native helpers. Every method returns numpy, as
the reference's do.

Methods that run on a device take one keyword more, `device` (the card,
"cuda", unless the caller asks for the CPU), and read the graph as
`_device_graph(device)` exports it: a `TorchGraph` without alias tables or
an ELL table, cached per device, as the reference caches its
`DeviceGraph`.
- `node2vec`: walks from uniform starts cut into `skipgram_pairs`
  (`ops.walks.node2vec_batch`): K1 at p = q = 1, K10 at other weights with
  a ratio up to 16 (no ELL table is exported);
- `get_edge_prediction_mini_batch`: K6;
- `get_siamese_mini_batch` and `get_siamese_mini_batch_with_edge_types`:
  K14's siamese batch;
- `sample_negative_graph`: K5 for the membership test;
- `get_all_edge_metrics`, `get_all_edge_metrics_from_node_ids` and the four
  per-metric scores: K8 at a cap of the largest degree, the host copy of
  `metrics.py` on the CPU.
On a CPU device each of these runs its kernel's plain version. The batch
methods draw from a `torch.Generator` on the device seeded with
`random_state`: the starts of `node2vec` by `torch.randint`, then the op's
own draws, so the same call of the op with a generator so seeded returns
the same batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class ReferenceGraphAPI:
    """Mixin for `Graph`: reference-named delegates; its only state is the
    cache of `_device_graph`."""

    # ------------------------------------------------------------ counts/name
    def get_name(self) -> str:
        return self.name

    def get_number_of_nodes(self) -> int:
        return self.number_of_nodes

    def get_number_of_directed_edges(self) -> int:
        return self.number_of_directed_edges

    def get_number_of_edges(self) -> int:
        return self.number_of_edges

    def is_directed(self) -> bool:
        return self.directed

    def get_density(self) -> float:
        return self.density

    def has_nodes(self) -> bool:
        return self.number_of_nodes > 0

    def has_edges_in_graph(self) -> bool:
        return self.number_of_directed_edges > 0

    def has_selfloops(self) -> bool:
        return bool(np.any(self.sources == self.col_idx))

    def get_number_of_selfloops(self) -> int:
        return int(np.sum(self.sources == self.col_idx))

    def is_multigraph(self) -> bool:
        keys = self._sorted_arc_keys
        return bool(len(keys) > 1 and np.any(np.diff(keys) == 0))

    def get_number_of_unique_source_nodes(self) -> int:
        return int(np.count_nonzero(self.degrees > 0))

    # ---------------------------------------------------------------- degrees
    def get_node_degrees(self) -> np.ndarray:
        return self.degrees

    def get_node_degree_from_node_id(self, node_id: int) -> int:
        return int(self.degrees[node_id])

    def get_cumulative_node_degrees(self) -> np.ndarray:
        return np.asarray(self.row_ptr[1:], dtype=np.int64)

    def get_maximum_node_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    def get_minimum_node_degree(self) -> int:
        return int(self.degrees.min(initial=0))

    def get_non_zero_subgraph_node_degrees(self, graph) -> np.ndarray:
        """Degrees in `self` of the nodes that are non-singleton in `graph`
        (reference visualizer subsampling helper)."""
        return self.degrees[np.asarray(graph.degrees) > 0]

    def has_disconnected_nodes(self) -> bool:
        return bool(np.any(self.degrees == 0))

    def has_singleton_nodes(self) -> bool:
        return self.has_disconnected_nodes()

    def get_number_of_singleton_nodes(self) -> int:
        return int(np.sum(self.degrees == 0))

    def get_number_of_disconnected_nodes(self) -> int:
        return self.get_number_of_singleton_nodes()

    def has_nodes_sorted_by_decreasing_outbound_node_degree(self) -> bool:
        return self.is_sorted_by_decreasing_outbound_node_degree()

    # ------------------------------------------------------------------ nodes
    def get_node_ids(self) -> np.ndarray:
        return np.arange(self.number_of_nodes, dtype=np.int32)

    def get_node_name_from_node_id(self, node_id: int) -> str:
        return str(self.get_node_names()[node_id])

    def get_node_names_from_node_ids(self, node_ids) -> List[str]:
        names = self.get_node_names()
        return [str(names[i]) for i in np.asarray(node_ids)]

    def get_node_id_from_node_name(self, node_name: str) -> int:
        return int(self.node_name_to_id[node_name])

    def has_node_name(self, node_name: str) -> bool:
        return node_name in self.node_name_to_id

    # -------------------------------------------------------------- endpoints
    def get_directed_source_node_ids(self) -> np.ndarray:
        return self.sources

    def get_directed_destination_node_ids(self) -> np.ndarray:
        return np.asarray(self.col_idx)

    def get_source_node_ids(self, directed: bool = True) -> np.ndarray:
        return self.sources

    def get_destination_node_ids(self, directed: bool = True) -> np.ndarray:
        return np.asarray(self.col_idx)

    def get_source_names(self, directed: bool = True) -> List[str]:
        return self.get_node_names_from_node_ids(self.sources)

    def get_destination_names(self, directed: bool = True) -> List[str]:
        return self.get_node_names_from_node_ids(self.col_idx)

    def get_directed_edge_node_ids(self) -> np.ndarray:
        return np.stack([self.sources, np.asarray(self.col_idx)], axis=1)

    def get_edge_node_ids(self, directed: bool = True) -> np.ndarray:
        return self.get_directed_edge_node_ids()

    def get_directed_edge_node_names(self) -> List[Tuple[str, str]]:
        names = self.get_node_names()
        return [
            (str(names[s]), str(names[d]))
            for s, d in zip(self.sources, self.col_idx)
        ]

    def get_edge_names(self, directed: bool = True) -> List[Tuple[str, str]]:
        return self.get_directed_edge_node_names()

    def get_node_ids_from_edge_id(self, edge_id: int) -> Tuple[int, int]:
        return int(self.sources[edge_id]), int(self.col_idx[edge_id])

    def get_node_names_from_edge_id(self, edge_id: int) -> Tuple[str, str]:
        s, d = self.get_node_ids_from_edge_id(edge_id)
        names = self.get_node_names()
        return str(names[s]), str(names[d])

    def get_edge_ids_from_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        return self.get_edge_ids(src, dst)

    def get_edge_id_from_node_ids(self, src: int, dst: int) -> int:
        eid = int(self.get_edge_ids(np.asarray([src]), np.asarray([dst]))[0])
        if eid < 0:
            raise ValueError(f"No edge ({src}, {dst}) in {self.name}.")
        return eid

    def get_edge_data(self):
        """Tidy DataFrame of the arc list (sources, destinations, weights,
        edge types)."""
        import pandas as pd

        data = {"source": self.sources, "destination": np.asarray(self.col_idx)}
        if self.weights is not None:
            data["weight"] = self.weights
        if self.edge_types is not None:
            data["edge_type"] = self.edge_types
        return pd.DataFrame(data)

    # ---------------------------------------------------------------- weights
    def get_directed_edge_weights(self) -> np.ndarray:
        if self.weights is None:
            raise ValueError(f"Graph {self.name} has no edge weights.")
        return self.weights

    def get_undirected_edge_weights(self) -> np.ndarray:
        w = self.get_directed_edge_weights()
        mask = self.sources <= np.asarray(self.col_idx)
        return w[mask]

    def get_edge_weight_from_edge_id(self, edge_id: int) -> float:
        return float(self.get_directed_edge_weights()[edge_id])

    def get_unchecked_edge_weight_from_edge_id(self, edge_id: int) -> float:
        return float(self.weights[edge_id])

    def has_negative_edge_weights(self) -> bool:
        return self.weights is not None and bool(np.any(self.weights < 0))

    def has_constant_edge_weights(self) -> bool:
        return self.weights is not None and bool(
            np.all(self.weights == self.weights[0])
        ) if (self.weights is not None and len(self.weights)) else (
            self.weights is not None
        )

    # ------------------------------------------------------------- node types
    def has_unknown_node_types(self) -> bool:
        return bool(np.any(~self.get_known_node_types_mask()))

    def has_known_node_types(self) -> bool:
        return bool(np.any(self.get_known_node_types_mask()))

    def get_number_of_known_node_types(self) -> int:
        return int(self.get_known_node_types_mask().sum())

    def get_nodes_with_known_node_types_mask(self) -> np.ndarray:
        return self.get_known_node_types_mask()

    def get_unique_node_type_names(self) -> List[str]:
        names = self.get_node_type_names()
        if names is None:
            raise ValueError(f"Graph {self.name} has no node types.")
        return [str(n) for n in names]

    def get_node_type_name_from_node_type_id(self, type_id: int) -> str:
        return str(self.get_node_type_names()[type_id])

    def get_node_type_ids_from_node_id(self, node_id: int) -> np.ndarray:
        if self.node_type_ptr is None:
            raise ValueError(f"Graph {self.name} has no node types.")
        return np.asarray(
            self.node_type_ids[
                self.node_type_ptr[node_id]: self.node_type_ptr[node_id + 1]
            ]
        )

    def get_unchecked_node_type_names_from_node_id(
        self, node_id: int
    ) -> List[str]:
        names = self.get_node_type_names()
        return [str(names[t]) for t in self.get_node_type_ids_from_node_id(node_id)]

    def get_node_type_names_from_node_id(self, node_id: int) -> List[str]:
        return self.get_unchecked_node_type_names_from_node_id(node_id)

    def has_node_type_name(self, type_name: str) -> bool:
        names = self.get_node_type_names()
        return names is not None and type_name in set(str(n) for n in names)

    def get_node_type_id_counts_hashmap(self) -> Dict[int, int]:
        if self.node_type_ids is None:
            raise ValueError(f"Graph {self.name} has no node types.")
        ids, counts = np.unique(self.node_type_ids, return_counts=True)
        return {int(i): int(c) for i, c in zip(ids, counts)}

    def get_node_type_names_counts_hashmap(self) -> Dict[str, int]:
        names = self.get_node_type_names()
        return {
            str(names[i]): c
            for i, c in self.get_node_type_id_counts_hashmap().items()
        }

    def get_boolean_node_type_ids(self) -> np.ndarray:
        """[N, T] boolean multilabel indicator matrix."""
        return self.get_one_hot_encoded_node_types().astype(bool)

    def has_homogeneous_node_types(self) -> bool:
        return (
            self.node_type_ids is not None
            and len(np.unique(self.node_type_ids)) == 1
            and not self.has_unknown_node_types()
            and not self.has_multilabel_node_types()
        )

    def has_exclusively_homogeneous_node_types(self) -> bool:
        return self.has_homogeneous_node_types()

    def has_singleton_node_types(self) -> bool:
        if self.node_type_ids is None:
            return False
        _, counts = np.unique(self.node_type_ids, return_counts=True)
        return bool(np.any(counts == 1))

    def has_exclusively_singleton_node_types(self) -> bool:
        if self.node_type_ids is None:
            return False
        _, counts = np.unique(self.node_type_ids, return_counts=True)
        return bool(np.all(counts == 1))

    def set_all_node_types(self, type_name: str) -> "ReferenceGraphAPI":
        """New graph where every node carries exactly the given type."""
        n = self.number_of_nodes
        return dataclasses.replace(
            self,
            node_type_ptr=np.arange(n + 1, dtype=np.int64),
            node_type_ids=np.zeros(n, dtype=np.int32),
            node_type_names=np.asarray([type_name], dtype=object),
        )

    def remove_node_types(self) -> "ReferenceGraphAPI":
        return dataclasses.replace(
            self, node_type_ptr=None, node_type_ids=None, node_type_names=None
        )

    # ------------------------------------------------------------- edge types
    def has_unknown_edge_types(self) -> bool:
        return self.edge_types is not None and bool(
            np.any(~self.get_known_edge_types_mask())
        )

    def has_known_edge_types(self) -> bool:
        return self.edge_types is not None and bool(
            np.any(self.get_known_edge_types_mask())
        )

    def get_number_of_known_edge_types(self) -> int:
        return int(self.get_known_edge_types_mask().sum())

    def get_unique_edge_type_names(self) -> List[str]:
        names = self.get_edge_type_names()
        if names is None:
            raise ValueError(f"Graph {self.name} has no edge types.")
        return [str(n) for n in names]

    def get_unique_edge_type_ids(self) -> np.ndarray:
        ids = np.unique(self.get_directed_edge_type_ids())
        return ids[ids >= 0]

    def get_edge_type_name_from_edge_type_id(self, type_id: int) -> str:
        return str(self.get_edge_type_names()[type_id])

    def get_edge_type_name_from_edge_id(self, edge_id: int) -> Optional[str]:
        t = int(self.get_directed_edge_type_ids()[edge_id])
        return None if t < 0 else self.get_edge_type_name_from_edge_type_id(t)

    def get_unchecked_edge_type_name_from_edge_id(self, edge_id: int):
        return self.get_edge_type_name_from_edge_id(edge_id)

    def has_edge_type_name(self, type_name: str) -> bool:
        names = self.get_edge_type_names()
        return names is not None and type_name in set(str(n) for n in names)

    def get_directed_edge_type_ids(self) -> np.ndarray:
        if self.edge_types is None:
            raise ValueError(f"Graph {self.name} has no edge types.")
        return self.edge_types

    def get_directed_edge_type_names(self) -> List[Optional[str]]:
        names = self.get_edge_type_names()
        return [
            None if t < 0 else str(names[t])
            for t in self.get_directed_edge_type_ids()
        ]

    def get_directed_known_edge_type_ids(self) -> np.ndarray:
        ids = self.get_directed_edge_type_ids()
        return ids[ids >= 0]

    def get_directed_edges_with_known_edge_types_mask(self) -> np.ndarray:
        return self.get_known_edge_types_mask()

    def get_edge_type_id_counts_hashmap(self) -> Dict[int, int]:
        ids = self.get_directed_known_edge_type_ids()
        uniq, counts = np.unique(ids, return_counts=True)
        return {int(i): int(c) for i, c in zip(uniq, counts)}

    def get_edge_type_names_counts_hashmap(self) -> Dict[str, int]:
        names = self.get_edge_type_names()
        return {
            str(names[i]): c
            for i, c in self.get_edge_type_id_counts_hashmap().items()
        }

    def has_homogeneous_edge_types(self) -> bool:
        return (
            self.edge_types is not None
            and len(np.unique(self.get_directed_known_edge_type_ids())) == 1
            and not self.has_unknown_edge_types()
        )

    def has_exclusively_homogeneous_edge_types(self) -> bool:
        return self.has_homogeneous_edge_types()

    def has_singleton_edge_types(self) -> bool:
        if self.edge_types is None:
            return False
        _, counts = np.unique(
            self.get_directed_known_edge_type_ids(), return_counts=True
        )
        return bool(np.any(counts == 1))

    def has_exclusively_singleton_edge_types(self) -> bool:
        if self.edge_types is None:
            return False
        _, counts = np.unique(
            self.get_directed_known_edge_type_ids(), return_counts=True
        )
        return bool(len(counts) and np.all(counts == 1))

    def set_all_edge_types(self, type_name: str) -> "ReferenceGraphAPI":
        return dataclasses.replace(
            self,
            edge_types=np.zeros(self.number_of_directed_edges, np.int32),
            edge_type_names=np.asarray([type_name], dtype=object),
        )

    def remove_inplace_edge_type_name(
        self, type_name: str
    ) -> "ReferenceGraphAPI":
        """Drop one edge type from the vocabulary, marking its arcs unknown.
        (The container is immutable; the reference's `_inplace` name is kept
        for API parity but a NEW graph is returned.)"""
        names = [str(n) for n in self.get_edge_type_names()]
        if type_name not in names:
            raise ValueError(f"Unknown edge type {type_name!r}.")
        drop = names.index(type_name)
        old = self.get_directed_edge_type_ids()
        new_ids = np.where(old == drop, -1, old - (old > drop)).astype(np.int32)
        new_names = np.asarray(
            [n for n in names if n != type_name], dtype=object
        )
        return dataclasses.replace(
            self, edge_types=new_ids, edge_type_names=new_names
        )

    # Upper-triangular edge-type views (reference edge-label prediction,
    # `edge_label_prediction_model.py` known-type masks).
    def _upper_triangular_mask(self) -> np.ndarray:
        return self.sources < np.asarray(self.col_idx)

    def get_upper_triangular_edge_type_ids(self) -> np.ndarray:
        return self.get_directed_edge_type_ids()[self._upper_triangular_mask()]

    def get_upper_triangular_known_edge_types_mask(self) -> np.ndarray:
        return self.get_known_edge_types_mask()[self._upper_triangular_mask()]

    def get_upper_triangular_known_edge_type_ids(self) -> np.ndarray:
        ids = self.get_upper_triangular_edge_type_ids()
        return ids[ids >= 0]

    def get_imputed_directed_edge_type_ids(
        self, imputation_edge_type_id: int = 0
    ) -> np.ndarray:
        ids = self.get_directed_edge_type_ids()
        return np.where(ids < 0, imputation_edge_type_id, ids)

    def get_imputed_upper_triangular_edge_type_ids(
        self, imputation_edge_type_id: int = 0
    ) -> np.ndarray:
        ids = self.get_upper_triangular_edge_type_ids()
        return np.where(ids < 0, imputation_edge_type_id, ids)

    def get_directed_edge_triples_ids(self) -> np.ndarray:
        """[E, 3] (source, edge type, destination) int32 triples."""
        return np.stack(
            [
                self.sources.astype(np.int64),
                self.get_imputed_directed_edge_type_ids().astype(np.int64),
                np.asarray(self.col_idx, dtype=np.int64),
            ],
            axis=1,
        )

    # ------------------------------------------------------------- ontologies
    # Ontology = the prefix before ':' in node names (OBO convention the
    # reference follows, `graph_visualizer.py:3134`).
    def get_ontology_from_node_id(self, node_id: int) -> Optional[str]:
        name = self.get_node_name_from_node_id(node_id)
        return name.split(":", 1)[0] if ":" in name else None

    def has_node_ontologies(self) -> bool:
        return any(
            ":" in str(n) for n in self.get_node_names()
        )

    def has_unknown_node_ontologies(self) -> bool:
        return any(":" not in str(n) for n in self.get_node_names())

    def has_homogeneous_node_ontologies(self) -> bool:
        onts = {
            str(n).split(":", 1)[0] if ":" in str(n) else None
            for n in self.get_node_names()
        }
        return len(onts) == 1 and None not in onts

    def must_have_node_ontologies(self) -> None:
        if not self.has_node_ontologies():
            raise ValueError(
                f"Graph {self.name} has no node ontologies (no ':'-prefixed "
                "node names)."
            )

    # ---------------------------------------------------------- vocabularies
    def has_compatible_node_vocabularies(self, other) -> bool:
        if self.number_of_nodes != other.number_of_nodes:
            return False
        return bool(
            np.array_equal(self.get_node_names(), other.get_node_names())
        )

    def has_compatible_node_types_vocabularies(self, other) -> bool:
        a, b = self.get_node_type_names(), other.get_node_type_names()
        if a is None or b is None:
            return a is None and b is None
        return bool(np.array_equal(a, b))

    def has_compatible_edge_types_vocabularies(self, other) -> bool:
        a, b = self.get_edge_type_names(), other.get_edge_type_names()
        if a is None or b is None:
            return a is None and b is None
        return bool(np.array_equal(a, b))

    def get_node_ids_mapping_from_graph(self, other) -> np.ndarray:
        """For each node of `self`, its id in `other` (by name)."""
        lookup = other.node_name_to_id
        return np.asarray(
            [lookup[str(n)] for n in self.get_node_names()], dtype=np.int32
        )

    # ------------------------------------------------------------- structure
    def remove_singleton_nodes(self) -> "ReferenceGraphAPI":
        return self.remove_disconnected_nodes()

    def remove_parallel_edges(self) -> "ReferenceGraphAPI":
        keys = (
            self.sources.astype(np.int64) * self.number_of_nodes
            + np.asarray(self.col_idx, dtype=np.int64)
        )
        # CSR order: keys are sorted; keep the first of each run.
        keep = np.ones(len(keys), dtype=bool)
        keep[1:] = np.diff(keys) != 0
        return self.filter_edges(keep)

    def to_transposed(self) -> "ReferenceGraphAPI":
        from .graph import Graph

        return Graph.from_edge_arrays(
            np.asarray(self.col_idx, dtype=np.int64),
            self.sources.astype(np.int64),
            n_nodes=self.number_of_nodes,
            weights=self.weights,
            edge_types=self.edge_types,
            directed=True,
            directed_flag=self.directed,
            name=self.name,
            node_names=self.node_names,
            node_type_ptr=self.node_type_ptr,
            node_type_ids=self.node_type_ids,
            node_type_names=self.node_type_names,
            edge_type_names=self.edge_type_names,
        )

    def add_selfloops(
        self, edge_type_name: Optional[str] = None, weight: float = 1.0
    ) -> "ReferenceGraphAPI":
        from .graph import Graph

        n = self.number_of_nodes
        loop_ids = np.arange(n, dtype=np.int64)
        src = np.concatenate([self.sources.astype(np.int64), loop_ids])
        dst = np.concatenate(
            [np.asarray(self.col_idx, dtype=np.int64), loop_ids]
        )
        weights = None
        if self.weights is not None:
            weights = np.concatenate(
                [self.weights, np.full(n, weight, np.float32)]
            )
        edge_types = None
        if self.edge_types is not None:
            names = [str(x) for x in self.get_edge_type_names()]
            if edge_type_name is not None and edge_type_name not in names:
                names.append(edge_type_name)
            t = names.index(edge_type_name) if edge_type_name else -1
            edge_types = np.concatenate(
                [self.edge_types, np.full(n, t, np.int32)]
            )
        return Graph.from_edge_arrays(
            src, dst, n_nodes=n, weights=weights, edge_types=edge_types,
            directed=True, directed_flag=self.directed, name=self.name,
            node_names=self.node_names, node_type_ptr=self.node_type_ptr,
            node_type_ids=self.node_type_ids,
            node_type_names=self.node_type_names,
            edge_type_names=(
                np.asarray(names, dtype=object)
                if self.edge_types is not None
                else None
            ),
        )

    def add_node(
        self, node_name: str, node_type_names: Optional[Sequence[str]] = None
    ) -> "ReferenceGraphAPI":
        from .graph import Graph

        n = self.number_of_nodes
        names = list(self.get_node_names()) + [node_name]
        ntp, nti, ntn = self.node_type_ptr, self.node_type_ids, self.node_type_names
        if ntp is not None:
            tnames = [str(x) for x in self.get_node_type_names()]
            new_ids = []
            for t in node_type_names or []:
                if t not in tnames:
                    tnames.append(t)
                new_ids.append(tnames.index(t))
            ntp = np.concatenate([ntp, [ntp[-1] + len(new_ids)]])
            nti = np.concatenate([nti, np.asarray(new_ids, np.int32)])
            ntn = np.asarray(tnames, dtype=object)
        return Graph.from_edge_arrays(
            self.sources.astype(np.int64),
            np.asarray(self.col_idx, dtype=np.int64),
            n_nodes=n + 1, weights=self.weights, edge_types=self.edge_types,
            directed=True, directed_flag=self.directed, name=self.name,
            node_names=np.asarray(names, dtype=object),
            node_type_ptr=ntp, node_type_ids=nti, node_type_names=ntn,
            edge_type_names=self.edge_type_names,
        )

    def add_edge(self, src_name: str, dst_name: str) -> "ReferenceGraphAPI":
        from .graph import Graph

        s = self.get_node_id_from_node_name(src_name)
        d = self.get_node_id_from_node_name(dst_name)
        src = np.concatenate([self.sources.astype(np.int64), [s]])
        dst = np.concatenate([np.asarray(self.col_idx, np.int64), [d]])
        weights = (
            np.concatenate([self.weights, [1.0]]).astype(np.float32)
            if self.weights is not None else None
        )
        edge_types = (
            np.concatenate([self.edge_types, [-1]]).astype(np.int32)
            if self.edge_types is not None else None
        )
        return Graph.from_edge_arrays(
            src, dst, n_nodes=self.number_of_nodes, weights=weights,
            edge_types=edge_types, directed=self.directed, name=self.name,
            node_names=self.node_names, node_type_ptr=self.node_type_ptr,
            node_type_ids=self.node_type_ids,
            node_type_names=self.node_type_names,
            edge_type_names=self.edge_type_names,
        )

    def get_connected_components(
        self,
    ) -> Tuple[np.ndarray, int, int, int]:
        """(membership, number, smallest size, biggest size) — reference
        `get_connected_components` tuple shape."""
        comp, n = self.connected_components()
        sizes = np.bincount(comp, minlength=n)
        return comp, n, int(sizes.min()), int(sizes.max())

    # --------------------------------------------------------- linear algebra
    def _kernel_coo(self, kernel: str):
        from .laplacians import kernel_coo

        return kernel_coo(self, kernel)

    def get_laplacian_coo_matrix(self):
        """Plain combinatorial laplacian L = D - A as COO (reference
        `Graph.get_laplacian_coo_matrix`)."""
        n = self.number_of_nodes
        rows = np.concatenate([self.sources, np.arange(n, dtype=np.int32)])
        cols = np.concatenate(
            [np.asarray(self.col_idx), np.arange(n, dtype=np.int32)]
        )
        vals = np.concatenate(
            [
                -np.ones(self.number_of_directed_edges, np.float32),
                self.degrees.astype(np.float32),
            ]
        )
        return rows.astype(np.int32), cols.astype(np.int32), vals

    def get_symmetric_normalized_laplacian_coo_matrix(self):
        return self._kernel_coo("Symmetric Normalized Laplacian")

    def get_left_normalized_laplacian_coo_matrix(self):
        return self._kernel_coo("Left Normalized Laplacian")

    def get_right_normalized_laplacian_coo_matrix(self):
        return self._kernel_coo("Right Normalized Laplacian")

    def get_dense_modularity_matrix(self) -> np.ndarray:
        """B = A - d dᵀ / 2m (reference SocioDim, `sociodim.py:5-6`)."""
        n = self.number_of_nodes
        a = np.zeros((n, n), np.float64)
        a[self.sources, np.asarray(self.col_idx)] = 1.0
        deg = a.sum(axis=1)
        two_m = max(deg.sum(), 1.0)
        return a - np.outer(deg, deg) / two_m

    def _similarity_coo(self, metric: str):
        from ..models.embedders.spectral import _similarity_matrix

        m = _similarity_matrix(self, metric).tocoo()
        return m.row.astype(np.int32), m.col.astype(np.int32), m.data

    def get_neighbours_intersection_size_coo_matrix(self):
        return self._similarity_coo("Neighbours Intersection size")

    def get_jaccard_coo_matrix(self):
        return self._similarity_coo("Jaccard")

    def get_adamic_adar_coo_matrix(self):
        return self._similarity_coo("Adamic-Adar")

    def get_shared_ancestors_size_adjacency_matrix(
        self, bfs=None, verbose: bool = False
    ):
        return self._similarity_coo("Ancestors size")

    def get_shared_ancestors_jaccard_adjacency_matrix(
        self, bfs=None, verbose: bool = False
    ):
        return self._similarity_coo("Ancestors Jaccard")

    # ----------------------------------------------------------- edge metrics
    def get_number_of_available_edge_metrics(self) -> int:
        from .metrics import EDGE_METRIC_NAMES

        return len(EDGE_METRIC_NAMES)

    def _edge_metrics(self, src, dst, device) -> np.ndarray:
        """[B, 4] float32 metrics of the pairs over this graph: K8 at a cap
        of the largest degree on a CUDA device (the graph exported there
        once, `_device_graph`), the host copy `metrics.edge_metrics` on the
        CPU."""
        device = torch.device(device)
        if device.type == "cpu":
            from .metrics import edge_metrics

            return edge_metrics(self, np.asarray(src), np.asarray(dst))
        from ..ops.edge_metrics import edge_metrics

        tg = self._device_graph(device)

        def put(ids):
            return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(device)

        return edge_metrics(tg, put(src), put(dst), cap=max(tg.max_degree, 1)).cpu().numpy()

    def get_all_edge_metrics(
        self,
        normalize: bool = False,
        subgraph: Optional["ReferenceGraphAPI"] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> np.ndarray:
        g = subgraph if subgraph is not None else self
        m = self._edge_metrics(g.sources, g.col_idx, device)
        if normalize:
            peak = m.max(axis=0, keepdims=True)
            m = m / np.maximum(peak, 1e-12)
        return m

    def get_all_edge_metrics_from_node_ids(
        self, src: np.ndarray, dst: np.ndarray, normalize: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> np.ndarray:
        m = self._edge_metrics(src, dst, device)
        if normalize:
            m = m / np.maximum(m.max(axis=0, keepdims=True), 1e-12)
        return m

    def get_adamic_adar_scores(self, device: Union[str, torch.device] = "cuda") -> np.ndarray:
        return self.get_all_edge_metrics(device=device)[:, 0]

    def get_jaccard_coefficient_scores(
            self, device: Union[str, torch.device] = "cuda") -> np.ndarray:
        return self.get_all_edge_metrics(device=device)[:, 1]

    def get_resource_allocation_index_scores(
            self, device: Union[str, torch.device] = "cuda") -> np.ndarray:
        return self.get_all_edge_metrics(device=device)[:, 2]

    def get_preferential_attachment_scores(
            self, device: Union[str, torch.device] = "cuda") -> np.ndarray:
        return self.get_all_edge_metrics(device=device)[:, 3]

    def get_number_of_triangles_per_node(self) -> np.ndarray:
        from .metrics import triangle_counts

        return triangle_counts(self)

    def get_number_of_squares_per_node(self) -> np.ndarray:
        from .metrics import square_counts

        return square_counts(self)

    def get_approximated_closeness_centrality(
        self, n_sources: int = 100, random_state: int = 42
    ) -> np.ndarray:
        from .metrics import approximated_closeness_centrality

        return approximated_closeness_centrality(self, n_sources, random_state)

    def get_approximated_harmonic_centrality(
        self, n_sources: int = 100, random_state: int = 42
    ) -> np.ndarray:
        from .metrics import approximated_harmonic_centrality

        return approximated_harmonic_centrality(self, n_sources, random_state)

    # --------------------------------------------------------------- traversal
    def get_breadth_first_search_from_node_names(
        self, src_node_name: str, **kwargs
    ):
        """Distances (hops) from the given node; inf where unreachable."""
        import scipy.sparse as sp
        import scipy.sparse.csgraph as csgraph

        n = self.number_of_nodes
        a = sp.csr_matrix(
            (
                np.ones(self.number_of_directed_edges, np.float64),
                np.asarray(self.col_idx),
                self.row_ptr,
            ),
            shape=(n, n),
        )
        return csgraph.shortest_path(
            a, method="D", unweighted=True,
            indices=self.get_node_id_from_node_name(src_node_name),
        )

    def get_shortest_paths_matrix(
        self, sources: Optional[np.ndarray] = None
    ) -> np.ndarray:
        import scipy.sparse as sp
        import scipy.sparse.csgraph as csgraph

        n = self.number_of_nodes
        a = sp.csr_matrix(
            (
                np.ones(self.number_of_directed_edges, np.float64),
                np.asarray(self.col_idx),
                self.row_ptr,
            ),
            shape=(n, n),
        )
        return csgraph.shortest_path(
            a, method="D", unweighted=True, indices=sources
        )

    # ------------------------------------------------------ holdouts/sampling
    def connected_holdout(
        self, train_size: float = 0.8, random_state: int = 42, **kwargs
    ):
        from .holdouts import connected_holdout

        return connected_holdout(self, train_size, random_state)

    def random_holdout(
        self, train_size: float = 0.8, random_state: int = 42, **kwargs
    ):
        from .holdouts import random_holdout

        return random_holdout(self, train_size, random_state)

    def get_edge_prediction_kfold(
        self, k: int, k_index: int, random_state: int = 42, **kwargs
    ):
        from .holdouts import edge_prediction_kfold

        return edge_prediction_kfold(self, k, k_index, random_state)

    def get_node_label_holdout_graphs(
        self, train_size: float = 0.8, use_stratification: bool = True,
        random_state: int = 42, **kwargs
    ):
        from .holdouts import node_label_holdout

        return node_label_holdout(
            self, train_size, random_state, use_stratification
        )

    def get_node_label_kfold(
        self, k: int, k_index: int, use_stratification: bool = True,
        random_state: int = 42, **kwargs
    ):
        from .holdouts import node_label_kfold

        return node_label_kfold(self, k, k_index, random_state, use_stratification)

    def get_edge_label_holdout_graphs(
        self, train_size: float = 0.8, use_stratification: bool = True,
        random_state: int = 42, **kwargs
    ):
        from .holdouts import edge_label_holdout

        return edge_label_holdout(self, train_size, random_state, use_stratification)

    def get_edge_label_kfold(
        self, k: int, k_index: int, random_state: int = 42, **kwargs
    ):
        from .holdouts import edge_label_kfold

        return edge_label_kfold(self, k, k_index, random_state)

    def sample_negative_graph(
        self,
        number_of_negative_samples: int,
        random_state: int = 42,
        use_scale_free_distribution: bool = True,
        support=None,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ):
        """The negatives of `sampling.sample_negative_graph`, whose membership
        test runs on `device`."""
        from .sampling import sample_negative_graph

        return sample_negative_graph(
            self, number_of_negative_samples, random_state,
            use_scale_free_distribution, support, device=device,
        )

    def sample_positive_graph(
        self, number_of_samples: int, random_state: int = 42, **kwargs
    ):
        from .sampling import sample_positive_graph

        return sample_positive_graph(self, number_of_samples, random_state)

    # ------------------------------------------------- candidate-set builders
    def _pairs_graph(
        self, src_ids: np.ndarray, dst_ids: np.ndarray, name: str
    ):
        from .graph import Graph

        src_ids = np.asarray(src_ids, dtype=np.int64)
        dst_ids = np.asarray(dst_ids, dtype=np.int64)
        src = np.repeat(src_ids, len(dst_ids))
        dst = np.tile(dst_ids, len(src_ids))
        keep = src != dst
        return Graph.from_edge_arrays(
            src[keep], dst[keep], n_nodes=self.number_of_nodes,
            directed=True, name=name, node_names=self.node_names,
            node_type_ptr=self.node_type_ptr,
            node_type_ids=self.node_type_ids,
            node_type_names=self.node_type_names,
        )

    def build_bipartite_graph_from_edge_node_ids(
        self, source_node_ids, destination_node_ids, directed: bool = False
    ):
        """All |S|×|D| candidate arcs as a graph (reference
        `edge_prediction_model.py:1226` Rust builder)."""
        return self._pairs_graph(
            source_node_ids, destination_node_ids,
            f"{self.name}_bipartite",
        )

    def build_bipartite_graph_from_edge_node_names(
        self, source_node_names, destination_node_names, **kwargs
    ):
        return self.build_bipartite_graph_from_edge_node_ids(
            self.get_node_ids_from_names(list(source_node_names)),
            self.get_node_ids_from_names(list(destination_node_names)),
        )

    def build_bipartite_graph_from_edge_node_prefixes(
        self, source_node_prefixes, destination_node_prefixes, **kwargs
    ):
        return self.build_bipartite_graph_from_edge_node_ids(
            self.get_node_ids_from_prefixes(source_node_prefixes),
            self.get_node_ids_from_prefixes(destination_node_prefixes),
        )

    def build_bipartite_graph_from_edge_node_types(
        self, source_node_types, destination_node_types, **kwargs
    ):
        return self.build_bipartite_graph_from_edge_node_ids(
            self.get_node_ids_from_node_type_names(source_node_types),
            self.get_node_ids_from_node_type_names(destination_node_types),
        )

    def build_clique_graph_from_node_ids(self, node_ids, **kwargs):
        return self._pairs_graph(
            node_ids, node_ids, f"{self.name}_clique"
        )

    def build_clique_graph_from_node_names(self, node_names, **kwargs):
        return self.build_clique_graph_from_node_ids(
            self.get_node_ids_from_names(list(node_names))
        )

    def build_clique_graph_from_node_prefixes(self, node_prefixes, **kwargs):
        return self.build_clique_graph_from_node_ids(
            self.get_node_ids_from_prefixes(node_prefixes)
        )

    def build_clique_graph_from_node_type_names(
        self, node_type_names, **kwargs
    ):
        return self.build_clique_graph_from_node_ids(
            self.get_node_ids_from_node_type_names(node_type_names)
        )

    def __getstate__(self):
        # The cached device exports: a pickle leaves them out, and
        # `_device_graph` builds them again at its first call.
        state = dict(self.__dict__)
        state.pop("_device_graphs", None)
        return state

    # ---------------------------------------------------------- batch kernels
    def _device_graph(self, device: Union[str, torch.device]):
        """The graph exported on `device` (`Graph.device`, no alias tables,
        no ELL table), built once a device and cached on the graph."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_device_graphs", {})
        if device not in cache:
            cache[device] = self.device(device)
        return cache[device]

    def node2vec(
        self,
        random_state: int,
        batch_size: int,
        walk_length: int,
        window_size: int = 4,
        iterations: int = 1,
        return_weight: float = 1.0,
        explore_weight: float = 1.0,
        max_neighbours: Optional[int] = 100,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ):
        """(contexts [M, 2 window_size], words [M]) skipgram pairs of walks
        from `batch_size` uniform starts, `iterations` walks each."""
        from ..ops.walks import node2vec_batch

        tg = self._device_graph(device)
        generator = torch.Generator(device=tg.device).manual_seed(int(random_state))
        starts = torch.randint(0, self.number_of_nodes, (batch_size,), generator=generator,
                               device=tg.device, dtype=torch.int32)
        contexts, words = node2vec_batch(
            tg, starts, walk_length, window_size, generator, iterations=iterations,
            return_weight=return_weight, explore_weight=explore_weight,
            max_neighbours=max_neighbours,
        )
        return contexts.cpu().numpy(), words.cpu().numpy()

    def get_edge_prediction_mini_batch(
        self,
        random_state: int,
        batch_size: int,
        negative_samples_rate: float = 0.5,
        use_scale_free_distribution: bool = True,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ):
        """(sources, destinations, labels): uniform arcs labelled 1, then
        round(batch_size * negative_samples_rate) negatives labelled 0."""
        from ..ops.negatives import edge_prediction_mini_batch

        tg = self._device_graph(device)
        src, dst, labels = edge_prediction_mini_batch(
            tg, torch.Generator(device=tg.device).manual_seed(int(random_state)), batch_size,
            negative_samples_rate=negative_samples_rate,
            use_scale_free_distribution=use_scale_free_distribution,
        )
        return src.cpu().numpy(), dst.cpu().numpy(), labels.cpu().numpy()

    def _siamese_mini_batch(self, random_state, batch_size, with_edge_types, device):
        from ..ops.negatives import siamese_mini_batch

        tg = self._device_graph(device)
        out = siamese_mini_batch(
            tg, torch.Generator(device=tg.device).manual_seed(int(random_state)), batch_size,
            with_edge_types=with_edge_types,
        ).cpu().numpy()
        return tuple(out)

    def get_siamese_mini_batch(self, random_state: int, batch_size: int,
                               device: Union[str, torch.device] = "cuda"):
        """(sources, destinations, corrupted sources, corrupted
        destinations)."""
        return self._siamese_mini_batch(random_state, batch_size, False, device)

    def get_siamese_mini_batch_with_edge_types(self, random_state: int, batch_size: int,
                                               device: Union[str, torch.device] = "cuda"):
        """The siamese batch and the arcs' edge types."""
        return self._siamese_mini_batch(random_state, batch_size, True, device)

    def get_edge_prediction_chunk_mini_batch(
        self, chunk_index: int, graph=None, batch_size: int = 2 ** 15, **kwargs
    ):
        """The arcs of `graph` (default: this graph) in fixed chunks, in
        CSR order."""
        g = graph if graph is not None else self
        lo = chunk_index * batch_size
        hi = min(lo + batch_size, g.number_of_directed_edges)
        return g.sources[lo:hi], np.asarray(g.col_idx)[lo:hi]
