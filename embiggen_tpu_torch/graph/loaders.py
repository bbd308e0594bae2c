"""Graph loaders — counterpart of `embiggen_tpu/graph/loaders.py`: edge-list
files, pandas DataFrames (`from_pandas`, which needs pandas) and named
datasets.

`from_csv` reads with the native parser (`native.parse_edge_list`; the
standard library's `csv` module for a gzipped file, no pandas) and numbers
node names and edge types in sorted order, as the reference's `from_pandas`
does, or in order of first appearance, as the reference's `from_csv` does
by default.
Named corpora resolve from a local file or, when asked, from a
deterministic synthetic stand-in of their published size; the
bundled graphs are Zachary's karate club, with its two communities as node
types, and the reference's STRING PPI fixture, whose edges are labelled.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Optional

import numpy as np

from .. import native
from .graph import Graph


def _sorted_ids(names: np.ndarray, ids: np.ndarray):
    """(names, ids) renumbered from first appearance to sorted order."""
    order = np.argsort(names.astype(str), kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return names[order], rank[ids]


def from_pandas(
    df,
    source_column: str = "subject",
    destination_column: str = "object",
    weight_column: Optional[str] = None,
    edge_type_column: Optional[str] = None,
    directed: bool = False,
    name: str = "Graph",
) -> Graph:
    """The graph of a DataFrame's edge list: node names (and edge types)
    as strings, numbered in sorted order; the weight and edge type columns
    are read when the frame has them."""
    src_names = df[source_column].astype(str).to_numpy()
    dst_names = df[destination_column].astype(str).to_numpy()
    all_names, inverse = np.unique(np.concatenate([src_names, dst_names]),
                                   return_inverse=True)
    weights = edge_types = edge_type_names = None
    if weight_column is not None and weight_column in df.columns:
        weights = df[weight_column].astype(np.float32).to_numpy()
    if edge_type_column is not None and edge_type_column in df.columns:
        edge_type_names, edge_types = np.unique(
            df[edge_type_column].astype(str).to_numpy(), return_inverse=True)
        edge_types = edge_types.astype(np.int32)
    return Graph.from_edge_arrays(
        inverse[: len(src_names)], inverse[len(src_names):], n_nodes=len(all_names),
        weights=weights, edge_types=edge_types, directed=directed, name=name,
        node_names=all_names, edge_type_names=edge_type_names,
    )


def from_csv(
    path: str,
    source_column: str = "subject",
    destination_column: str = "object",
    weight_column: Optional[str] = "weight",
    edge_type_column: Optional[str] = "edge_label",
    directed: bool = False,
    sep: str = "\t",
    name: Optional[str] = None,
    first_seen_ids: bool = False,
) -> Graph:
    """Load an edge-list file with a header row (the reference's
    `tests/data/small_ppi.tsv` layout: subject, object, weight, edge_label
    columns). Gzipped files end in `.gz`. The weight and edge-type columns
    are used when present. Node names and edge types are numbered in sorted
    order (the reference's pandas path), or with `first_seen_ids` in order
    of first appearance, a row's source before its destination (the
    reference's native parser, which its `from_csv` takes by default). The
    native parser reads an uncompressed file, the `csv` module
    (`native.parse_edge_list_plain`) a gzipped one."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        header = f.readline().rstrip("\n").rstrip("\r").split(sep)
    cols = {c: i for i, c in enumerate(header)}
    for column in (source_column, destination_column):
        if column not in cols:
            raise ValueError(f"{path} has no column {column!r}; its header is "
                             f"{header}.")
    parse = native.parse_edge_list_plain if path.endswith(".gz") else native.parse_edge_list
    src, dst, weights, edge_types, node_names, edge_type_names = parse(
        path, sep=sep, skip_header=True, src_col=cols[source_column],
        dst_col=cols[destination_column],
        weight_col=cols.get(weight_column, -1) if weight_column is not None else -1,
        type_col=cols.get(edge_type_column, -1) if edge_type_column is not None else -1)
    if not first_seen_ids:
        node_names, ends = _sorted_ids(node_names, np.stack([src, dst]))
        src, dst = ends
        if edge_types is not None:
            edge_type_names, edge_types = _sorted_ids(edge_type_names, edge_types)
    return Graph.from_edge_arrays(
        src,
        dst,
        n_nodes=len(node_names),
        weights=weights,
        edge_types=edge_types,
        directed=directed,
        name=name or path.rsplit("/", 1)[-1].split(".")[0],
        node_names=node_names,
        edge_type_names=edge_type_names,
    )


_ZKC_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]
_ZKC_COMMUNITY = [
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
]


def karate_club() -> Graph:
    """Zachary's karate club, with its two communities as node types."""
    src, dst = np.asarray(_ZKC_EDGES).T
    return Graph.from_edge_arrays(
        src, dst, n_nodes=34, directed=False, name="KarateClub",
        node_type_ptr=np.arange(35, dtype=np.int64),
        node_type_ids=np.asarray(_ZKC_COMMUNITY, dtype=np.int32),
        node_type_names=["Mr. Hi", "Officer"],
    )


def small_ppi(path: Optional[str] = None) -> Graph:
    """The reference's STRING PPI fixture (3,000 weighted edges labelled by
    type), from `path` or the repository's `tests/data/small_ppi.tsv`,
    numbered as the reference's default parser numbers it."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests", "data", "small_ppi.tsv")
    if not os.path.exists(path):
        raise FileNotFoundError(f"small_ppi.tsv not found at {path}")
    return from_csv(path, name="SmallPPI", first_seen_ids=True)


_DATASETS = {
    "karateclub": karate_club,
    "smallppi": small_ppi,
}


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """A named corpus of the reference's dataset registries, with its
    published size. Without network access it resolves from a local edge
    list (`path=`, `$EMBIGGEN_DATA_DIR/<Name>.tsv` or
    `./datasets/<Name>.tsv`) or, with `synthetic_fallback=True`, from a
    deterministic generated graph of the same size, renamed
    "<Name>SyntheticStandIn"."""

    name: str
    repository: str
    n_nodes: int
    n_edges: int
    n_node_types: int = 0
    weighted: bool = False
    directed: bool = False

    def synthetic(self) -> Graph:
        """A corpus with node types stands in as a planted partition with
        one community per type, at about its published density; any other
        as a Barabasi-Albert graph of its mean degree (weighted when it
        is)."""
        from . import generators

        stand_in = f"{self.name}SyntheticStandIn"
        if self.n_node_types > 1:
            density = 2.0 * self.n_edges / max(self.n_nodes, 1) ** 2
            return generators.planted_partition(
                n_nodes=self.n_nodes, n_communities=self.n_node_types,
                p_in=min(1.0, 4.0 * density * self.n_node_types),
                p_out=min(1.0, 0.4 * density), seed=42, name=stand_in)
        m = max(1, self.n_edges // max(self.n_nodes, 1))
        g = generators.barabasi_albert(self.n_nodes, m, seed=42)
        if self.weighted:
            rng = np.random.default_rng(7)
            g = dataclasses.replace(g, weights=(
                0.5 + rng.random(g.number_of_directed_edges)).astype(np.float32))
        return dataclasses.replace(g, name=stand_in)


# Published sizes of the corpora the reference's tests and docs use.
_NAMED_CORPORA = {
    "cora": DatasetSpec("Cora", "linqs", 2708, 5429, n_node_types=7),
    "citeseer": DatasetSpec("CiteSeer", "linqs", 3327, 4732, n_node_types=6),
    "pubmeddiabetes": DatasetSpec(
        "PubMedDiabetes", "linqs", 19717, 44338, n_node_types=3),
    "cio": DatasetSpec("CIO", "kgobo", 829, 1083, n_node_types=2),
    "usair97": DatasetSpec(
        "Usair97", "networkrepository", 332, 2126, weighted=True),
    "homosapiens": DatasetSpec(
        "HomoSapiens", "string", 19566, 5879727, weighted=True),
}


def _local_corpus_path(name: str) -> Optional[str]:
    data_dir = os.environ.get("EMBIGGEN_DATA_DIR")
    for base in ([data_dir] if data_dir else []) + ["datasets"]:
        for ext in (".tsv", ".csv", ".edges"):
            cand = os.path.join(base, name + ext)
            if os.path.exists(cand):
                return cand
    return None


def get_dataset(
    name: str,
    repository: Optional[str] = None,
    path: Optional[str] = None,
    synthetic_fallback: bool = False,
    **kwargs,
) -> Graph:
    """A graph by name: a bundled graph, "Synthetic..." (a seeded
    Barabasi-Albert graph of 10,000 nodes), or a named corpus from a local
    file or its synthetic stand-in (see `DatasetSpec`). Downloads are not
    available."""
    key = name.replace("_", "").replace("-", "").lower()
    if key in _DATASETS:
        return _DATASETS[key](**kwargs)
    from . import generators

    if key.startswith("synthetic"):
        return generators.barabasi_albert(10_000, 10, seed=42)
    if key in _NAMED_CORPORA:
        spec = _NAMED_CORPORA[key]
        if repository is not None and repository.lower() != spec.repository:
            raise KeyError(f"{spec.name} lives in repository "
                           f"{spec.repository!r}, not {repository!r}")
        p = path or _local_corpus_path(spec.name)
        if p is not None:
            return from_csv(p, name=spec.name, **kwargs)
        if synthetic_fallback:
            return spec.synthetic()
        raise FileNotFoundError(
            f"Dataset {spec.name!r} ({spec.repository}) is registered but "
            "cannot be downloaded. Provide the edge list via `path=`, put it "
            f"at $EMBIGGEN_DATA_DIR/{spec.name}.tsv or "
            f"./datasets/{spec.name}.tsv, or pass synthetic_fallback=True "
            "for a deterministic stand-in of the same size.")
    raise KeyError(
        f"Unknown dataset {name!r}. Available: "
        f"{sorted(_DATASETS) + sorted(_NAMED_CORPORA)}, or load a file with "
        "embiggen_tpu_torch.graph.from_csv.")
