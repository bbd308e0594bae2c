"""Graph loaders — counterpart of `embiggen_tpu/graph/loaders.py`: edge-list
files and named datasets.

`from_csv` parses with the standard library's `csv` module (no pandas, no
native parser); node names are numbered in sorted order, as the reference's
`from_pandas` does. Named corpora resolve from a local file or, when asked,
from a deterministic synthetic stand-in of their published size. The port's
`Graph` has no node or edge types yet (ROADMAP A6), so the typed datasets
(`karate_club`, `small_ppi`, the typed stand-ins) and an edge-type column
raise NotImplementedError naming it.
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import os
from typing import Optional

import numpy as np

from .graph import Graph


def _needs_types(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs node or edge types, which the port's Graph does not "
        "have yet (ROADMAP A6).")


def from_csv(
    path: str,
    source_column: str = "subject",
    destination_column: str = "object",
    weight_column: Optional[str] = "weight",
    edge_type_column: Optional[str] = "edge_label",
    directed: bool = False,
    sep: str = "\t",
    name: Optional[str] = None,
) -> Graph:
    """Load an edge-list file with a header row (the reference's
    `tests/data/small_ppi.tsv` layout: subject, object, weight, edge_label
    columns). Gzipped files end in `.gz`. The weight column is used when
    present; an edge-type column that is present raises (ROADMAP A6)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader)
        rows = [r for r in reader if r]
    cols = {c: i for i, c in enumerate(header)}
    for column in (source_column, destination_column):
        if column not in cols:
            raise ValueError(f"{path} has no column {column!r}; its header is "
                             f"{header}.")
    if edge_type_column is not None and edge_type_column in cols:
        raise _needs_types(f"The edge-type column {edge_type_column!r} of {path}")
    src_names = np.asarray([r[cols[source_column]] for r in rows], dtype=str)
    dst_names = np.asarray([r[cols[destination_column]] for r in rows], dtype=str)
    all_names, inverse = np.unique(
        np.concatenate([src_names, dst_names]), return_inverse=True)
    weights = None
    if weight_column is not None and weight_column in cols:
        weights = np.asarray([r[cols[weight_column]] for r in rows],
                             dtype=np.float32)
    return Graph.from_edge_arrays(
        inverse[:len(src_names)],
        inverse[len(src_names):],
        n_nodes=len(all_names),
        weights=weights,
        directed=directed,
        name=name or path.rsplit("/", 1)[-1].split(".")[0],
        node_names=all_names.astype(object),
    )


def karate_club() -> Graph:
    """Zachary's karate club: its community labels are node types."""
    raise _needs_types("karate_club")


def small_ppi(path: Optional[str] = None) -> Graph:
    """The reference's STRING PPI fixture: its edges are labelled."""
    raise _needs_types("small_ppi")


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
        from . import generators

        if self.n_node_types > 1:
            raise _needs_types(f"The synthetic stand-in of {self.name}")
        m = max(1, self.n_edges // max(self.n_nodes, 1))
        g = generators.barabasi_albert(self.n_nodes, m, seed=42)
        if self.weighted:
            rng = np.random.default_rng(7)
            g = dataclasses.replace(g, weights=(
                0.5 + rng.random(g.number_of_directed_edges)).astype(np.float32))
        return dataclasses.replace(g, name=f"{self.name}SyntheticStandIn")


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
