"""Graph convolution kernels (normalized adjacency matrices) in COO form —
counterpart of `embiggen_tpu/graph/laplacians.py`, with the same 13 kernel
names (the "Trasposed" spelling is accepted as an alias)."""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from .graph import Graph

MULTIGRAPH_POLICIES = ("drop", "warn", "raise")

KERNELS = [
    "Weights",
    "Left Normalized Laplacian",
    "Right Normalized Laplacian",
    "Symmetric Normalized Laplacian",
    "Transposed Left Normalized Laplacian",
    "Transposed Right Normalized Laplacian",
    "Transposed Symmetric Normalized Laplacian",
    "Weighted Left Normalized Laplacian",
    "Weighted Right Normalized Laplacian",
    "Weighted Symmetric Normalized Laplacian",
    "Transposed Weighted Left Normalized Laplacian",
    "Transposed Weighted Right Normalized Laplacian",
    "Transposed Weighted Symmetric Normalized Laplacian",
]


def validate_convolution_graph(
    graph: Graph, handling_multi_graph: str = "warn"
) -> None:
    """Singleton and multigraph guards for propagation kernels.

    Multigraph policy: "drop" deduplicates parallel arcs silently, "warn"
    warns and deduplicates, "raise" refuses (the deduplication itself is in
    `kernel_coo`). A singleton node only warns: its row of the kernel is
    empty and convolves to zeros."""
    if handling_multi_graph not in MULTIGRAPH_POLICIES:
        raise ValueError(
            f"handling_multi_graph must be one of {MULTIGRAPH_POLICIES}, "
            f"got {handling_multi_graph!r}."
        )
    if graph.has_singleton_nodes():
        warnings.warn(
            f"The provided graph {graph.name!r} has "
            f"{graph.get_number_of_singleton_nodes()} singleton nodes; "
            "their convolved representations are zero vectors. Consider "
            "removing singleton nodes or adding selfloops."
        )
    if graph.is_multigraph():
        message = (
            "The GCN propagation kernels do not support multigraphs: "
            "parallel arcs are deduplicated before building the "
            "adjacency matrix."
        )
        if handling_multi_graph == "warn":
            warnings.warn(message)
        elif handling_multi_graph == "raise":
            raise ValueError(message)


def _base_values(graph: Graph, weighted: bool) -> np.ndarray:
    if weighted:
        if graph.weights is None:
            raise ValueError(
                f"Kernel requires edge weights but graph {graph.name} has none."
            )
        return graph.weights.astype(np.float64)
    return np.ones(graph.number_of_directed_edges, dtype=np.float64)


def kernel_coo(
    graph: Graph, kernel: str = "Symmetric Normalized Laplacian",
    handling_multi_graph: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, values) of the requested propagation kernel.

    Normalizations use the (weighted) degrees of the adjacency:
      Left:  D^-1 A      Right: A D^-1      Symmetric: D^-1/2 A D^-1/2
    "Transposed" swaps rows and cols, so its rows are not sorted. Parallel
    arcs are always deduplicated (keep first)."""
    if handling_multi_graph is not None:
        validate_convolution_graph(graph, handling_multi_graph)
    name = kernel.replace("Trasposed", "Transposed")
    if name not in KERNELS:
        raise ValueError(f"Unknown kernel {kernel!r}; supported: {KERNELS}")
    transposed = name.startswith("Transposed ")
    core = name.removeprefix("Transposed ")
    weighted = core.startswith("Weighted ") or core == "Weights"
    core = core.removeprefix("Weighted ")

    rows = graph.sources.astype(np.int64)
    cols = graph.col_idx.astype(np.int64)
    vals = _base_values(graph, weighted)
    if len(rows):
        # CSR arcs are (row, col)-sorted: parallel arcs are adjacent.
        keep = np.concatenate(
            [[True], (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])]
        )
        if not keep.all():
            rows, cols, vals = rows[keep], cols[keep], vals[keep]

    if core != "Weights":
        deg = np.zeros(graph.number_of_nodes, dtype=np.float64)
        np.add.at(deg, rows, vals)
        in_deg = np.zeros(graph.number_of_nodes, dtype=np.float64)
        np.add.at(in_deg, cols, vals)
        with np.errstate(divide="ignore"):
            if core == "Left Normalized Laplacian":
                inv = np.where(deg > 0, 1.0 / deg, 0.0)
                vals = vals * inv[rows]
            elif core == "Right Normalized Laplacian":
                inv = np.where(in_deg > 0, 1.0 / in_deg, 0.0)
                vals = vals * inv[cols]
            elif core == "Symmetric Normalized Laplacian":
                inv_s = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
                inv_d = np.where(in_deg > 0, 1.0 / np.sqrt(in_deg), 0.0)
                vals = vals * inv_s[rows] * inv_d[cols]
            else:
                raise AssertionError(core)

    if transposed:
        rows, cols = cols, rows

    if np.isnan(vals).any():
        raise ValueError(f"Kernel {kernel!r} produced NaN values.")
    return rows, cols, vals.astype(np.float32)
