"""Host graph helpers in C++ — the port's counterpart of `embiggen_tpu/native`,
cut to the functions the port's host code calls: alias tables, the spanning
forest of `connected_holdout`, the binary panel's radix argsort and sweep,
pair sorts and the first-occurrence dedup, the symmetric CSR build, the
edge-list parser, connected components and DAGResnik's MICA block.

The sources beside this file (`graph_algos.cpp`, `edge_list_parser.cpp`)
compile with g++ (`$CXX` when set) into one shared library in
`embiggen_tpu_torch/_build/`, loaded with ctypes. Nothing is built at
import: the first call builds the library, and `build()` does so
explicitly. Its name carries a hash of the sources, the compiler and the
flags, and `ops/_build.compile_shared` writes it to a temporary file that is
then renamed, so that processes building it at once each see a whole
library. A failed build or load raises with the compiler's output; there is
no fallback.

Each wrapper takes and returns numpy arrays. Beside it is its plain numpy
version (`<name>_plain`), which returns the same arrays: the package calls
the wrappers, the tests hold them against the plain versions.
"""
from __future__ import annotations

import csv
import ctypes
import functools
import gzip
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops import _build

_HERE = Path(__file__).resolve().parent
SOURCES = ("graph_algos.cpp", "edge_list_parser.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_DIR = _HERE.parent / "_build"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


class _ParsedEdgeList(ctypes.Structure):
    _fields_ = [
        ("n_edges", ctypes.c_int64),
        ("n_nodes", ctypes.c_int64),
        ("n_edge_types", ctypes.c_int64),
        ("sources", ctypes.POINTER(ctypes.c_int32)),
        ("destinations", ctypes.POINTER(ctypes.c_int32)),
        ("weights", ctypes.POINTER(ctypes.c_float)),
        ("edge_types", ctypes.POINTER(ctypes.c_int32)),
        ("node_names", ctypes.c_char_p),
        ("node_names_len", ctypes.c_int64),
        ("edge_type_names", ctypes.c_char_p),
        ("edge_type_names_len", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
    ]


_SIGNATURES = {
    "build_alias_tables": ((_P, _I64, _P, _I64, _P, _P), None),
    "spanning_forest": ((_P, _P, _P, _I64, _I64, _P), None),
    "ranking_metrics_sorted": ((_P, _P, _I64, _P, _P), None),
    "counting_sort_pairs": ((_P, _P, _I64, _I64, _P), None),
    "sort_unique_pairs": ((_P, _P, _I64, _I64, _P), ctypes.c_int64),
    "radix_argsort_u64": ((_P, _I64, _P), None),
    "build_sym_csr": ((_P, _P, _I64, _I64, _P, _P), ctypes.c_int64),
    "parse_edge_list": (
        (ctypes.c_char_p, ctypes.c_char) + (ctypes.c_int,) * 5,
        ctypes.POINTER(_ParsedEdgeList)),
    "free_parsed_edge_list": ((ctypes.POINTER(_ParsedEdgeList),), None),
    "connected_components": ((_P, _P, _I64, _I64, _P), ctypes.c_int64),
    "dag_mica_block": ((_P, _P, _P, _P, _I64, _P, _I64, ctypes.c_int, _P), None),
}

_libs: Dict[Path, ctypes.CDLL] = {}


def compiler() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def _digest(cxx: str) -> str:
    return _build.digest((cxx,) + CXX_FLAGS, [_HERE / name for name in SOURCES])


def library_path() -> Path:
    return Path(BUILD_DIR) / f"libembiggen_host_{_digest(compiler())}.so"


def build() -> float:
    """Compile the library (unless an up-to-date one exists) and load it.
    Returns the seconds spent."""
    t0 = time.perf_counter()

    def compile_to(tmp: Path) -> None:
        cmd = [compiler(), *CXX_FLAGS, *(str(_HERE / s) for s in SOURCES),
               "-o", str(tmp), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}")

    so = library_path()
    _libs[so] = _build.compile_shared(so, compile_to, _SIGNATURES)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    so = library_path()
    if so not in _libs:
        build()
    return _libs[so]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check_ids(name: str, a: np.ndarray, upper: int) -> None:
    """Raise unless every entry of `a` lies in [0, upper): the C++ indexes
    arrays with them."""
    if a.size and (int(a.min()) < 0 or int(a.max()) >= upper):
        raise ValueError(f"{name} holds ids outside [0, {upper}): "
                         f"[{int(a.min())}, {int(a.max())}].")


def _pairs(src, dst, n_nodes: int, dtype) -> Tuple[np.ndarray, np.ndarray]:
    src = np.ascontiguousarray(src, dtype=dtype)
    dst = np.ascontiguousarray(dst, dtype=dtype)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be equal 1-D shapes.")
    _check_ids("src", src, n_nodes)
    _check_ids("dst", dst, n_nodes)
    return src, dst


# ---------------------------------------------------------------- alias tables
def _alias_inputs(row_ptr, weights) -> Tuple[np.ndarray, np.ndarray]:
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    if (row_ptr.ndim != 1 or row_ptr.shape[0] < 1 or row_ptr[0] != 0
            or row_ptr[-1] != weights.shape[0] or bool((np.diff(row_ptr) < 0).any())):
        raise ValueError("row_ptr must rise from 0 to the number of weights.")
    return row_ptr, weights


def alias_tables(row_ptr, weights) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables of every row's neighbour distribution: (prob [E]
    float32, alias [E] int32 offsets inside the row), aligned with col_idx."""
    row_ptr, weights = _alias_inputs(row_ptr, weights)
    e = weights.shape[0]
    prob = np.empty(e, dtype=np.float32)
    alias = np.empty(e, dtype=np.int32)
    library().build_alias_tables(_ptr(row_ptr), row_ptr.shape[0] - 1, _ptr(weights), e,
                                 _ptr(prob), _ptr(alias))
    return prob, alias


def alias_tables_plain(row_ptr, weights) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of `alias_tables`, in the same float64 arithmetic:
    rows whose scaled weights are all within 1e-12 of 1 resolve vectorized
    to the identity; the others run the two-stack pairing loop."""
    row_ptr, weights = _alias_inputs(row_ptr, weights)
    n_edges = weights.shape[0]
    prob = np.ones(n_edges, dtype=np.float32)
    degrees = np.diff(row_ptr)
    row_of_edge = np.repeat(np.arange(len(degrees)), degrees)
    row_sums = np.zeros(len(degrees), dtype=np.float64)
    np.add.at(row_sums, row_of_edge, weights.astype(np.float64))
    safe = np.where(row_sums <= 0, 1.0, row_sums)
    scaled = weights.astype(np.float64) * (degrees / safe)[row_of_edge]
    alias = (np.arange(n_edges, dtype=np.int64)
             - np.repeat(row_ptr[:-1], degrees)).astype(np.int32)
    for r in np.unique(row_of_edge[np.abs(scaled - 1.0) > 1e-12]):
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


# ------------------------------------------------------------- spanning forest
def _forest_inputs(src, dst, order, n_nodes):
    src, dst = _pairs(src, dst, n_nodes, np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if order.shape != src.shape:
        raise ValueError(f"order {order.shape} must have src's shape {src.shape}.")
    _check_ids("order", order, src.shape[0])
    return src, dst, order


def spanning_forest(src, dst, order, n_nodes: int) -> np.ndarray:
    """bool [m] mask of the edges (src[i], dst[i]) that join a union-find
    forest when taken in `order`."""
    src, dst, order = _forest_inputs(src, dst, order, int(n_nodes))
    out = np.empty(src.shape[0], dtype=np.uint8)
    library().spanning_forest(_ptr(src), _ptr(dst), _ptr(order), src.shape[0],
                              int(n_nodes), _ptr(out))
    return out.view(bool)


def spanning_forest_plain(src, dst, order, n_nodes: int) -> np.ndarray:
    """Plain version of `spanning_forest`: the Python union-find."""
    src, dst, order = _forest_inputs(src, dst, order, int(n_nodes))
    parent = list(range(int(n_nodes)))

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    in_forest = np.zeros(len(src), dtype=bool)
    src_l, dst_l = src.tolist(), dst.tolist()
    for e in order.tolist():
        a, b = find(src_l[e]), find(dst_l[e])
        if a != b:
            parent[a] = b
            in_forest[e] = True
    return in_forest


# ----------------------------------------------------------- the binary panel
def radix_argsort(keys) -> np.ndarray:
    """Stable ascending argsort (int64) of unsigned 64-bit keys by LSD radix;
    byte passes that are constant over the keys are skipped."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    order = np.empty(keys.shape[0], dtype=np.int64)
    library().radix_argsort_u64(_ptr(keys), keys.shape[0], _ptr(order))
    return order


def radix_argsort_plain(keys) -> np.ndarray:
    """Plain version of `radix_argsort`."""
    return np.argsort(np.asarray(keys, dtype=np.uint64), kind="stable")


def _sorted_inputs(scores_asc, labels_asc):
    scores_asc = np.ascontiguousarray(scores_asc, dtype=np.float64)
    labels_asc = np.ascontiguousarray(labels_asc, dtype=bool)
    if scores_asc.shape != labels_asc.shape or scores_asc.ndim != 1:
        raise ValueError("scores and labels must be equal 1-D shapes.")
    return scores_asc, labels_asc


def ranking_metrics_sorted(scores_asc, labels_asc) -> Tuple[float, float]:
    """(AUROC, AUPRC) of scores sorted ascending and their labels: AUROC the
    Mann-Whitney statistic with midrank ties, AUPRC the step integral of
    sklearn's `average_precision_score` with tied scores as one threshold.
    AUROC is NaN without positives or without negatives; AUPRC NaN without
    positives and 1 without negatives."""
    scores_asc, labels_asc = _sorted_inputs(scores_asc, labels_asc)
    auroc, auprc = ctypes.c_double(), ctypes.c_double()
    library().ranking_metrics_sorted(_ptr(scores_asc), _ptr(labels_asc.view(np.uint8)),
                                     scores_asc.shape[0], ctypes.addressof(auroc),
                                     ctypes.addressof(auprc))
    return float(auroc.value), float(auprc.value)


def ranking_metrics_sorted_plain(scores_asc, labels_asc) -> Tuple[float, float]:
    """Plain numpy version of `ranking_metrics_sorted`."""
    scores, labels = _sorted_inputs(scores_asc, labels_asc)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan"), float("nan") if n_pos == 0 else 1.0
    grp = np.concatenate([[0], np.cumsum(scores[1:] != scores[:-1])])
    counts = np.bincount(grp)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # A tie group at sorted positions [a, a + c) has midrank a + (c + 1) / 2.
    mid = starts[grp] + (counts[grp] + 1) / 2.0
    auroc = (mid[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    # Descending, the last position of each tied threshold.
    desc_labels = labels[::-1].astype(np.float64)
    tp = np.cumsum(desc_labels)
    fp = np.cumsum(1.0 - desc_labels)
    idx = np.concatenate([np.nonzero(np.diff(scores[::-1]))[0], [len(scores) - 1]])
    tp, fp = tp[idx], fp[idx]
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(auroc), float(np.sum((recall - recall_prev) * precision))


# ------------------------------------------------------------ pairs and CSRs
def sort_pairs(src, dst, n_nodes: int) -> np.ndarray:
    """Stable argsort (int64) of the pairs (src[i], dst[i]) by source, then
    destination: two counting-sort passes."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int64)
    order = np.empty(src.shape[0], dtype=np.int64)
    library().counting_sort_pairs(_ptr(src), _ptr(dst), src.shape[0], int(n_nodes),
                                  _ptr(order))
    return order


def sort_pairs_plain(src, dst, n_nodes: int) -> np.ndarray:
    """Plain version of `sort_pairs`."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int64)
    return np.argsort(src * max(int(n_nodes), 1) + dst, kind="stable")


def sort_unique_pairs(src, dst, n_nodes: int) -> np.ndarray:
    """Indices (int64) of the first occurrence of each distinct pair
    (src[i], dst[i]), in the pairs' sorted order."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int64)
    first = np.empty(src.shape[0], dtype=np.int64)
    k = library().sort_unique_pairs(_ptr(src), _ptr(dst), src.shape[0], int(n_nodes),
                                    _ptr(first))
    return first[:k].copy()


def sort_unique_pairs_plain(src, dst, n_nodes: int) -> np.ndarray:
    """Plain version of `sort_unique_pairs`: `np.unique` of the pair keys."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int64)
    return np.unique(src * max(int(n_nodes), 1) + dst, return_index=True)[1].astype(np.int64)


def build_sym_csr(src, dst, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(row_ptr int64 [N + 1], col_idx int32) of the undirected graph of the
    pairs: both arcs of each pair (one of a self-loop), each row sorted and
    without repeats."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int32)
    row_ptr = np.empty(int(n_nodes) + 1, dtype=np.int64)
    col_idx = np.empty(max(2 * src.shape[0], 1), dtype=np.int32)
    n_arcs = library().build_sym_csr(_ptr(src), _ptr(dst), src.shape[0], int(n_nodes),
                                     _ptr(row_ptr), _ptr(col_idx))
    return row_ptr, col_idx[:n_arcs].copy()


def build_sym_csr_plain(src, dst, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of `build_sym_csr`: symmetrize, then `np.unique`
    of the arc keys with `return_index`, the port's call before the native
    build, which sorts (without it, NumPy 2.3 may hash the keys instead,
    many times slower on 20M distinct keys)."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int64)
    n = max(int(n_nodes), 1)
    non_loop = src != dst
    keys, _ = np.unique(np.concatenate([src, dst[non_loop]]) * n
                        + np.concatenate([dst, src[non_loop]]), return_index=True)
    counts = np.bincount(keys // n, minlength=int(n_nodes))
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return row_ptr, (keys % n).astype(np.int32)


# ---------------------------------------------------------- edge-list parser
Parsed = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
               np.ndarray, Optional[np.ndarray]]


def parse_edge_list(path: str, sep: str = "\t", skip_header: bool = True,
                    src_col: int = 0, dst_col: int = 1, weight_col: int = -1,
                    type_col: int = -1) -> Parsed:
    """(src int32, dst int32, weights float32 or None, edge types int32 or
    None, node names, edge type names or None) of an uncompressed edge-list
    file, columns by index (-1: absent). Nodes and edge types are numbered
    in order of first appearance, a row's source before its destination;
    rows lacking a column asked for, or with an empty source or
    destination, are skipped."""
    if len(sep.encode()) != 1:
        raise ValueError(f"The separator must be one byte, not {sep!r}.")
    lib = library()
    parsed = lib.parse_edge_list(os.fsencode(path), sep.encode(), int(skip_header),
                                 src_col, dst_col, weight_col, type_col)
    try:
        p = parsed.contents
        if p.error:
            raise OSError(p.error.decode())
        e = p.n_edges

        def ints(ptr):
            return np.ctypeslib.as_array(ptr, shape=(e,)).copy() if e else np.zeros(0, np.int32)

        def names(ptr, length):
            return np.asarray(ctypes.string_at(ptr, length).decode().split("\n")[:-1],
                              dtype=object)

        weights = None
        if weight_col >= 0:
            weights = (np.ctypeslib.as_array(p.weights, shape=(e,)).copy() if e
                       else np.zeros(0, np.float32))
        return (ints(p.sources), ints(p.destinations), weights,
                ints(p.edge_types) if type_col >= 0 else None,
                names(p.node_names, p.node_names_len),
                names(p.edge_type_names, p.edge_type_names_len) if type_col >= 0 else None)
    finally:
        lib.free_parsed_edge_list(parsed)


def parse_edge_list_plain(path: str, sep: str = "\t", skip_header: bool = True,
                          src_col: int = 0, dst_col: int = 1, weight_col: int = -1,
                          type_col: int = -1) -> Parsed:
    """Plain version of `parse_edge_list`: the standard library's `csv`
    reader (which also reads files ending in `.gz`)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        if skip_header:
            next(reader, None)
        max_col = max(src_col, dst_col, weight_col, type_col)
        rows = [r for r in reader
                if len(r) > max_col and r[src_col] and r[dst_col]]
    node_ids: Dict[str, int] = {}
    type_ids: Dict[str, int] = {}
    ends = np.asarray([node_ids.setdefault(name, len(node_ids))
                       for r in rows for name in (r[src_col], r[dst_col])],
                      dtype=np.int32).reshape(-1, 2)
    weights = types = type_names = None
    if weight_col >= 0:
        weights = np.asarray([float(r[weight_col]) for r in rows], dtype=np.float32)
    if type_col >= 0:
        types = np.asarray([type_ids.setdefault(r[type_col], len(type_ids)) for r in rows],
                           dtype=np.int32)
        type_names = np.asarray(list(type_ids), dtype=object)
    return (np.ascontiguousarray(ends[:, 0]), np.ascontiguousarray(ends[:, 1]), weights,
            types, np.asarray(list(node_ids), dtype=object), type_names)


# -------------------------------------------------------- connected components
def connected_components(src, dst, n_nodes: int) -> Tuple[np.ndarray, int]:
    """(component [N] int32, number of components) of the arcs (src[i],
    dst[i]) read as undirected edges, by union-find; components are numbered
    in the order of their smallest node."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int32)
    comp = np.empty(int(n_nodes), dtype=np.int32)
    n = library().connected_components(_ptr(src), _ptr(dst), src.shape[0], int(n_nodes),
                                       _ptr(comp))
    return comp, int(n)


def connected_components_plain(src, dst, n_nodes: int) -> Tuple[np.ndarray, int]:
    """Plain version of `connected_components`: label propagation with
    pointer jumps until no label moves, then labels renumbered by first
    appearance."""
    src, dst = _pairs(src, dst, int(n_nodes), np.int64)
    labels = np.arange(int(n_nodes), dtype=np.int64)
    while True:
        new = labels.copy()
        np.minimum.at(new, src, labels[dst])
        np.minimum.at(new, dst, labels[src])
        new = new[new]
        if np.array_equal(new, labels):
            break
        labels = new
    # Each label is its component's smallest node, so np.unique's numbering
    # is the order of the components' smallest nodes.
    uniq, comp = np.unique(labels, return_inverse=True)
    return comp.astype(np.int32), int(uniq.shape[0])


# ------------------------------------------------------- DAGResnik's MICA block
def _mica_inputs(indptr, ranks, ic_by_rank, src, dst):
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    ranks = np.ascontiguousarray(ranks, dtype=np.int32)
    ic_by_rank = np.ascontiguousarray(ic_by_rank, dtype=np.float64)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    n = indptr.shape[0] - 1
    if (indptr.ndim != 1 or n < 0 or indptr[0] != 0 or indptr[-1] != ranks.shape[0]
            or bool((np.diff(indptr) < 0).any())):
        raise ValueError("indptr must rise from 0 to the number of ranks.")
    _check_ids("ranks", ranks, ic_by_rank.shape[0])
    _check_ids("src", src, n)
    _check_ids("dst", dst, n)
    return indptr, ranks, ic_by_rank, src, dst


def dag_mica_block(indptr, ranks, ic_by_rank, src, dst,
                   n_threads: Optional[int] = None) -> np.ndarray:
    """[|src|, |dst|] float64: the information content of each pair's most
    informative common ancestor, over a CSR ancestor closure (`indptr`, the
    IC `ranks` of each row's ancestors, ascending in each row) and the IC of
    each rank; 0 where two rows share no ancestor. Source rows are split
    over `n_threads` threads (default: the CPU count)."""
    indptr, ranks, ic_by_rank, src, dst = _mica_inputs(indptr, ranks, ic_by_rank, src, dst)
    out = np.empty((src.shape[0], dst.shape[0]), dtype=np.float64)
    library().dag_mica_block(_ptr(indptr), _ptr(ranks), _ptr(ic_by_rank), _ptr(src),
                             src.shape[0], _ptr(dst), dst.shape[0],
                             int(n_threads or os.cpu_count() or 1), _ptr(out))
    return out


def dag_mica_block_plain(indptr, ranks, ic_by_rank, src, dst) -> np.ndarray:
    """Plain version of `dag_mica_block`: the first entry of each pair's
    sorted intersection."""
    indptr, ranks, ic_by_rank, src, dst = _mica_inputs(indptr, ranks, ic_by_rank, src, dst)
    sim = np.zeros((src.shape[0], dst.shape[0]), np.float64)
    d_slices = [ranks[indptr[d]: indptr[d + 1]] for d in dst]
    for i, s in enumerate(src):
        s_ranks = ranks[indptr[s]: indptr[s + 1]]
        for j, d_ranks in enumerate(d_slices):
            common = np.intersect1d(s_ranks, d_ranks, assume_unique=True)
            if len(common):
                sim[i, j] = ic_by_rank[common[0]]
    return sim
