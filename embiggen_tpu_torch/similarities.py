"""DAG Resnik information-content similarity — counterpart of
`embiggen_tpu/similarities.py`: fit on a DAG whose arcs point child ->
parent, with optional node counts or frequencies, then query bipartite or
clique similarity matrices by node ids, names or prefixes, with an optional
minimum similarity.

IC(n) = -log(p(n)), p(n) the frequency mass of n's descendants (n
included); sim(a, b) is the IC of their most informative common ancestor
(MICA). Host numpy, as in the reference: the ancestor closure is packed
bitsets built by one `np.bitwise_or.at` a topological level. Up to
`_BITSET_MAX_NODES` nodes the bit columns are reordered by decreasing IC,
so that a pair's MICA is the first set bit of the AND of its rows; above
it the closure is a CSR of ancestor lists ranked by IC, queried by the
native two-pointer merge (`native.dag_mica_block`).

`return_similarities_dataframe=True` needs pandas, imported there.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import native
from .graph.graph import Graph

# First-set-bit (counting from the MSB, matching np.unpackbits order) per
# byte value; 8 for the zero byte (no bit set).
_MSB_LUT = np.full(256, 8, dtype=np.int64)
for _b in range(1, 256):
    _MSB_LUT[_b] = 7 - int(_b).bit_length() + 1
del _b


def topological_levels(graph: Graph) -> List[np.ndarray]:
    """Kahn-style level decomposition of a DAG whose arcs point
    child -> parent: level 0 = roots (no parents), level k nodes have all
    parents in levels < k. Vectorized per level (no per-node Python work).
    Raises on cycles."""
    n = graph.number_of_nodes
    children = graph.sources  # arc child -> parent: child appears in sources
    parents = np.asarray(graph.col_idx)
    remaining = np.asarray(graph.degrees, dtype=np.int64).copy()  # #parents
    # children_of[p]: group arcs by parent.
    order = np.argsort(parents, kind="stable")
    sorted_parents = parents[order]
    sorted_children = np.asarray(children)[order]
    starts = np.searchsorted(sorted_parents, np.arange(n))
    ends = np.searchsorted(sorted_parents, np.arange(n) + 1)

    levels: List[np.ndarray] = []
    frontier = np.flatnonzero(remaining == 0)
    done = 0
    while len(frontier):
        levels.append(frontier)
        done += len(frontier)
        # Gather all (child) arcs out of the frontier's parents at once.
        segs = [sorted_children[starts[p]: ends[p]] for p in frontier]
        if segs:
            kids = np.concatenate(segs) if len(segs) > 1 else segs[0]
        else:
            kids = np.empty(0, np.int64)
        if len(kids):
            np.subtract.at(remaining, kids, 1)
            cand = np.unique(kids)
            frontier = cand[remaining[cand] == 0]
        else:
            frontier = np.empty(0, np.int64)
    if done != n:
        raise ValueError(
            f"graph is not a DAG: {n - done} nodes are on directed cycles"
        )
    return levels


def ancestor_bitsets(graph: Graph) -> np.ndarray:
    """Packed ancestor-closure bitsets: row v has bit a set (MSB-first,
    np.unpackbits order) iff a is an ancestor of v, including v itself.
    Arcs must point child -> parent. Shape [N, ceil(N/8)] uint8.

    Computed by one vectorized `bitwise_or.at` pass per topological level:
    anc(v) = {v} | union(anc(p) for p in parents(v)), parents finalized
    before any of their children are processed."""
    n = graph.number_of_nodes
    nb = (n + 7) // 8
    anc = np.zeros((n, nb), np.uint8)
    ids = np.arange(n)
    anc[ids, ids // 8] |= (1 << (7 - (ids % 8))).astype(np.uint8)

    levels = topological_levels(graph)
    row_ptr = np.asarray(graph.row_ptr)
    col_idx = np.asarray(graph.col_idx)
    for level in levels[1:]:
        # All (child, parent) arcs whose child sits in this level.
        counts = (row_ptr[level + 1] - row_ptr[level]).astype(np.int64)
        child_arr = np.repeat(level, counts)
        # Flatten each child's parent slice.
        idx = np.concatenate(
            [np.arange(row_ptr[v], row_ptr[v + 1]) for v in level]
        ) if len(level) else np.empty(0, np.int64)
        parent_arr = col_idx[idx]
        np.bitwise_or.at(anc, child_arr, anc[parent_arr])
    return anc


def ancestors_csr(graph: Graph):
    """Sparse boolean Z with Z[v, a] = 1 iff a is an ancestor of v (including
    v itself) — CSR view of `ancestor_bitsets` for spectral DAG metrics."""
    import scipy.sparse as sp

    n = graph.number_of_nodes
    anc = ancestor_bitsets(graph)
    rows_l, cols_l = [], []
    chunk = max(1, (1 << 26) // max(n, 1))
    for v0 in range(0, n, chunk):
        u = np.unpackbits(anc[v0: v0 + chunk], axis=1, count=n)
        r, c = np.nonzero(u)
        rows_l.append(r + v0)
        cols_l.append(c)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    return sp.csr_matrix(
        (np.ones(len(rows), np.float64), (rows, cols)), shape=(n, n)
    )


# Above this node count the packed-bitset closure ([N, N/8] bytes — 1.25 GB
# at 100k terms) is replaced by a CSR closure of size Σ|anc(v)| plus a
# threaded C++ two-pointer MICA kernel; below it the bitset layout's
# branch-free [S, D] byte ops are faster.
_BITSET_MAX_NODES = 32768


def ancestor_lists(graph: Graph) -> List[np.ndarray]:
    """Per-node ancestor id lists (including the node itself), computed by
    a topological-level sweep: anc(v) = {v} ∪ ⋃ anc(p). Memory Σ|anc(v)| —
    the scalable alternative to `ancestor_bitsets` for large ontologies."""
    n = graph.number_of_nodes
    row_ptr = np.asarray(graph.row_ptr)
    col_idx = np.asarray(graph.col_idx)
    lists: List[Optional[np.ndarray]] = [None] * n
    for level in topological_levels(graph):
        for v in level:
            ps = col_idx[row_ptr[v]: row_ptr[v + 1]]
            if len(ps) == 0:
                lists[v] = np.asarray([v], dtype=np.int64)
            elif len(ps) == 1:
                lists[v] = np.append(lists[ps[0]], v)
            else:
                lists[v] = np.unique(
                    np.concatenate(
                        [np.asarray([v], np.int64)]
                        + [lists[p] for p in ps]
                    )
                )
    return lists  # type: ignore[return-value]


class DAGResnik:
    def __init__(self, verbose: bool = False):
        self._verbose = verbose
        self._graph: Optional[Graph] = None
        self._information_content: Optional[np.ndarray] = None
        # Small-N layout: bitsets with bit columns permuted to
        # decreasing-IC order, so the first common set bit of a pair IS its
        # MICA.
        self._anc_by_ic: Optional[np.ndarray] = None
        self._ic_sorted: Optional[np.ndarray] = None
        # Large-N layout: CSR ancestor closure with row lists sorted
        # ascending by IC rank (rank 0 = most informative), served by the
        # threaded native two-pointer merge `native.dag_mica_block`.
        self._anc_indptr: Optional[np.ndarray] = None
        self._anc_ranks: Optional[np.ndarray] = None
        self._ic_by_rank: Optional[np.ndarray] = None

    def fit(
        self,
        graph: Graph,
        node_counts: Optional[Dict[str, float]] = None,
        node_frequencies: Optional[np.ndarray] = None,
    ) -> "DAGResnik":
        """Graph arcs must point child -> parent (ontology edges). Counts
        propagate from each node to all its ancestors (once per ancestor,
        independent of path multiplicity)."""
        n = graph.number_of_nodes
        if node_frequencies is not None:
            counts = np.asarray(node_frequencies, dtype=np.float64)
        elif node_counts is not None:
            counts = np.zeros(n, dtype=np.float64)
            name_to_id = graph.node_name_to_id
            for name, c in node_counts.items():
                counts[name_to_id[name]] = c
        else:
            counts = np.ones(n, dtype=np.float64)

        if n > _BITSET_MAX_NODES:
            return self._fit_csr(graph, counts)

        anc = ancestor_bitsets(graph)
        # cumulative[a] = sum over v with a in anc(v) of counts[v]:
        # chunked unpack + matvec (counts[chunk] @ unpacked[chunk, N]).
        cumulative = np.zeros(n, np.float64)
        chunk = max(1, (1 << 26) // max(n, 1))
        for v0 in range(0, n, chunk):
            u = np.unpackbits(anc[v0: v0 + chunk], axis=1, count=n)
            cumulative += counts[v0: v0 + chunk] @ u
        total = cumulative.max() if cumulative.max() > 0 else 1.0
        with np.errstate(divide="ignore"):
            ic = -np.log(np.maximum(cumulative / total, 1e-300))

        # Permute bit columns to decreasing IC and re-pack.
        perm = np.argsort(-ic, kind="stable")
        anc_by_ic = np.empty_like(anc)
        for v0 in range(0, n, chunk):
            u = np.unpackbits(anc[v0: v0 + chunk], axis=1, count=n)
            anc_by_ic[v0: v0 + chunk] = np.packbits(u[:, perm], axis=1)

        self._graph = graph
        self._information_content = ic
        self._anc_by_ic = anc_by_ic
        self._ic_sorted = ic[perm]
        return self

    def _fit_csr(self, graph: Graph, counts: np.ndarray) -> "DAGResnik":
        """Large-ontology fit: CSR ancestor closure (Σ|anc| memory, never
        N²/8 bits), cumulative counts by one scatter-add, rows re-sorted to
        ascending IC rank for the two-pointer MICA kernel."""
        n = graph.number_of_nodes
        lists = ancestor_lists(graph)
        lens = np.fromiter((len(x) for x in lists), np.int64, count=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        indices = np.concatenate(lists)
        del lists
        cumulative = np.zeros(n, np.float64)
        np.add.at(cumulative, indices, np.repeat(counts, lens))
        total = cumulative.max() if cumulative.max() > 0 else 1.0
        with np.errstate(divide="ignore"):
            ic = -np.log(np.maximum(cumulative / total, 1e-300))

        order = np.argsort(-ic, kind="stable")   # rank -> node
        rank_of = np.empty(n, np.int64)
        rank_of[order] = np.arange(n)
        ranks = rank_of[indices].astype(np.int32)
        row_ids = np.repeat(np.arange(n), lens)
        srt = np.lexsort((ranks, row_ids))       # ascending rank per row
        self._graph = graph
        self._information_content = ic
        self._anc_indptr = indptr
        self._anc_ranks = ranks[srt]
        self._ic_by_rank = ic[order]
        return self

    def _check_fitted(self):
        if self._graph is None:
            raise ValueError("DAGResnik must be fitted first.")

    def get_information_content(self) -> np.ndarray:
        self._check_fitted()
        return self._information_content

    def _mica_block(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Vectorized [|S|, |D|] MICA-IC matrix. Small graphs: AND the
        IC-ordered bitsets, locate the first nonzero byte per pair, then the
        first set bit via the MSB lookup table. Large graphs: the native
        two-pointer merge over the rank-sorted CSR closure
        (`native.dag_mica_block`)."""
        if self._anc_by_ic is None:
            return native.dag_mica_block(
                self._anc_indptr, self._anc_ranks, self._ic_by_rank,
                np.asarray(src, np.int64), np.asarray(dst, np.int64),
            )
        A = self._anc_by_ic[src]  # [S, nb]
        B = self._anc_by_ic[dst]  # [D, nb]
        n_s, n_d, nb = len(src), len(dst), A.shape[1]
        sim = np.zeros((n_s, n_d), np.float64)
        # Chunk rows so the [c, D, nb] AND block stays ~64MB.
        chunk = max(1, (1 << 26) // max(n_d * nb, 1))
        ic_s = self._ic_sorted
        for i0 in range(0, n_s, chunk):
            common = A[i0: i0 + chunk, None, :] & B[None, :, :]
            nz = common != 0
            any_nz = nz.any(axis=-1)
            first_byte = nz.argmax(axis=-1)
            byte_vals = np.take_along_axis(
                common, first_byte[..., None], axis=-1
            )[..., 0]
            pos = first_byte * 8 + _MSB_LUT[byte_vals]
            pos = np.minimum(pos, len(ic_s) - 1)
            sim[i0: i0 + chunk] = np.where(any_nz, ic_s[pos], 0.0)
        return sim

    def get_similarity_from_node_ids(self, a: int, b: int) -> float:
        self._check_fitted()
        return float(
            self._mica_block(np.asarray([a]), np.asarray([b]))[0, 0]
        )

    def get_similarities_from_bipartite_graph_node_ids(
        self,
        source_node_ids,
        destination_node_ids,
        minimum_similarity: Optional[float] = None,
        return_similarities_dataframe: bool = False,
    ):
        """[|S|, |D|] similarity matrix, or a tidy (source, destination,
        similarity) DataFrame filtered at minimum_similarity."""
        self._check_fitted()
        src = np.asarray(source_node_ids, dtype=np.int64)
        dst = np.asarray(destination_node_ids, dtype=np.int64)
        sim = self._mica_block(src, dst)
        if return_similarities_dataframe:
            import pandas as pd

            names = self._graph.get_node_names()
            ii, jj = np.meshgrid(
                np.arange(len(src)), np.arange(len(dst)), indexing="ij"
            )
            df = pd.DataFrame(
                {
                    "source": names[src[ii.reshape(-1)]],
                    "destination": names[dst[jj.reshape(-1)]],
                    "resnik_score": sim.reshape(-1),
                }
            )
            if minimum_similarity is not None:
                df = df[df.resnik_score >= minimum_similarity]
            return df
        if minimum_similarity is not None:
            sim = np.where(sim >= minimum_similarity, sim, 0.0)
        return sim

    def get_similarities_from_bipartite_graph_node_names(
        self, source_node_names, destination_node_names, **kwargs
    ):
        self._check_fitted()
        return self.get_similarities_from_bipartite_graph_node_ids(
            self._graph.get_node_ids_from_names(source_node_names),
            self._graph.get_node_ids_from_names(destination_node_names),
            **kwargs,
        )

    def get_similarities_from_bipartite_graph_node_prefixes(
        self, source_node_prefixes, destination_node_prefixes, **kwargs
    ):
        self._check_fitted()
        names = self._graph.get_node_names()

        def match(prefixes):
            return np.asarray(
                [
                    i
                    for i, n in enumerate(names)
                    if any(n.startswith(p) for p in prefixes)
                ]
            )

        return self.get_similarities_from_bipartite_graph_node_ids(
            match(source_node_prefixes), match(destination_node_prefixes),
            **kwargs,
        )

    def get_similarities_from_clique_graph_node_ids(self, node_ids, **kwargs):
        return self.get_similarities_from_bipartite_graph_node_ids(
            node_ids, node_ids, **kwargs
        )

    def get_similarities_from_clique_graph_node_names(self, node_names, **kwargs):
        self._check_fitted()
        ids = self._graph.get_node_ids_from_names(node_names)
        return self.get_similarities_from_clique_graph_node_ids(ids, **kwargs)
