"""Synthetic graph generators — counterpart of
`embiggen_tpu/graph/generators.py`. The same numpy RNG calls in the same
order, so a seed gives the same graph as the JAX package. Edge and node
types, which the reference draws after the weights, come with typed walks
(ROADMAP A6)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import Graph


def barabasi_albert(
    n_nodes: int, m: int, seed: int = 0, name: Optional[str] = None
) -> Graph:
    """Preferential-attachment graph: each new node joins up to m distinct
    earlier nodes drawn from the list of arc endpoints, so
    degree-proportionally (the first distinct picks among 3m draws without
    replacement from that list)."""
    rng = np.random.default_rng(seed)
    repeated = list(range(m))
    sources, targets = [], []
    for v in range(m, n_nodes):
        choice = rng.choice(len(repeated), size=min(3 * m, len(repeated)),
                            replace=False)
        picked, seen = [], set()
        for c in choice:
            t = repeated[c]
            if t not in seen:
                seen.add(t)
                picked.append(t)
            if len(picked) == m:
                break
        sources.extend([v] * len(picked))
        targets.extend(picked)
        repeated.extend(picked)
        repeated.extend([v] * len(picked))
    return Graph.from_edge_arrays(
        np.asarray(sources), np.asarray(targets), n_nodes=n_nodes,
        directed=False, name=name or f"BA(n={n_nodes},m={m})",
    )


def erdos_renyi(
    n_nodes: int, n_edges: int, seed: int = 0, weighted: bool = False,
    name: Optional[str] = None,
) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=2 * n_edges)
    dst = rng.integers(0, n_nodes, size=2 * n_edges)
    keep = src != dst
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    weights = rng.uniform(0.5, 2.0, size=len(src)).astype(np.float32) if weighted else None
    return Graph.from_edge_arrays(
        src,
        dst,
        n_nodes=n_nodes,
        weights=weights,
        directed=False,
        name=name or f"ER(n={n_nodes},e={n_edges})",
    )


def planted_partition_edges(
    n_nodes: int,
    n_edges: int,
    n_communities: int = 10,
    within_fraction: float = 0.9,
    seed: int = 42,
    name: Optional[str] = None,
) -> Graph:
    """Planted-partition graph sampled by edge count in O(E): a
    `within_fraction` of the edges join two members of one community (chosen
    with weight size²), the rest join uniform pairs from different
    communities. Duplicate draws collapse, so the edge count is approximate.
    The community labels (the reference's node types) are drawn but not
    stored: node types come with ROADMAP A6."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, size=n_nodes).astype(np.int32)
    order = np.argsort(comm, kind="stable")
    sizes = np.bincount(comm, minlength=n_communities).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n_draw = int(n_edges * 1.3) + 64
    within = rng.random(n_draw) < within_fraction
    src = np.empty(n_draw, np.int64)
    dst = np.empty(n_draw, np.int64)
    n_w = int(within.sum())
    p_c = sizes.astype(np.float64) ** 2
    p_c /= p_c.sum()
    c = rng.choice(n_communities, size=n_w, p=p_c)

    def pick(cc):
        return order[starts[cc] + (rng.random(len(cc)) * sizes[cc]).astype(np.int64)]

    src[within] = pick(c)
    dst[within] = pick(c)
    n_b = n_draw - n_w
    src[~within] = rng.integers(0, n_nodes, n_b)
    dst[~within] = rng.integers(0, n_nodes, n_b)
    ok = src != dst
    ok &= within | (comm[src] != comm[dst])
    src, dst = src[ok][:n_edges], dst[ok][:n_edges]
    return Graph.from_edge_arrays(
        src, dst, n_nodes=n_nodes, directed=False,
        name=name or f"SBM(n={n_nodes},e={n_edges},k={n_communities})",
    )


def random_geometric(
    n_nodes: int = 1000,
    radius: float = 0.07,
    seed: int = 42,
    n_grid_types: int = 2,
    name: Optional[str] = None,
) -> Graph:
    """Random geometric graph: points uniform in the unit square, an edge
    between each pair closer than `radius`, and each isolated point joined
    to its nearest neighbour. Distances are learnable from walks, so link
    prediction on it has real headroom. The grid-cell labels the reference
    stores as node types (`n_grid_types`² cells) come with ROADMAP A6."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 2))
    src_l, dst_l = [], []
    chunk = max(1, (1 << 24) // n_nodes)
    for i0 in range(0, n_nodes, chunk):
        d2 = ((pts[i0: i0 + chunk, None, :] - pts[None, :, :]) ** 2).sum(-1)
        ii, jj = np.nonzero(d2 < radius * radius)
        ii = ii + i0
        keep = ii < jj
        src_l.append(ii[keep])
        dst_l.append(jj[keep])
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    deg = np.bincount(np.concatenate([src, dst]), minlength=n_nodes)
    isolated = np.flatnonzero(deg == 0)
    if len(isolated):
        d2 = ((pts[isolated, None, :] - pts[None, :, :]) ** 2).sum(-1)
        d2[np.arange(len(isolated)), isolated] = np.inf
        src = np.concatenate([src, isolated])
        dst = np.concatenate([dst, d2.argmin(axis=1)])
    return Graph.from_edge_arrays(
        src, dst, n_nodes=n_nodes, directed=False,
        name=name or f"RGG(n={n_nodes},r={radius})",
    )
