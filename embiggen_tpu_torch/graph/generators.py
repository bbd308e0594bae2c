"""Synthetic graph generators — counterpart of
`embiggen_tpu/graph/generators.py`. The same numpy RNG calls in the same
order, so a seed gives the same graph, weights and types as the JAX
package."""
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
    n_edge_types: int = 0, n_node_types: int = 0, name: Optional[str] = None,
) -> Graph:
    """Uniform random graph of up to `n_edges` edges (no self-loops), with
    weights in [0.5, 2), `n_edge_types` uniform edge types and one uniform
    node type of `n_node_types` per node, each drawn only when asked, in
    that order after the edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=2 * n_edges)
    dst = rng.integers(0, n_nodes, size=2 * n_edges)
    keep = src != dst
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    weights = rng.uniform(0.5, 2.0, size=len(src)).astype(np.float32) if weighted else None
    edge_types = (rng.integers(0, n_edge_types, size=len(src)).astype(np.int32)
                  if n_edge_types else None)
    node_type_ptr = node_type_ids = None
    if n_node_types:
        node_type_ptr = np.arange(n_nodes + 1, dtype=np.int64)
        node_type_ids = rng.integers(0, n_node_types, size=n_nodes).astype(np.int32)
    return Graph.from_edge_arrays(
        src,
        dst,
        n_nodes=n_nodes,
        weights=weights,
        edge_types=edge_types,
        directed=False,
        name=name or f"ER(n={n_nodes},e={n_edges})",
        node_type_ptr=node_type_ptr,
        node_type_ids=node_type_ids,
    )


def planted_partition(
    n_nodes: int = 1000,
    n_communities: int = 4,
    p_in: float = 0.03,
    p_out: float = 0.001,
    seed: int = 42,
    name: Optional[str] = None,
) -> Graph:
    """Stochastic block model with the community ids as node types: ordered
    pairs drawn uniformly (1.3 times the expected count at the larger
    probability), kept when i < j and accepted with p_in within a community,
    p_out across; each isolated node is joined to a random member of its
    community (any other node for a community of one)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, size=n_nodes).astype(np.int32)
    p_max = max(p_in, p_out)
    n_cand = int(n_nodes * (n_nodes - 1) * p_max * 1.3) + 32
    src = rng.integers(0, n_nodes, size=n_cand)
    dst = rng.integers(0, n_nodes, size=n_cand)
    ok = src < dst
    src, dst = src[ok], dst[ok]
    p_pair = np.where(comm[src] == comm[dst], p_in, p_out)
    keep = rng.random(len(src)) < p_pair / p_max
    src, dst = src[keep], dst[keep]
    deg = np.bincount(np.concatenate([src, dst]), minlength=n_nodes)
    isolated = np.flatnonzero(deg == 0)
    if len(isolated):
        partners = np.empty(len(isolated), np.int64)
        for i, v in enumerate(isolated):
            peers = np.flatnonzero(comm == comm[v])
            peers = peers[peers != v]
            if len(peers) == 0:
                peers = np.delete(np.arange(n_nodes), v)
            partners[i] = rng.choice(peers)
        src = np.concatenate([src, isolated])
        dst = np.concatenate([dst, partners])
    return Graph.from_edge_arrays(
        src, dst, n_nodes=n_nodes, directed=False,
        name=name or f"SBM(n={n_nodes},k={n_communities})",
        node_type_ptr=np.arange(n_nodes + 1, dtype=np.int64),
        node_type_ids=comm,
        node_type_names=[f"community_{c}" for c in range(n_communities)],
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
    The community labels are the node types."""
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
        node_type_ptr=np.arange(n_nodes + 1, dtype=np.int64),
        node_type_ids=comm,
        node_type_names=[f"community_{c}" for c in range(n_communities)],
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
    prediction on it has real headroom. The node types are the labels of
    the `n_grid_types` by `n_grid_types` grid cells."""
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
    cell = (np.minimum((pts[:, 0] * n_grid_types).astype(np.int32), n_grid_types - 1)
            * n_grid_types
            + np.minimum((pts[:, 1] * n_grid_types).astype(np.int32), n_grid_types - 1)
            ).astype(np.int32)
    return Graph.from_edge_arrays(
        src, dst, n_nodes=n_nodes, directed=False,
        name=name or f"RGG(n={n_nodes},r={radius})",
        node_type_ptr=np.arange(n_nodes + 1, dtype=np.int64),
        node_type_ids=cell,
        node_type_names=[f"cell_{i}" for i in range(n_grid_types * n_grid_types)],
    )
