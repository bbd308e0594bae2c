"""Negative and positive graphs for evaluation — counterpart of
`embiggen_tpu/graph/sampling.py`: `sample_negative_graph`, non-edges with
uniform or degree-proportional endpoints, avoiding the support graph's
edges, and `sample_positive_graph`, a uniform subsample of the edges. Host numpy with the reference's RNG calls in the same order; the
in-batch deduplication is the native counting sort
(`native.sort_unique_pairs`), as in the reference. The membership test
against the support runs on `device`: kernel K5 on a CUDA device, its plain
version on the CPU."""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from .. import native
from .graph import Graph

_NEG_CACHE: "OrderedDict[tuple, Graph]" = OrderedDict()
_NEG_CACHE_SIZE = 4


def sample_negative_graph(
    graph: Graph,
    number_of_negative_samples: int,
    random_state: int = 42,
    use_scale_free_distribution: bool = True,
    support: Optional[Graph] = None,
    max_rounds: int = 64,
    device: Union[str, torch.device] = "cuda",
) -> Graph:
    """A graph of `number_of_negative_samples` (canonical) non-edges, whose
    membership test against `support` runs on `device` (the card unless the
    caller asks for the CPU).

    Endpoints are heads of uniform arcs of `graph` (degree-proportional)
    when `use_scale_free_distribution`, else uniform nodes. Pairs that are
    self-loops or edges of `support` are rejected, and so are repeats.
    Results are memoized in a small LRU keyed by the graphs' content and the
    arguments: the draw is deterministic, and every model evaluated on a
    holdout asks for the same negatives."""
    cache_key = (
        graph.arcs_fingerprint,
        graph.directed,
        None if support is None or support is graph
        else support.arcs_fingerprint,
        int(number_of_negative_samples),
        int(random_state),
        bool(use_scale_free_distribution),
        int(max_rounds),
    )
    hit = _NEG_CACHE.get(cache_key)
    if hit is not None:
        _NEG_CACHE.move_to_end(cache_key)
        return hit
    result = _sample_negative_graph(
        graph, number_of_negative_samples, random_state,
        use_scale_free_distribution, support, max_rounds, device,
    )
    _NEG_CACHE[cache_key] = result
    while len(_NEG_CACHE) > _NEG_CACHE_SIZE:
        _NEG_CACHE.popitem(last=False)
    return result


def _sample_negative_graph(
    graph: Graph,
    number_of_negative_samples: int,
    random_state: int,
    use_scale_free_distribution: bool,
    support: Optional[Graph],
    max_rounds: int,
    device: Union[str, torch.device],
) -> Graph:
    support = support or graph
    has_edges = _device_membership(support, torch.device(device))
    rng = np.random.default_rng(random_state)
    n = graph.number_of_nodes
    # The destination (and, symmetrically, the source) of a uniform arc is
    # degree-distributed, so a scale-free draw is one integer and a gather.
    arc_dst = graph.sources
    n_arcs = len(arc_dst)
    scale_free = use_scale_free_distribution and n_arcs > 0

    got_src: list = []
    got_dst: list = []
    # Sorted keys of the pairs kept so far: top-up rounds reject re-draws.
    kept_keys: Optional[np.ndarray] = None
    needed = number_of_negative_samples
    # Start near 1x and size any top-up round from the measured survival.
    oversample = 1.05
    for _ in range(max_rounds):
        if needed <= 0:
            break
        batch = max(1024, int(needed * oversample) + 64)
        if scale_free:
            src = arc_dst[rng.integers(0, n_arcs, size=batch)].astype(np.int64)
            dst = arc_dst[rng.integers(0, n_arcs, size=batch)].astype(np.int64)
        else:
            src = rng.integers(0, n, size=batch)
            dst = rng.integers(0, n, size=batch)
        ok = src != dst
        ok &= ~has_edges(src, dst)
        if not graph.directed and support.directed:
            ok &= ~has_edges(dst, src)
        src, dst = src[ok], dst[ok]
        if not graph.directed:
            src, dst = np.minimum(src, dst), np.maximum(src, dst)
        key = src * np.int64(n) + dst
        if kept_keys is not None and len(kept_keys):
            pos = np.minimum(np.searchsorted(kept_keys, key), len(kept_keys) - 1)
            fresh = kept_keys[pos] != key
            src, dst, key = src[fresh], dst[fresh], key[fresh]
        first = native.sort_unique_pairs(src, dst, n)
        survival = len(first) / batch
        take = min(needed, len(first))
        first = first[:take]
        got_src.append(src[first])
        got_dst.append(dst[first])
        needed -= take
        if needed > 0:
            oversample = 1.1 / max(survival, 0.02)
            new_keys = key[first]
            kept_keys = (
                new_keys if kept_keys is None
                else np.sort(np.concatenate([kept_keys, new_keys]))
            )
    src = np.concatenate(got_src) if got_src else np.zeros(0, dtype=np.int64)
    dst = np.concatenate(got_dst) if got_dst else np.zeros(0, dtype=np.int64)
    return Graph.from_edge_arrays(
        src, dst, n_nodes=n, directed=graph.directed,
        name=f"{graph.name}_negatives", node_names=graph.node_names,
    )


def _device_membership(support: Graph, device: torch.device):
    """has_edges(src, dst) -> bool array, by the CSR search on `device`."""
    from ..ops.walks import csr_has_edges

    tg = support.device(device)

    def has_edges(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        return csr_has_edges(tg.row_ptr, tg.col_idx, put(src), put(dst)).cpu().numpy()

    return has_edges


def sample_positive_graph(
    graph: Graph, number_of_samples: int, random_state: int = 42
) -> Graph:
    """The graph of `number_of_samples` canonical edges of `graph` (all of
    them when it has fewer), drawn uniformly without replacement by numpy's
    `default_rng(random_state)`, as the reference draws them."""
    from .holdouts import _canonical_edges, _subgraph_from_canonical

    src, _, _ = _canonical_edges(graph)
    rng = np.random.default_rng(random_state)
    keep = np.zeros(len(src), dtype=bool)
    keep[rng.choice(len(src), size=min(number_of_samples, len(src)), replace=False)] = True
    return _subgraph_from_canonical(graph, keep, f"{graph.name}_pos_sample")
