"""The port's host copy of `graph/metrics.py` on the CPU, equal to
embiggen_tpu's exactly on the same graphs (the edge metrics of pairs and of
every arc, triangle and square counts, the two approximated centralities),
and K8's plain version (`ops/edge_metrics.py`) at a cap that covers the
largest degree equal to that host copy within 1e-6 relative on a graph
whose hubs' rows exceed K8's default cap of 128: the function the sklearn
adapters' `use_edge_metrics` columns compute on the card."""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import metrics as ref_metrics
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.graph import metrics
from embiggen_tpu_torch.ops.edge_metrics import edge_metrics_plain

torch.set_num_threads(1)


def _hub_arrays(n=800, n_edges=3000, hubs=(300, 220, 150), seed=21):
    """Edges of a sparse random graph plus hubs joined to `hubs[i]` random
    nodes each (hubs among them), so rows reach past 128 ids."""
    rng = np.random.default_rng(seed)
    src, dst = [rng.integers(0, n, n_edges)], [rng.integers(0, n, n_edges)]
    for h, size in enumerate(hubs):
        src.append(np.full(size, h))
        dst.append(rng.choice(n, size, replace=False))
    return np.concatenate(src), np.concatenate(dst), n


def _graphs(kind):
    if kind == "erdos_renyi":
        kw = dict(n_nodes=300, n_edges=1500, seed=4)
        return erdos_renyi(**kw), ref_erdos_renyi(**kw)
    src, dst, n = _hub_arrays()
    directed = kind == "directed hubs"
    return (Graph.from_edge_arrays(src, dst, n_nodes=n, directed=directed),
            RefGraph.from_edge_arrays(src, dst, n_nodes=n, directed=directed))


def _pairs(graph, n_pairs=3000, seed=0):
    """Half arcs, half uniform pairs, and every pair of the top-8 nodes."""
    rng = np.random.default_rng(seed)
    arcs = rng.integers(0, graph.number_of_directed_edges, n_pairs // 2)
    top = np.argsort(-graph.degrees, kind="stable")[:8]
    src = np.concatenate([graph.sources[arcs], rng.integers(0, graph.number_of_nodes,
                                                            n_pairs // 2), np.repeat(top, 8)])
    dst = np.concatenate([graph.col_idx[arcs], rng.integers(0, graph.number_of_nodes,
                                                            n_pairs // 2), np.tile(top, 8)])
    return src, dst


KINDS = ("erdos_renyi", "hubs", "directed hubs")


@pytest.mark.parametrize("kind", KINDS)
def test_host_edge_metrics_equal_reference_exactly(kind):
    g, rg = _graphs(kind)
    src, dst = _pairs(g)
    got = metrics.edge_metrics(g, src, dst)
    assert got.dtype == np.float32 and got.shape == (len(src), 4)
    np.testing.assert_array_equal(got, ref_metrics.edge_metrics(rg, src, dst))
    np.testing.assert_array_equal(metrics.all_edge_metrics(g), ref_metrics.all_edge_metrics(rg))
    empty = np.zeros(0, np.int64)
    np.testing.assert_array_equal(metrics.edge_metrics(g, empty, empty),
                                  ref_metrics.edge_metrics(rg, empty, empty))
    assert metrics.EDGE_METRIC_NAMES == ref_metrics.EDGE_METRIC_NAMES


@pytest.mark.parametrize("kind", KINDS)
def test_host_counts_and_centralities_equal_reference_exactly(kind):
    g, rg = _graphs(kind)
    np.testing.assert_array_equal(metrics.triangle_counts(g), ref_metrics.triangle_counts(rg))
    np.testing.assert_array_equal(metrics.square_counts(g), ref_metrics.square_counts(rg))
    for name, kw in (("approximated_closeness_centrality", dict(n_sources=50, random_state=3)),
                     ("approximated_harmonic_centrality", {}),
                     ("approximated_closeness_centrality", dict(n_sources=10**4))):
        np.testing.assert_array_equal(getattr(metrics, name)(g, **kw),
                                      getattr(ref_metrics, name)(rg, **kw))


@pytest.mark.parametrize("kind", ("hubs", "directed hubs"))
def test_k8_plain_at_the_largest_degree_equals_the_host_copy(kind):
    """At cap = the largest degree K8's plain version truncates no row, so
    it computes the host copy's exact function (float32 sums in another
    order: 1e-6 relative); at the default cap of 128 the hub pairs differ,
    which shows the rows are long enough to matter."""
    g, _ = _graphs(kind)
    assert g.degrees.max() > 128
    src, dst = _pairs(g, seed=1)
    want = metrics.edge_metrics(g, src, dst)
    tg = g.device("cpu")
    s = torch.from_numpy(src.astype(np.int32))
    d = torch.from_numpy(dst.astype(np.int32))
    got = edge_metrics_plain(tg, s, d, cap=tg.max_degree).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    capped = edge_metrics_plain(tg, s, d).numpy()
    assert not np.allclose(capped[:, 0], want[:, 0], rtol=1e-6, atol=0)
