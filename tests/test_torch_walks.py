"""The port's samplers (K1 first-order walks, K2 node draws) on the CPU:
every step is an arc or a zero-degree stay, and the draws match the exact
transition / degree distributions and the JAX package's walks in
distribution (chi-square, failing at p < 1e-3). Inputs come from fixed seeds,
so each test's outcome is fixed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from embiggen_tpu.ops.walks import random_walks as ref_random_walks
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.ops.negatives import (
    negative_nodes_for_nce,
    sample_nodes_scale_free,
    sample_nodes_uniform,
)
from embiggen_tpu_torch.ops.walks import first_order_walks, random_walks

torch.set_num_threads(1)
P_MIN = 1e-3


def _port_graph(ref):
    return Graph(row_ptr=ref.row_ptr, col_idx=ref.col_idx, directed=ref.directed,
                 name=ref.name, weights=ref.weights)


def _arc_positions(graph, walks):
    """Check every step of `walks` is an arc or a stay on a zero-degree node;
    return (source of each move, CSR position of each move's arc)."""
    walks = np.asarray(walks, np.int64)
    n = graph.number_of_nodes
    src, dst = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    deg = graph.degrees.astype(np.int64)
    stays = deg[src] == 0
    np.testing.assert_array_equal(dst[stays], src[stays])
    src, dst = src[~stays], dst[~stays]
    keys = graph.sources.astype(np.int64) * n + graph.col_idx
    pos = np.minimum(np.searchsorted(keys, src * n + dst), len(keys) - 1)
    assert (keys[pos] == src * n + dst).all(), "a step left the graph"
    return src, pos


def _arc_probabilities(graph):
    w = (np.ones(graph.number_of_directed_edges) if graph.weights is None
         else graph.weights.astype(np.float64))
    row_sum = np.add.reduceat(w, graph.row_ptr[:-1][graph.degrees > 0])
    full = np.zeros(graph.number_of_nodes)
    full[graph.degrees > 0] = row_sum
    return w / full[graph.sources]


def _chi2_p(observed, expected, rows, n_rows):
    """Pooled chi-square p-value over the rows whose every cell expects at
    least 5 counts; df = sum over rows of (cells - 1)."""
    ok = np.ones(n_rows, bool)
    np.logical_and.at(ok, rows, expected >= 5)
    cells = ok[rows]
    assert cells.sum() > 50, "too few testable cells"
    stat = (((observed - expected) ** 2) / expected)[cells].sum()
    df = cells.sum() - np.unique(rows[cells]).size
    return chi2.sf(stat, df)


def _exact_transition_p(graph, walks):
    src, pos = _arc_positions(graph, walks)
    observed = np.bincount(pos, minlength=graph.number_of_directed_edges)
    n_from = np.bincount(src, minlength=graph.number_of_nodes)
    expected = n_from[graph.sources] * _arc_probabilities(graph)
    return _chi2_p(observed, expected, graph.sources, graph.number_of_nodes)


def _walk(graph, n_walks, length, seed, with_alias):
    tg = graph.device("cpu", with_alias=with_alias)
    starts = torch.arange(n_walks, dtype=torch.int32) % graph.number_of_nodes
    walks = random_walks(tg, starts, length, torch.Generator().manual_seed(seed))
    assert walks.dtype == torch.int32 and walks.shape == (n_walks, length)
    np.testing.assert_array_equal(walks[:, 0].numpy(), starts.numpy())
    return walks.numpy()


@pytest.fixture(scope="module")
def port_karate(karate):
    return _port_graph(karate)


@pytest.fixture(scope="module")
def port_weighted(er_graph):
    return _port_graph(er_graph)


def test_unweighted_walks_match_exact_transitions(port_karate):
    walks = _walk(port_karate, 34 * 600, 20, seed=0, with_alias=False)
    assert _exact_transition_p(port_karate, walks) > P_MIN


def test_weighted_walks_match_exact_transitions(port_weighted):
    walks = _walk(port_weighted, 4000, 24, seed=1, with_alias=True)
    assert _exact_transition_p(port_weighted, walks) > P_MIN


def test_zero_degree_nodes_stay_put():
    g = Graph.from_edge_arrays(np.array([0, 1]), np.array([1, 2]), n_nodes=5)
    walks = _walk(g, 50, 6, seed=2, with_alias=False)
    for trap in (3, 4):
        assert (walks[walks[:, 0] == trap] == trap).all()
    assert (walks[walks[:, 0] < 3] < 3).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_walks_match_jax_walks(karate, er_graph, weighted):
    """Two-sample chi-square: per source node, the port's and the JAX
    package's next-node counts come from one distribution."""
    ref = er_graph if weighted else karate
    port = _port_graph(ref)
    n_walks, length = 3000, 24
    ours = _walk(port, n_walks, length, seed=3, with_alias=weighted)
    theirs = np.asarray(ref_random_walks(
        ref.device(with_alias=weighted),
        jnp.arange(n_walks, dtype=jnp.int32) % ref.number_of_nodes,
        length, jax.random.PRNGKey(3),
    ))
    counts = []
    for walks in (ours, theirs):
        src, pos = _arc_positions(port, walks)
        counts.append(np.bincount(pos, minlength=port.number_of_directed_edges))
    o1, o2 = np.asarray(counts, np.float64)
    n1 = np.bincount(port.sources, weights=o1, minlength=port.number_of_nodes)
    n2 = np.bincount(port.sources, weights=o2, minlength=port.number_of_nodes)
    pooled = (o1 + o2) / np.maximum(n1 + n2, 1)[port.sources]
    e1, e2 = n1[port.sources] * pooled, n2[port.sources] * pooled
    ok = np.minimum(e1, e2) >= 5
    rows_ok = np.ones(port.number_of_nodes, bool)
    np.logical_and.at(rows_ok, port.sources, ok)
    cells = rows_ok[port.sources]
    stat = ((o1 - e1) ** 2 / e1 + (o2 - e2) ** 2 / e2)[cells].sum()
    df = cells.sum() - rows_ok[port.degrees > 0].sum()
    assert df > 50
    assert chi2.sf(stat, df) > P_MIN


def test_walks_reproducible_from_seed(port_weighted):
    a = _walk(port_weighted, 100, 10, seed=5, with_alias=True)
    b = _walk(port_weighted, 100, 10, seed=5, with_alias=True)
    np.testing.assert_array_equal(a, b)


def test_scale_free_draws_follow_degrees(port_weighted):
    tg = port_weighted.device("cpu")
    negs = negative_nodes_for_nce(tg, torch.Generator().manual_seed(0), 10,
                                  per_walk=6000)
    assert negs.shape == (6000, 10) and negs.dtype == torch.int32
    n = port_weighted.number_of_nodes
    observed = np.bincount(negs.numpy().ravel(), minlength=n)
    expected = negs.numel() * port_weighted.degrees / port_weighted.degrees.sum()
    assert _chi2_p(observed, expected, np.zeros(n, int), 1) > P_MIN
    assert sample_nodes_scale_free(tg, torch.Generator(), (7,)).shape == (7,)


def test_uniform_draws(port_weighted):
    tg = port_weighted.device("cpu")
    draws = sample_nodes_uniform(tg, torch.Generator().manual_seed(1), (60000,))
    assert draws.dtype == torch.int32
    n = port_weighted.number_of_nodes
    observed = np.bincount(draws.numpy(), minlength=n)
    assert observed.sum() == 60000
    assert _chi2_p(observed, np.full(n, 60000 / n), np.zeros(n, int), 1) > P_MIN
    shared = negative_nodes_for_nce(tg, torch.Generator(), 5,
                                    use_scale_free_distribution=False)
    assert shared.shape == (5,)


def test_unsupported_walks_and_devices_raise(port_karate):
    tg = port_karate.device("cpu")
    starts = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A6"):
        random_walks(tg, starts, 5, torch.Generator(), change_node_type_weight=2.0)
    # No kernel and no plain version off CPU and CUDA: it raises, it does not
    # move the work elsewhere.
    meta = port_karate.device("meta")
    with pytest.raises(ValueError, match="meta"):
        first_order_walks(meta, starts.to("meta"), 5, torch.Generator())
    with pytest.raises(ValueError, match="meta"):
        sample_nodes_uniform(meta, torch.Generator(), (4,))


@pytest.mark.parametrize("kwargs", [dict(return_weight=2.0), dict(explore_weight=0.5)])
def test_pq_walks_are_accepted(port_karate, kwargs):
    """p/q walks are ported: they run, start at the starts and follow arcs."""
    tg = port_karate.device("cpu")
    starts = torch.arange(34, dtype=torch.int32)
    walks = random_walks(tg, starts, 5, torch.Generator().manual_seed(0), **kwargs)
    assert walks.shape == (34, 5)
    np.testing.assert_array_equal(walks[:, 0].numpy(), starts.numpy())
    _arc_positions(port_karate, walks.numpy())


def test_erdos_renyi_walks_valid():
    g = erdos_renyi(300, 600, seed=4)   # sparse: some isolated nodes
    assert (g.degrees == 0).any()
    walks = _walk(g, 900, 12, seed=6, with_alias=False)
    _arc_positions(g, walks)
