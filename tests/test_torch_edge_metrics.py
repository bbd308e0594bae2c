"""The plain version of K8 (`edge_metrics_plain`, what the wrapper runs on
CPU tensors) against embiggen_tpu's `edge_metrics` on the same CSR and
pairs: an Erdos-Renyi graph, a Barabasi-Albert graph whose hubs pass the
cap, a multigraph with duplicate arcs and self-loops, and pairs with
zero-degree endpoints, at cap 4 and 128. Jaccard and preferential
attachment take the same float operations on the same integers (rtol 1e-6
and exact); Adamic-Adar and resource allocation sum in another order (rtol
1e-5 / atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph.generators import barabasi_albert as ref_barabasi_albert
from embiggen_tpu.ops import edge_metrics as ref_edge_metrics
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.ops.edge_metrics import (
    EDGE_METRIC_NAMES, HELD, N_EDGE_METRICS, edge_metrics, edge_metrics_plain,
)

torch.set_num_threads(1)


def _multigraph():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 30, 400), rng.integers(0, 30, 400)
    src = np.concatenate([src, np.arange(0, 30, 3)])    # self-loops
    dst = np.concatenate([dst, np.arange(0, 30, 3)])
    return RefGraph.from_edge_arrays(src, dst, n_nodes=36, directed=True,
                                     deduplicate=False)


GRAPHS = {
    "erdos_renyi": lambda: ref_erdos_renyi(150, 700, seed=2),
    "barabasi_albert": lambda: ref_barabasi_albert(1200, 5, seed=0),
    "multigraph": _multigraph,
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


@pytest.mark.parametrize("cap", [4, 128])
def test_plain_matches_reference(graph, cap):
    n = graph.number_of_nodes
    rng = np.random.default_rng(cap)
    arcs = rng.integers(0, graph.number_of_directed_edges, 600)
    zero = np.flatnonzero(graph.degrees == 0)
    hubs = np.argsort(-graph.degrees)[:10]
    src = np.concatenate([graph.sources[arcs], rng.integers(0, n, 600),
                          rng.choice(hubs, 100), np.resize(zero, 20)])
    dst = np.concatenate([graph.col_idx[arcs], rng.integers(0, n, 600),
                          rng.choice(hubs, 100), rng.integers(0, n, 20)])
    want = np.asarray(ref_edge_metrics.edge_metrics(
        graph.device(with_weights=False), jnp.asarray(src.astype(np.int32)),
        jnp.asarray(dst.astype(np.int32)), cap=cap))
    tg = Graph(row_ptr=graph.row_ptr, col_idx=graph.col_idx).device("cpu")
    got = edge_metrics(tg, torch.from_numpy(src), torch.from_numpy(dst), cap=cap)
    assert got.dtype == torch.float32 and got.shape == (len(src), N_EDGE_METRICS)
    got = got.numpy()
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5, atol=1e-6)
    assert (want[:, 1] > 0).any()
    if cap == 4 and graph.degrees.max() > 128:
        # hub pairs are truncated: cap 4 and cap 128 give other counts
        assert not np.array_equal(
            want, np.asarray(ref_edge_metrics.edge_metrics(
                graph.device(with_weights=False), jnp.asarray(src.astype(np.int32)),
                jnp.asarray(dst.astype(np.int32)), cap=128)))


def test_names_empty_batches_and_arguments():
    assert EDGE_METRIC_NAMES == ref_edge_metrics.EDGE_METRIC_NAMES
    assert N_EDGE_METRICS == ref_edge_metrics.N_EDGE_METRICS == 4
    tg = Graph.from_edge_arrays([0, 1], [1, 2]).device("cpu")
    empty = torch.zeros(0, dtype=torch.int32)
    assert edge_metrics(tg, empty, empty).shape == (0, 4)
    isolated = Graph.from_edge_arrays([], [], n_nodes=3).device("cpu")
    pair = torch.tensor([0, 1], dtype=torch.int32)
    np.testing.assert_array_equal(edge_metrics(isolated, pair, pair.flip(0)).numpy(), 0)
    with pytest.raises(ValueError, match="cap"):
        edge_metrics(tg, pair, pair, cap=0)
    assert edge_metrics_plain(tg, pair, pair.flip(0))[:, 3].tolist() == [2.0, 2.0]


def _spread_multigraph():
    """Rows of 0 to 900 arcs (most about 20, 40 of them 300-900, longer than
    K8's register capacity), with duplicate arcs and self-loops."""
    rng = np.random.default_rng(9)
    n = 1500
    deg = rng.poisson(20, n)
    deg[rng.choice(n, 40, replace=False)] = rng.integers(300, 900, 40)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, len(src))
    dst[::40] = src[::40]
    src, dst = np.concatenate([src, src[::7]]), np.concatenate([dst, dst[::7]])
    return RefGraph.from_edge_arrays(src, dst, n_nodes=n, directed=True, deduplicate=False)


def _case_pairs(graph, case, rng):
    deg = graph.degrees
    n = graph.number_of_nodes
    long_rows = np.flatnonzero(deg > HELD)
    if case == "long other rows":
        src = np.concatenate([rng.integers(0, n, 400), rng.choice(long_rows, 200)])
        dst = np.concatenate([rng.choice(long_rows, 400), rng.choice(long_rows, 200)])
    elif case == "duplicate arcs":
        arcs = np.flatnonzero(np.diff(graph.col_idx) == 0)   # a row's repeated neighbour
        arcs = arcs[graph.sources[arcs] == graph.sources[arcs + 1]]
        src = graph.sources[rng.choice(arcs, 400)]
        dst = np.concatenate([src[:200], rng.integers(0, n, 200)])
    else:   # self pairs
        src = np.concatenate([rng.integers(0, n, 300), long_rows])
        dst = src
    return src, dst


@pytest.mark.parametrize("case", ["long other rows", "duplicate arcs", "self pairs"])
@pytest.mark.parametrize("cap", [4, 128, 1000])
def test_plain_matches_reference_on_long_rows_duplicates_and_self_pairs(case, cap):
    """Pairs whose other row is longer than K8's register capacity (HELD =
    64 ids, searched in device memory on the card), pairs whose
    expanded row repeats a neighbour (each arc counts), and self-pairs
    (every candidate is common)."""
    graph = _spread_multigraph()
    src, dst = _case_pairs(graph, case, np.random.default_rng(cap))
    want = np.asarray(ref_edge_metrics.edge_metrics(
        graph.device(with_weights=False), jnp.asarray(src.astype(np.int32)),
        jnp.asarray(dst.astype(np.int32)), cap=cap))
    tg = Graph(row_ptr=graph.row_ptr, col_idx=graph.col_idx).device("cpu")
    got = edge_metrics(tg, torch.from_numpy(src), torch.from_numpy(dst), cap=cap).numpy()
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5, atol=1e-6)
    if case == "self pairs":
        # every candidate is a common neighbour: inter = min(deg, cap)
        deg = graph.degrees[src].astype(np.float64)
        inter = np.minimum(deg, cap)
        np.testing.assert_allclose(got[:, 1], np.where(deg > 0, inter / np.maximum(
            2 * deg - inter, 1), 0), rtol=1e-6)
