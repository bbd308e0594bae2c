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
    EDGE_METRIC_NAMES, N_EDGE_METRICS, edge_metrics, edge_metrics_plain,
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
