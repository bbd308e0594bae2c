"""The port's host copies for the link-prediction slice — graph helpers,
generators, propagation kernels, holdouts, negative graphs and the binary
metrics — held exactly against embiggen_tpu on the same inputs."""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import generators as ref_generators
from embiggen_tpu.graph.holdouts import connected_holdout as ref_connected_holdout
from embiggen_tpu.graph.holdouts import random_holdout as ref_random_holdout
from embiggen_tpu.graph.laplacians import KERNELS as REF_KERNELS
from embiggen_tpu.graph.laplacians import kernel_coo as ref_kernel_coo
from embiggen_tpu.graph.sampling import sample_negative_graph as ref_sample_negative_graph
from embiggen_tpu.ops.metrics import all_binary_metrics as ref_all_binary_metrics
from embiggen_tpu_torch.graph import (
    Graph, connected_holdout, erdos_renyi, planted_partition_edges,
    random_geometric, random_holdout, sample_negative_graph,
)
from embiggen_tpu_torch.graph.laplacians import KERNELS, kernel_coo, validate_convolution_graph
from embiggen_tpu_torch.ops.metrics import all_binary_metrics

torch.set_num_threads(1)


def _same_csr(port, ref):
    np.testing.assert_array_equal(port.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(port.col_idx, ref.col_idx)
    assert port.directed == ref.directed and port.name == ref.name
    assert (port.weights is None) == (ref.weights is None)
    if port.weights is not None:
        np.testing.assert_array_equal(port.weights, ref.weights)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_nodes=150, n_edges=700, seed=3, weighted=True)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


@pytest.mark.parametrize("name, args", [
    ("random_geometric", dict(n_nodes=300, radius=0.09, seed=42)),
    ("random_geometric", dict(n_nodes=200, radius=0.02, seed=1)),  # isolated points
    ("planted_partition_edges", dict(n_nodes=400, n_edges=2000, n_communities=4, seed=5)),
])
def test_generators_match_reference(name, args):
    port = {"random_geometric": random_geometric,
            "planted_partition_edges": planted_partition_edges}[name](**args)
    _same_csr(port, getattr(ref_generators, name)(**args))


def test_graph_helpers_match_reference(graphs):
    port, ref = graphs
    assert port.number_of_edges == ref.number_of_edges
    assert port.arcs_fingerprint == ref.arcs_fingerprint
    assert port.is_multigraph() == ref.is_multigraph()
    assert port.has_singleton_nodes() == ref.has_singleton_nodes()
    assert port.get_number_of_singleton_nodes() == ref.get_number_of_singleton_nodes()
    rng = np.random.default_rng(0)
    src = np.concatenate([port.sources[:50], rng.integers(0, 150, 200)])
    dst = np.concatenate([port.col_idx[:50], rng.integers(0, 150, 200)])
    np.testing.assert_array_equal(port.has_edges(src, dst), ref.has_edges(src, dst))
    tg = port.device("cpu", with_sources=True)
    np.testing.assert_array_equal(tg.sources.numpy(), port.sources)
    assert port.device("cpu").sources is None
    named = Graph.from_edge_arrays([0, 1], [1, 2], node_names=["a", "b", "c"])
    assert list(named.get_node_names()) == ["a", "b", "c"]


def test_isolated_nodes_and_self_loops_match_reference():
    src, dst = np.array([0, 1, 2, 2]), np.array([1, 2, 2, 0])
    port = Graph.from_edge_arrays(src, dst, n_nodes=6)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=6)
    assert port.number_of_edges == ref.number_of_edges
    assert port.get_number_of_singleton_nodes() == ref.get_number_of_singleton_nodes() == 3
    with pytest.warns(UserWarning, match="singleton"):
        validate_convolution_graph(port)


def test_kernel_names_match_reference():
    assert KERNELS == REF_KERNELS and len(KERNELS) == 13


@pytest.mark.parametrize("name", REF_KERNELS + ["Trasposed Left Normalized Laplacian"])
def test_kernel_coo_matches_reference(graphs, name):
    port, ref = graphs
    for a, b in zip(kernel_coo(port, name), ref_kernel_coo(ref, name)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("holdout, ref_holdout", [
    (connected_holdout, ref_connected_holdout),
    (random_holdout, ref_random_holdout),
])
@pytest.mark.parametrize("seed", [3, 11])
def test_holdouts_match_reference(graphs, holdout, ref_holdout, seed):
    port, ref = graphs
    for a, b in zip(holdout(port, train_size=0.7, random_state=seed),
                    ref_holdout(ref, train_size=0.7, random_state=seed)):
        _same_csr(a, b)


def test_connected_holdout_keeps_components():
    g = random_geometric(300, radius=0.09, seed=42)
    train, test = connected_holdout(g, random_state=3)
    assert train.number_of_edges + test.number_of_edges == g.number_of_edges
    # Every node with an edge keeps one in train (the spanning forest).
    assert not ((g.degrees > 0) & (train.degrees == 0)).any()


@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("with_support", [False, True])
def test_sample_negative_graph_matches_reference(graphs, scale_free, with_support):
    port, ref = graphs
    p_train, _ = random_holdout(port, random_state=1)
    r_train, _ = ref_random_holdout(ref, random_state=1)
    kw = dict(number_of_negative_samples=900, random_state=7,
              use_scale_free_distribution=scale_free)
    got = sample_negative_graph(p_train, support=port if with_support else None, device="cpu",
                                **kw)
    want = ref_sample_negative_graph(r_train, support=ref if with_support else None, **kw)
    _same_csr(got, want)
    assert got.number_of_edges == 900
    avoid = port if with_support else p_train
    assert not avoid.has_edges(got.sources, got.col_idx).any()
    assert sample_negative_graph(p_train, support=port if with_support else None,
                                 device="cpu", **kw) is got


@pytest.mark.parametrize("seed, ties", [(0, False), (1, True), (2, True)])
def test_binary_metrics_match_reference(seed, ties):
    rng = np.random.default_rng(seed)
    labels = rng.random(3000) < 0.3
    scores = rng.random(3000).astype(np.float32)
    if ties:
        scores = np.round(scores * 20) / 20
    scores = np.where(labels, np.minimum(scores + 0.2, 1.0), scores)
    got, want = all_binary_metrics(labels, scores), ref_all_binary_metrics(labels, scores)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
