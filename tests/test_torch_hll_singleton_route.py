"""K16a's singleton route (`khop_sketches_of_singletons`, the plain version
on the CPU) against embiggen_tpu's `khop_sketches` over its
`singleton_registers`, byte for byte, and against the port's
`khop_sketches_plain` over its own singletons: precisions 4, 8 and 12, hops
1-3 and 6, seeds 0 and 5, on an undirected graph with self-loops and
isolated nodes, a directed graph, a multigraph (duplicate arcs, self-loops)
and a graph with a row longer than M at every precision; hop 2 forced
onto each route, and the rule that picks hop 2's route for a graph from
its mean and largest degree."""
import functools

import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.ops import hll as ref_hll
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.models.edge_features import HyperSketching
from embiggen_tpu_torch.ops import hll

torch.set_num_threads(1)


def _ref_graph(kind):
    rng = np.random.default_rng(17)
    if kind == "undirected":    # self-loops; nodes 250-259 isolated
        src, dst = rng.integers(0, 250, (2, 900))
        src[:10] = dst[:10]
        return RefGraph.from_edge_arrays(src, dst, n_nodes=260)
    if kind == "directed":
        src, dst = rng.integers(0, 200, (2, 800))
        return RefGraph.from_edge_arrays(src, dst, n_nodes=200, directed=True)
    if kind == "multigraph":    # duplicate arcs and self-loops
        src, dst = rng.integers(0, 40, (2, 500))
        src = np.concatenate([src, src[:60], np.arange(0, 40, 4)])
        dst = np.concatenate([dst, dst[:60], np.arange(0, 40, 4)])
        return RefGraph.from_edge_arrays(src, dst, n_nodes=45, directed=True,
                                         deduplicate=False)
    # "hub": node 0 joined to 4,200 nodes, more than M = 4096 at precision 12
    src, dst = rng.integers(1, 4300, (2, 3000))
    return RefGraph.from_edge_arrays(np.concatenate([src, np.zeros(4200, np.int64)]),
                                     np.concatenate([dst, np.arange(1, 4201)]), n_nodes=4300)


KINDS = ["undirected", "directed", "multigraph", "hub"]


@functools.lru_cache(maxsize=None)
def _graphs(kind):
    rg = _ref_graph(kind)
    return Graph(row_ptr=rg.row_ptr, col_idx=rg.col_idx, directed=rg.directed).device("cpu"), rg


@functools.lru_cache(maxsize=None)
def _reference(kind, precision, hops, seed):
    """The reference's [N, hops, M] sketches from its singletons."""
    _, rg = _graphs(kind)
    base = ref_hll.singleton_registers(rg.number_of_nodes, precision, 6, seed=seed)
    return np.transpose(np.asarray(ref_hll.khop_sketches(rg.device(), base, hops)), (1, 0, 2))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("hops", [1, 2, 3, 6])
@pytest.mark.parametrize("seed", [0, 5])
def test_singleton_route_matches_reference(kind, precision, hops, seed):
    tg, _ = _graphs(kind)
    got = hll.khop_sketches_of_singletons(tg, hops, precision, 6, seed)
    assert got.dtype == torch.uint8 and got.shape == (tg.n_nodes, hops, 1 << precision)
    np.testing.assert_array_equal(got.numpy(), _reference(kind, precision, hops, seed))
    base = hll.singleton_registers(tg.n_nodes, precision, 6, seed, tg.device)
    assert torch.equal(got, hll.khop_sketches_plain(tg, base, hops))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("precision", [4, 6, 8, 10, 12])
@pytest.mark.parametrize("route", hll.HOP2_ROUTES)
def test_second_hop_forced_onto_each_route(kind, precision, route):
    tg, _ = _graphs(kind)
    got = hll.khop_sketches_of_singletons(tg, 3, precision, 6, 5, route)
    np.testing.assert_array_equal(got.numpy(), _reference(kind, precision, 3, 5))


@pytest.mark.parametrize("mean, max_degree, precision, route", [
    (20, 45, 4, "hop"),         # the slice graph: the hop launch at precisions 4-8,
    (20, 45, 5, "hop"),
    (20, 45, 6, "hop"),
    (20, 45, 7, "hop"),
    (20, 45, 8, "hop"),
    (20, 45, 9, "ids"),         # ... and the id route from 9
    (20, 45, 10, "ids"),
    (20, 45, 12, "ids"),
    (5, 40, 8, "ids"),
    (38, 65536, 12, "hop"),     # a hub's id route would outlast the launch
    (38, 65536, 9, "hop"),
    (38, 65536, 8, "hop"),      # the hop launch splits the hub's row
    (38, 65536, 6, "hop"),
    (38, 1000, 12, "ids"),
    (38, 1000, 8, "hop"),
])
def test_hop2_route_follows_the_degrees(mean, max_degree, precision, route):
    n = 4000
    deg = np.full(n, mean)
    deg[0] = max_degree
    deg[1:1 + (max_degree - mean) // mean + 1] = 0   # keep the mean about the same
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    tg = Graph(row_ptr=row_ptr, col_idx=np.zeros(row_ptr[-1], np.int32), directed=True
               ).device("cpu")
    assert abs(tg.n_arcs / n - mean) < 1.0
    assert hll.hop2_route(tg, precision) == route


def test_hop2_route_of_a_graph_without_arcs():
    tg = Graph(row_ptr=np.zeros(11, np.int64), col_idx=np.zeros(0, np.int32),
               directed=True).device("cpu")
    assert hll.hop2_route(tg, 8) == "hop"
    got = hll.khop_sketches_of_singletons(tg, 2, 8, 6, 0)
    assert torch.equal(got[:, 1], got[:, 0])
    assert torch.equal(got[:, 0], hll.singleton_registers(10, 8, 6, 0, "cpu"))


def test_singleton_route_arguments():
    tg, _ = _graphs("directed")
    for kw, match in ((dict(precision=3), "precision"), (dict(precision=13), "precision"),
                      (dict(hops=0), "hops"), (dict(route="rows"), "route")):
        args = dict(hops=2, precision=8) | kw
        with pytest.raises(ValueError, match=match):
            hll.khop_sketches_of_singletons(tg, **args)


@pytest.mark.parametrize("hops, precision, seed", [(2, 6, 3), (3, 8, 0)])
def test_hyper_sketching_fits_through_the_singleton_route(hops, precision, seed):
    tg, rg = _graphs("undirected")
    g = Graph(row_ptr=rg.row_ptr, col_idx=rg.col_idx)
    model = HyperSketching(number_of_hops=hops, precision=precision, random_state=seed,
                           device="cpu").fit(g)
    base = hll.singleton_registers(g.number_of_nodes, precision, 6, seed, "cpu")
    assert torch.equal(model._sketches, hll.khop_sketches(tg, base, hops))
