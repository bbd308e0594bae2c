"""`embiggen_tpu_torch.similarities` against embiggen_tpu's, and the two
native helpers of this slice against their plain versions.

- The four closures (`topological_levels`, `ancestor_bitsets`,
  `ancestors_csr`, `ancestor_lists`) equal the reference's exactly.
- DAGResnik's information content and similarities within 1e-12 of the
  reference's on tests/test_utils_extras.py's fixtures (the toy ontology,
  random multi-parent DAGs, node counts), on both routes: the IC-ordered
  bitsets, and the CSR closure with `native.dag_mica_block`, forced below
  `_BITSET_MAX_NODES` by lowering it in both packages.
- `native.dag_mica_block` and `native.connected_components` equal their
  plain versions exactly (the components also scipy's labels, which the
  reference's `Graph.connected_components` returns).
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

import embiggen_tpu.similarities as ref_similarities
from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu_torch import native, similarities
from embiggen_tpu_torch.graph import Graph, erdos_renyi

IC_ATOL = 1e-12


def _port_graph(ref: RefGraph) -> Graph:
    return Graph(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(RefGraph)})


def _toy_dag() -> RefGraph:
    return RefGraph.from_edge_arrays(
        np.array([1, 2, 3, 4, 5, 6]), np.array([0, 0, 1, 1, 2, 2]), n_nodes=7, directed=True,
        node_names=[f"t{i}" for i in range(7)], name="toy_dag")


def _random_dag(n: int, seed: int) -> RefGraph:
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(1, n):
        for p in rng.choice(v, size=int(rng.integers(1, min(3, v) + 1)), replace=False):
            src.append(v)
            dst.append(int(p))
    return RefGraph.from_edge_arrays(np.asarray(src), np.asarray(dst), n_nodes=n,
                                     directed=True, name=f"rand_dag{n}")


DAGS = {"toy": _toy_dag, "random120": lambda: _random_dag(120, 7),
        "random400": lambda: _random_dag(400, 3)}


@pytest.mark.parametrize("dag", sorted(DAGS))
def test_closures_equal_reference(dag):
    ref = DAGS[dag]()
    port = _port_graph(ref)
    got, want = similarities.topological_levels(port), ref_similarities.topological_levels(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(similarities.ancestor_bitsets(port),
                                  ref_similarities.ancestor_bitsets(ref))
    a, b = similarities.ancestors_csr(port), ref_similarities.ancestors_csr(ref)
    assert (a != b).nnz == 0 and a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    lists, ref_lists = similarities.ancestor_lists(port), ref_similarities.ancestor_lists(ref)
    assert len(lists) == len(ref_lists)
    for a, b in zip(lists, ref_lists):
        np.testing.assert_array_equal(a, b)


def test_a_cycle_raises_in_both():
    ref = ref_erdos_renyi(30, 60, seed=1)
    for module, g in ((ref_similarities, ref), (similarities, _port_graph(ref))):
        with pytest.raises(ValueError, match="not a DAG"):
            module.topological_levels(g)


def _counts(dag):
    return {name: float(c) for name, c in zip(
        dag.get_node_names(), np.random.default_rng(0).integers(1, 20, dag.number_of_nodes))}


def _fit_both(ref, **kwargs):
    return (similarities.DAGResnik().fit(_port_graph(ref), **kwargs),
            ref_similarities.DAGResnik().fit(ref, **kwargs))


@pytest.mark.parametrize("route", ["bitsets", "csr"])
@pytest.mark.parametrize("dag", sorted(DAGS))
@pytest.mark.parametrize("weights", ["uniform", "node_counts", "node_frequencies"])
def test_dag_resnik_matches_reference(route, dag, weights, monkeypatch):
    ref = DAGS[dag]()
    n = ref.number_of_nodes
    kwargs = {"uniform": {}, "node_counts": {"node_counts": _counts(ref)},
              "node_frequencies": {"node_frequencies": np.arange(1.0, n + 1.0)}}[weights]
    if route == "csr":
        for module in (similarities, ref_similarities):
            monkeypatch.setattr(module, "_BITSET_MAX_NODES", 5)
    port, want = _fit_both(ref, **kwargs)
    assert (port._anc_by_ic is None) == (want._anc_by_ic is None) == (route == "csr")
    np.testing.assert_allclose(port.get_information_content(),
                               want.get_information_content(), rtol=0, atol=IC_ATOL)
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, n, 40), rng.integers(0, n, 25)
    for method, args in (
            ("get_similarities_from_bipartite_graph_node_ids", (a, b)),
            ("get_similarities_from_clique_graph_node_ids", (np.arange(n),))):
        np.testing.assert_allclose(getattr(port, method)(*args), getattr(want, method)(*args),
                                   rtol=0, atol=IC_ATOL)
    got = port.get_similarities_from_bipartite_graph_node_ids(a, b, minimum_similarity=0.5)
    np.testing.assert_allclose(
        got, want.get_similarities_from_bipartite_graph_node_ids(a, b, minimum_similarity=0.5),
        rtol=0, atol=IC_ATOL)
    assert port.get_similarity_from_node_ids(int(a[0]), int(b[0])) == pytest.approx(
        want.get_similarity_from_node_ids(int(a[0]), int(b[0])), rel=0, abs=IC_ATOL)


def test_dag_resnik_by_names_prefixes_and_dataframe():
    """tests/test_utils_extras.py::test_dag_resnik on the port, each query
    against the reference's."""
    port, want = _fit_both(_toy_dag())
    assert port.get_information_content()[0] == 0.0
    assert port.get_similarity_from_node_ids(3, 4) > port.get_similarity_from_node_ids(3, 5)
    for method, args in (
            ("get_similarities_from_bipartite_graph_node_names", (["t3", "t4"], ["t5", "t6"])),
            ("get_similarities_from_bipartite_graph_node_prefixes", (["t1", "t3"], ["t"])),
            ("get_similarities_from_clique_graph_node_names", (["t1", "t3", "t4"],))):
        np.testing.assert_allclose(getattr(port, method)(*args), getattr(want, method)(*args),
                                   rtol=0, atol=IC_ATOL)
    for minimum in (None, 0.5):
        got = port.get_similarities_from_bipartite_graph_node_names(
            ["t3", "t1"], ["t4", "t5"], minimum_similarity=minimum,
            return_similarities_dataframe=True)
        ref = want.get_similarities_from_bipartite_graph_node_names(
            ["t3", "t1"], ["t4", "t5"], minimum_similarity=minimum,
            return_similarities_dataframe=True)
        assert list(got.columns) == list(ref.columns) == ["source", "destination",
                                                          "resnik_score"]
        assert got[["source", "destination"]].equals(ref[["source", "destination"]])
        np.testing.assert_allclose(got["resnik_score"], ref["resnik_score"], rtol=0,
                                   atol=IC_ATOL)


def test_unfitted_raises():
    with pytest.raises(ValueError, match="fitted"):
        similarities.DAGResnik().get_information_content()


def _closure(seed: int, n: int = 300):
    """A rank-sorted CSR closure, as `DAGResnik._fit_csr` builds it."""
    model = similarities.DAGResnik()
    model._fit_csr(_port_graph(_random_dag(n, seed)), np.ones(n))
    return model._anc_indptr, model._anc_ranks, model._ic_by_rank


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("threads", [None, 1, 3])
def test_dag_mica_block_equals_plain(seed, threads):
    indptr, ranks, ic = _closure(seed)
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 300, 130), rng.integers(0, 300, 70)
    got = native.dag_mica_block(indptr, ranks, ic, src, dst, n_threads=threads)
    np.testing.assert_array_equal(got, native.dag_mica_block_plain(indptr, ranks, ic, src, dst))
    assert got.shape == (130, 70) and (got > 0).any()


def test_dag_mica_block_refuses_ids_outside_the_closure():
    indptr, ranks, ic = _closure(0)
    with pytest.raises(ValueError, match="outside"):
        native.dag_mica_block(indptr, ranks, ic, [300], [0])


@pytest.mark.parametrize("kind", ["er", "sparse", "isolated", "empty"])
def test_connected_components_equal_plain_and_scipy(kind):
    n = 500
    if kind == "empty":
        src = dst = np.zeros(0, np.int64)
    else:
        g = erdos_renyi(n, {"er": 2000, "sparse": 300, "isolated": 100}[kind], seed=4)
        src, dst = g.sources, g.col_idx
    got = native.connected_components(src, dst, n)
    assert got[0].dtype == np.int32
    want = native.connected_components_plain(src, dst, n)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    count, labels = csgraph.connected_components(
        sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)), directed=False)
    assert got[1] == count
    np.testing.assert_array_equal(got[0], labels)


def test_graph_components_equal_reference():
    """`Graph.connected_components` (the native union-find) returns the
    reference's (scipy's) labels, arcs read as undirected."""
    er = ref_erdos_renyi(400, 300, seed=2)
    keep = er.sources < er.col_idx
    ref = RefGraph.from_edge_arrays(er.sources[keep], er.col_idx[keep], n_nodes=400,
                                    directed=True)
    comp, n = _port_graph(ref).connected_components()
    want_comp, want_n = ref.connected_components()
    assert n == want_n > 1
    np.testing.assert_array_equal(comp, want_comp)
