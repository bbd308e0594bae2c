"""The port's host graph (CSR build, generators, alias tables) and its
device export, held field by field against embiggen_tpu."""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu_torch.graph import Graph, TorchGraph, build_alias_tables, erdos_renyi

torch.set_num_threads(1)


def _assert_same_graph(port, ref):
    np.testing.assert_array_equal(port.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(port.col_idx, ref.col_idx)
    assert port.col_idx.dtype == ref.col_idx.dtype
    assert port.directed == ref.directed
    assert port.name == ref.name
    assert (port.weights is None) == (ref.weights is None)
    if port.weights is not None:
        np.testing.assert_array_equal(port.weights, ref.weights)
    assert port.number_of_nodes == ref.number_of_nodes
    assert port.number_of_directed_edges == ref.number_of_directed_edges
    np.testing.assert_array_equal(port.degrees, ref.degrees)
    np.testing.assert_array_equal(port.sources, ref.sources)
    np.testing.assert_array_equal(port.get_node_names(), ref.get_node_names())
    assert port.has_edge_weights == ref.has_edge_weights


@pytest.mark.parametrize("kwargs", [
    dict(n_nodes=200, n_edges=800, seed=7, weighted=True, n_edge_types=3,
         n_node_types=4),
    dict(n_nodes=500, n_edges=3000, seed=0),
    dict(n_nodes=50, n_edges=600, seed=3, weighted=True),
])
def test_erdos_renyi_matches_reference(kwargs):
    """The CSR, weights, edge types and node types, drawn in the
    reference's order."""
    port, ref = erdos_renyi(**kwargs), ref_erdos_renyi(**kwargs)
    _assert_same_graph(port, ref)
    _assert_same_types(port, ref)
    for field in ("node_type_ptr", "node_type_ids"):
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("with_attrs", [False, True])
@pytest.mark.parametrize("seed", [11, 12])
def test_from_edge_arrays_matches_reference(directed, with_attrs, seed):
    rng = np.random.default_rng(seed)
    n = 40
    src = rng.integers(0, n, 300)
    dst = rng.integers(0, n, 300)   # with self-loops and duplicates
    kw = dict(n_nodes=n + 3, directed=directed, name="g")   # 3 isolated nodes
    if with_attrs:
        kw["weights"] = rng.uniform(0.1, 3.0, 300).astype(np.float32)
        kw["edge_types"] = rng.integers(0, 4, 300).astype(np.int32)
    port, ref = Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)
    _assert_same_graph(port, ref)
    _assert_same_types(port, ref)


def test_karate_rebuilt_from_arrays(karate):
    # Its arcs are already symmetric: symmetrizing again and deduplicating
    # must give back the same CSR.
    port = Graph.from_edge_arrays(
        karate.sources, karate.col_idx, n_nodes=karate.number_of_nodes,
        name=karate.name,
    )
    _assert_same_graph(port, karate)


def _implied_probabilities(row_ptr, prob, alias):
    """Per-arc probability a Walker alias draw gives: slot i is kept with
    prob[i] and is the alias of slot j with 1 - prob[j], each slot 1/deg."""
    out = np.zeros(len(prob), np.float64)
    for r in range(len(row_ptr) - 1):
        s, e = row_ptr[r], row_ptr[r + 1]
        d = e - s
        if d == 0:
            continue
        p = np.asarray(prob[s:e], np.float64)
        got = p.copy()
        np.add.at(got, alias[s:e], 1.0 - p)
        out[s:e] = got / d
    return out


def _normalised_weights(row_ptr, weights):
    out = np.zeros(len(weights), np.float64)
    for r in range(len(row_ptr) - 1):
        s, e = row_ptr[r], row_ptr[r + 1]
        if e > s:
            out[s:e] = weights[s:e] / weights[s:e].sum()
    return out


def test_alias_tables_give_normalised_weights(er_graph):
    prob, alias = build_alias_tables(er_graph.row_ptr, er_graph.weights)
    assert prob.dtype == np.float32 and alias.dtype == np.int32
    deg = np.repeat(np.diff(er_graph.row_ptr), np.diff(er_graph.row_ptr))
    assert (alias >= 0).all() and (alias < deg).all()
    np.testing.assert_allclose(
        _implied_probabilities(er_graph.row_ptr, prob, alias),
        _normalised_weights(er_graph.row_ptr, er_graph.weights),
        rtol=1e-5, atol=1e-7,
    )


def test_alias_tables_uniform_rows_are_identity():
    row_ptr = np.array([0, 3, 3, 5])
    prob, alias = build_alias_tables(row_ptr, np.ones(5, np.float32))
    np.testing.assert_array_equal(prob, 1.0)
    np.testing.assert_array_equal(alias, [0, 1, 2, 0, 1])


@pytest.mark.parametrize("with_alias", [False, True])
def test_device_export_matches_reference(er_graph, with_alias):
    port = erdos_renyi(200, 800, seed=7, weighted=True)   # er_graph untyped
    tg = port.device("cpu", with_alias=with_alias)
    dg = er_graph.device(with_alias=with_alias)
    assert isinstance(tg, TorchGraph)
    assert tg.device == torch.device("cpu")
    for field in ("row_ptr", "col_idx", "degrees", "weights"):
        t, ref = getattr(tg, field), np.asarray(getattr(dg, field))
        assert t.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[ref.dtype]
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=field)
    assert (tg.n_nodes, tg.n_arcs, tg.max_degree) == (
        dg.n_nodes, dg.n_arcs, dg.max_degree)
    if not with_alias:
        assert tg.alias_prob is None and tg.alias_idx is None
        return
    assert tg.alias_prob.dtype == torch.float32
    assert tg.alias_idx.dtype == torch.int32
    # The reference may build its tables natively in another pairing order;
    # both must give the same per-arc probabilities.
    np.testing.assert_allclose(
        _implied_probabilities(port.row_ptr, tg.alias_prob.numpy(),
                               tg.alias_idx.numpy()),
        _implied_probabilities(er_graph.row_ptr, np.asarray(dg.alias_prob),
                               np.asarray(dg.alias_idx)),
        rtol=1e-5, atol=1e-7,
    )



# ------------------------------------------------------------- edge types
def _typed_arrays(seed, n=40, m=300, n_types=4):
    """Arcs with self-loops and duplicates (with other types), and types."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m), rng.integers(0, n, m),
            rng.integers(0, n_types, m).astype(np.int32), rng)


def _assert_same_types(port, ref):
    assert port.has_edge_types == ref.has_edge_types
    assert port.number_of_edge_types == ref.number_of_edge_types
    if ref.edge_types is None:
        assert port.edge_types is None and port.get_edge_type_names() is None
        return
    assert port.edge_types.dtype == ref.edge_types.dtype
    assert port.edge_types.tobytes() == ref.edge_types.tobytes()
    np.testing.assert_array_equal(port.get_edge_type_names(), ref.get_edge_type_names())


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("named", [False, True])
@pytest.mark.parametrize("seed", [21, 22])
def test_typed_from_edge_arrays_matches_reference(directed, weighted, named, seed):
    """Types are symmetrized with the arcs; a duplicate arc keeps the type
    of its first occurrence: row_ptr, col_idx and edge_types byte for byte."""
    src, dst, types, rng = _typed_arrays(seed)
    kw = dict(n_nodes=43, directed=directed, name="typed", edge_types=types)
    if weighted:
        kw["weights"] = rng.uniform(0.1, 3.0, len(src)).astype(np.float32)
    if named:
        kw["edge_type_names"] = ["a", "b", "c", "d"]
    port = Graph.from_edge_arrays(src, dst, **kw)
    ref = RefGraph.from_edge_arrays(src, dst, **kw)
    _assert_same_graph(port, ref)
    assert port.row_ptr.tobytes() == ref.row_ptr.tobytes()
    assert port.col_idx.tobytes() == ref.col_idx.tobytes()
    _assert_same_types(port, ref)


def test_untyped_graph_has_no_types():
    g = erdos_renyi(50, 100, seed=1)
    assert not g.has_edge_types and g.number_of_edge_types == 0
    assert g.get_edge_type_names() is None
    assert g.device("cpu").edge_types is None


def test_device_exports_edge_types():
    src, dst, types, _ = _typed_arrays(23)
    port = Graph.from_edge_arrays(src, dst, edge_types=types)
    ref = RefGraph.from_edge_arrays(src, dst, edge_types=types)
    tg = port.device("cpu", with_sources=True)
    assert tg.edge_types.dtype == torch.int32
    np.testing.assert_array_equal(tg.edge_types.numpy(), np.asarray(ref.device().edge_types))


@pytest.mark.parametrize("directed", [False, True])
def test_graph_methods_carry_edge_types(directed):
    """Every way the port builds a graph from a typed one keeps the types as
    the reference does: filter_edges, `&`, the holdouts, and the alignment
    of a subgraph by node names."""
    from embiggen_tpu.graph import holdouts as ref_holdouts
    from embiggen_tpu_torch.graph import connected_holdout, random_holdout
    from embiggen_tpu_torch.pipelines.evaluation import _align_subgraph

    src, dst, types, rng = _typed_arrays(24, n=60, m=400)
    kw = dict(n_nodes=60, directed=directed, edge_types=types,
              edge_type_names=["a", "b", "c", "d"])
    port, ref = Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)
    keep = rng.random(port.number_of_directed_edges) < 0.6
    _assert_same_types(port.filter_edges(keep), ref.filter_edges(keep))
    other_p, other_r = port.filter_edges(~keep), ref.filter_edges(~keep)
    _assert_same_types(port & other_p, ref & other_r)
    for split, ref_split in ((connected_holdout, ref_holdouts.connected_holdout),
                             (random_holdout, ref_holdouts.random_holdout)):
        for got, want in zip(split(port, random_state=5), ref_split(ref, random_state=5)):
            _assert_same_graph(got, want)
            _assert_same_types(got, want)
    renamed = Graph.from_edge_arrays(
        port.sources, port.col_idx, n_nodes=60, directed=True, directed_flag=directed,
        edge_types=port.edge_types, edge_type_names=port.edge_type_names,
        node_names=[f"node_{i}" for i in range(60)][::-1])
    aligned = _align_subgraph(port, renamed)
    # Node i of `renamed` is node 59 - i of `port`: each arc keeps its type.
    keys = aligned.sources.astype(np.int64) * 60 + aligned.col_idx
    pos = np.searchsorted(keys, (59 - renamed.sources.astype(np.int64)) * 60
                          + (59 - renamed.col_idx))
    np.testing.assert_array_equal(aligned.edge_types[pos], renamed.edge_types)
    np.testing.assert_array_equal(aligned.edge_type_names, port.edge_type_names)
