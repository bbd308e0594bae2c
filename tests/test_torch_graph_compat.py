"""The reference-named Graph surface (`graph/compat.py` and the Graph's own
names) against embiggen_tpu's, on the CPU.

- The port's `Graph` has every public name of the reference's `Graph` and
  its `ReferenceGraphAPI` mixin: 0 missing.
- Every zero-argument method, on tests/test_graph_compat.py's typed,
  weighted `erdos_renyi(120, 400, seed=3, ...)` built from the same arrays
  in both packages, gives the reference's result: exactly for integers,
  booleans, names and graphs' arrays, within 1e-6 relative for floats. The
  methods that run on a device get `device="cpu"`. The three that need an
  ontology or a DAG raise in both.
- The methods that take arguments, spot-checked as tests/test_graph_compat.py
  checks them, each against the reference's answer.
- The batch methods on the CPU: each returns what its op returns when called
  directly under a generator seeded with the same `random_state`; walk
  steps are arcs and the contexts follow `skipgram_pairs`' layout;
  positives are arcs and the labels are ones then zeros; siamese tuples
  have 4 or 5 members.
- `from_pandas` and `sample_positive_graph` give the reference's graphs.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import karate_club as ref_karate_club
from embiggen_tpu.graph.compat import ReferenceGraphAPI as RefAPI
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.graph.compat import ReferenceGraphAPI
from embiggen_tpu_torch.ops.negatives import edge_prediction_mini_batch, siamese_mini_batch
from embiggen_tpu_torch.ops.walks import node2vec_batch, skipgram_pairs

torch.set_num_threads(1)

FLOAT_RTOL = 1e-6


def _port_graph(ref: RefGraph) -> Graph:
    return Graph(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(RefGraph)})


def _typed_ref() -> RefGraph:
    return ref_erdos_renyi(120, 400, seed=3, weighted=True, n_edge_types=3, n_node_types=2,
                           name="TypedER")


@pytest.fixture(scope="module")
def graphs():
    ref = _typed_ref()
    return ref, _port_graph(ref)


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_no_reference_name_is_missing():
    missing = sorted(_public(RefGraph) - _public(Graph))
    assert missing == []
    assert _public(RefAPI) <= _public(ReferenceGraphAPI)
    assert issubclass(Graph, ReferenceGraphAPI)


def _zero_arg_methods():
    out = []
    for name, fn in inspect.getmembers(RefGraph, inspect.isfunction):
        if name.startswith("_") or name == "device":
            continue
        if not [p for p in inspect.signature(fn).parameters.values()
                if p.name != "self" and p.default is inspect.Parameter.empty
                and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]:
            out.append(name)
    return out


# Methods that raise on a graph lacking the structure they need (ontologies,
# a DAG), in both packages.
_MAY_RAISE = {
    "must_have_node_ontologies",
    "get_shared_ancestors_size_adjacency_matrix",
    "get_shared_ancestors_jaccard_adjacency_matrix",
}


def _assert_same(got, want, path="result"):
    """Equal results: graphs field by field, containers member by member,
    float arrays and floats within FLOAT_RTOL, anything else exactly (with
    its type and dtype)."""
    if isinstance(want, RefGraph):
        assert isinstance(got, Graph), path
        for f in dataclasses.fields(RefGraph):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, path
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype, path
            np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, err_msg=path)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), path
    elif hasattr(want, "equals"):        # a DataFrame
        assert want.equals(got), path
    elif isinstance(want, float):
        assert type(got) is float, path
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _call(graph, name, *args, **kwargs):
    fn = getattr(graph, name)
    if isinstance(graph, Graph) and "device" in inspect.signature(fn).parameters:
        kwargs["device"] = "cpu"
    return fn(*args, **kwargs)


@pytest.mark.parametrize("method", _zero_arg_methods())
def test_zero_arg_method_matches_reference(graphs, method):
    ref, port = graphs
    if method in _MAY_RAISE:
        for g in (ref, port):
            with pytest.raises(ValueError):
                _call(g, method)
        return
    _assert_same(_call(port, method), _call(ref, method), method)


@pytest.mark.parametrize("name", ["density", "destinations", "number_of_connected_components"])
def test_properties_match_reference(graphs, name):
    ref, port = graphs
    _assert_same(getattr(port, name), getattr(ref, name), name)


def test_zero_arg_sweep_covers_the_mixin():
    names = set(_zero_arg_methods())
    assert len(names) >= 120
    assert {"connected_components", "to_dot", "consistent_hash", "get_all_edge_metrics",
            "get_dense_modularity_matrix", "remove_disconnected_nodes"} <= names


ARG_CALLS = [
    ("get_node_ids_from_edge_id", (7,)),
    ("get_node_names_from_edge_id", (7,)),
    ("get_edge_id_from_node_ids", None),            # the arc of edge 7
    ("get_node_name_from_node_id", (5,)),
    ("get_node_names_from_node_ids", ([5, 6],)),
    ("get_node_id_from_node_name", ("node_5",)),
    ("has_node_name", ("node_5",)),
    ("has_node_name", ("__nope__",)),
    ("get_node_degree_from_node_id", (3,)),
    ("get_edge_weight_from_edge_id", (3,)),
    ("get_unchecked_edge_weight_from_edge_id", (3,)),
    ("get_edge_type_name_from_edge_id", (3,)),
    ("get_edge_type_name_from_edge_type_id", (1,)),
    ("get_node_type_ids_from_node_id", (0,)),
    ("get_node_type_names_from_node_id", (0,)),
    ("get_node_type_name_from_node_type_id", (1,)),
    ("has_node_type_name", ("node_type_1",)),
    ("has_edge_type_name", ("edge_type_2",)),
    ("get_ontology_from_node_id", (4,)),
    ("neighbors", (9,)),
    ("get_imputed_directed_edge_type_ids", (2,)),
    ("set_all_node_types", ("only",)),
    ("set_all_edge_types", ("rel",)),
    ("remove_inplace_edge_type_name", ("edge_type_1",)),
    ("add_selfloops", ("loop", 2.0)),
    ("add_node", ("newbie", ["node_type_0", "fresh"])),
    ("add_edge", ("node_0", "node_7")),
    ("filter_from_names", (["node_1", "node_2", "node_9", "node_40"],)),
    ("filter_from_names", (None, ["node_1", "node_2"])),
    ("relabel", (np.random.default_rng(0).permutation(120),)),
    ("connected_holdout", (0.7, 7)),
    ("random_holdout", (0.6, 3)),
    ("get_edge_prediction_kfold", (4, 1, 5)),
    ("get_node_label_holdout_graphs", (0.7, True, 2)),
    ("get_node_label_kfold", (3, 2, True, 4)),
    ("get_edge_label_holdout_graphs", (0.7, True, 2)),
    ("get_edge_label_kfold", (3, 1, 4)),
    ("sample_negative_graph", (300, 11)),
    ("sample_negative_graph", (200, 5, False)),
    ("sample_positive_graph", (150, 9)),
    ("get_all_edge_metrics_from_node_ids", (np.array([0, 1, 2, 7]), np.array([3, 4, 5, 7]))),
    ("get_all_edge_metrics_from_node_ids", (np.array([0, 1, 2]), np.array([3, 4, 5]), True)),
    ("get_all_edge_metrics", (True,)),
    ("get_approximated_closeness_centrality", (30, 3)),
    ("get_approximated_harmonic_centrality", (30, 3)),
    ("get_shortest_paths_matrix", (np.arange(4),)),
    ("get_breadth_first_search_from_node_names", ("node_0",)),
    ("build_bipartite_graph_from_edge_node_ids", ([0, 1, 2], [3, 4])),
    ("build_bipartite_graph_from_edge_node_names", (["node_0", "node_1"], ["node_2", "node_3"])),
    ("build_bipartite_graph_from_edge_node_prefixes", (["node_1"], ["node_2"])),
    ("build_bipartite_graph_from_edge_node_types", (["node_type_0"], ["node_type_1"])),
    ("build_clique_graph_from_node_ids", ([0, 1, 2, 3],)),
    ("build_clique_graph_from_node_names", (["node_0", "node_5", "node_6"],)),
    ("build_clique_graph_from_node_prefixes", (["node_11"],)),
    ("build_clique_graph_from_node_type_names", (["node_type_0"],)),
    ("get_edge_prediction_chunk_mini_batch", (2, None, 64)),
]


@pytest.mark.parametrize("method, args", ARG_CALLS,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(ARG_CALLS)])
def test_method_with_arguments_matches_reference(graphs, method, args):
    ref, port = graphs
    if args is None:
        args = tuple(int(x) for x in ref.get_node_ids_from_edge_id(7))
    _assert_same(_call(port, method, *args), _call(ref, method, *args), method)


def test_methods_taking_graphs_match_reference(graphs):
    ref, port = graphs
    sub_ref = ref.filter_edges(np.arange(ref.number_of_directed_edges) % 3 == 0)
    sub_port = port.filter_edges(np.arange(port.number_of_directed_edges) % 3 == 0)
    for method in ("intersection", "difference", "has_compatible_node_vocabularies",
                   "has_compatible_node_types_vocabularies",
                   "has_compatible_edge_types_vocabularies", "get_node_ids_mapping_from_graph",
                   "get_non_zero_subgraph_node_degrees"):
        _assert_same(getattr(port, method)(sub_port), getattr(ref, method)(sub_ref), method)
    _assert_same(port.get_all_edge_metrics(subgraph=sub_port, device="cpu"),
                 ref.get_all_edge_metrics(subgraph=sub_ref), "subgraph metrics")


def test_structure_on_karate():
    """tests/test_graph_compat.py::test_structure_mutators and
    test_traversal, on the port, against the reference."""
    ref = ref_karate_club()
    port = _port_graph(ref)
    for method, args in (("to_transposed", ()), ("add_selfloops", ()), ("add_node", ("newbie",)),
                         ("get_connected_components", ()), ("to_dot", ()),
                         ("get_breadth_first_search_from_node_names",
                          (ref.get_node_name_from_node_id(0),))):
        _assert_same(getattr(port, method)(*args), getattr(ref, method)(*args), method)
    g3 = port.add_node("newbie").add_edge("newbie", port.get_node_name_from_node_id(0))
    _assert_same(g3, ref.add_node("newbie").add_edge("newbie", ref.get_node_name_from_node_id(0)))
    assert port.is_connected() and port.sort_by_decreasing_outbound_node_degree(
    ).is_sorted_by_decreasing_outbound_node_degree()


def test_dag_ancestor_matrices_match_reference():
    ref = RefGraph.from_edge_arrays(np.asarray([1, 2, 3, 3]), np.asarray([0, 0, 1, 2]),
                                    n_nodes=4, directed=True, name="dag")
    port = _port_graph(ref)
    for method in ("get_shared_ancestors_size_adjacency_matrix",
                   "get_shared_ancestors_jaccard_adjacency_matrix",
                   "get_neighbours_intersection_size_coo_matrix", "get_jaccard_coo_matrix",
                   "get_adamic_adar_coo_matrix"):
        _assert_same(getattr(port, method)(), getattr(ref, method)(), method)


def test_edge_id_of_a_missing_arc_raises(graphs):
    _, port = graphs
    with pytest.raises(ValueError, match="No edge"):
        port.get_edge_id_from_node_ids(0, 0)


def _generator(seed):
    return torch.Generator().manual_seed(seed)


def _is_arc_or_stay(graph, a, b):
    """Each step a -> b is an arc, or a stay at a node without arcs."""
    return graph.has_edges(a, b) | ((a == b) & (graph.degrees[a] == 0))


@pytest.mark.parametrize("weights", [(1.0, 1.0), (2.0, 0.5), (0.25, 4.0)])
def test_node2vec_is_its_op(graphs, weights):
    """`node2vec` on the CPU: the starts by `torch.randint` under the seeded
    generator, then `node2vec_batch` under the same generator (K1's plain
    version at p = q = 1, K10's at the other weights)."""
    _, port = graphs
    window, length, batch, iterations = 3, 12, 40, 2
    contexts, words = port.node2vec(random_state=4, batch_size=batch, walk_length=length,
                                    window_size=window, iterations=iterations,
                                    return_weight=weights[0], explore_weight=weights[1],
                                    device="cpu")
    tg = port.device("cpu")
    g = _generator(4)
    starts = torch.randint(0, 120, (batch,), generator=g, dtype=torch.int32)
    want = node2vec_batch(tg, starts, length, window, g, iterations=iterations,
                          return_weight=weights[0], explore_weight=weights[1],
                          max_neighbours=100)
    np.testing.assert_array_equal(contexts, want[0].numpy())
    np.testing.assert_array_equal(words, want[1].numpy())
    per_walk = length - 2 * window
    assert contexts.shape == (batch * iterations * per_walk, 2 * window)
    # Rebuild the walks from the pairs' layout: position w + i of walk r is
    # words[r * per_walk + i]; positions below w are the first centre's
    # contexts, those above L - w - 1 the last centre's.
    first, last = contexts[::per_walk], contexts[per_walk - 1::per_walk]
    walks = np.concatenate([first[:, :window], words.reshape(-1, per_walk),
                            last[:, window:]], axis=1)
    got_contexts, got_words = skipgram_pairs(torch.from_numpy(walks), window)
    np.testing.assert_array_equal(got_contexts.numpy(), contexts)
    np.testing.assert_array_equal(got_words.numpy(), words)
    assert _is_arc_or_stay(port, walks[:, :-1].ravel(), walks[:, 1:].ravel()).all()
    np.testing.assert_array_equal(walks[:, 0], starts.repeat(iterations).numpy())


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_edge_prediction_mini_batch_is_its_op(graphs, rate):
    _, port = graphs
    src, dst, labels = port.get_edge_prediction_mini_batch(5, batch_size=64,
                                                           negative_samples_rate=rate,
                                                           device="cpu")
    want = edge_prediction_mini_batch(port.device("cpu"), _generator(5), 64,
                                      negative_samples_rate=rate)
    for got, w in zip((src, dst, labels), want):
        np.testing.assert_array_equal(got, w.numpy())
    n_pos = 64 - int(round(64 * rate))
    np.testing.assert_array_equal(labels, np.r_[np.ones(n_pos), np.zeros(64 - n_pos)])
    assert labels.dtype == np.float32 and src.dtype == dst.dtype == np.int32
    assert port.has_edges(src[:n_pos], dst[:n_pos]).all()


@pytest.mark.parametrize("typed", [False, True])
def test_siamese_mini_batch_is_its_op(graphs, typed):
    _, port = graphs
    method = ("get_siamese_mini_batch_with_edge_types" if typed
              else "get_siamese_mini_batch")
    got = getattr(port, method)(3, 48, device="cpu")
    assert isinstance(got, tuple) and len(got) == (5 if typed else 4)
    want = siamese_mini_batch(port.device("cpu"), _generator(3), 48, with_edge_types=typed)
    np.testing.assert_array_equal(np.stack(got), want.numpy())
    src, dst, csrc, cdst = got[:4]
    assert port.has_edges(src, dst).all()
    assert ((csrc == src) | (cdst == dst)).all()
    if typed:
        np.testing.assert_array_equal(got[4], port.edge_types[port.get_edge_ids(src, dst)])


def test_device_graphs_are_cached_per_device(graphs):
    _, port = graphs
    tg = port._device_graph("cpu")
    assert port._device_graph(torch.device("cpu")) is tg
    assert tg.alias_prob is None and tg.ell_cols is None and tg.edge_types is not None
    # A graph built from it by `dataclasses.replace` starts without a cache.
    assert "_device_graphs" not in dataclasses.replace(port, name="other").__dict__


def test_from_pandas_matches_reference():
    import pandas as pd

    from embiggen_tpu.graph import from_pandas as ref_from_pandas
    from embiggen_tpu_torch.graph import from_pandas

    rng = np.random.default_rng(0)
    df = pd.DataFrame({"subject": rng.integers(0, 40, 150).astype(str),
                       "object": [f"n{i}" for i in rng.integers(0, 40, 150)],
                       "weight": rng.random(150), "edge_label": rng.choice(["a", "b", "c"], 150)})
    for kwargs in ({}, {"weight_column": "weight", "edge_type_column": "edge_label"},
                   {"weight_column": "weight", "directed": True, "name": "frame"},
                   {"weight_column": "absent"}):
        _assert_same(from_pandas(df, **kwargs), ref_from_pandas(df, **kwargs), str(kwargs))


@pytest.mark.parametrize("directed", [False, True])
def test_sample_positive_graph_matches_reference(directed):
    from embiggen_tpu.graph import sample_positive_graph as ref_sample
    from embiggen_tpu_torch.graph import sample_positive_graph

    ref = _typed_ref()
    if directed:
        ref = dataclasses.replace(ref, directed=True)
    for n in (10, 190, 10_000):
        _assert_same(sample_positive_graph(_port_graph(ref), n, random_state=n),
                     ref_sample(ref, n, random_state=n), str(n))
