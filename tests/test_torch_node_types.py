"""Node types on the port's Graph, held exactly to embiggen_tpu on the same
inputs: every node-type accessor (on single-label, multilabel and partly
unknown types), the typed generators, the bundled `karate_club` and
`small_ppi`, `from_csv` with an edge-type column, the types carried through
`from_edge_arrays`, `filter_edges`, `&` and the holdouts, and the typed
walks' device tables of `device(ell_cap=..., with_walk_types=True)` at a cap
that subsamples rows and at full rows."""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import generators as ref_generators
from embiggen_tpu.graph import holdouts as ref_holdouts
from embiggen_tpu.graph import loaders as ref_loaders
from embiggen_tpu_torch.graph import (
    Graph, connected_holdout, erdos_renyi, from_csv, get_dataset, karate_club,
    planted_partition, planted_partition_edges, random_geometric, random_holdout, small_ppi,
)

torch.set_num_threads(1)

FIELDS = ("row_ptr", "col_idx", "weights", "edge_types", "node_type_ptr", "node_type_ids")


def _same(port, ref):
    """Arrays byte for byte (node_type_ptr by value: its dtype is the
    caller's), names, directedness and every node-type accessor."""
    for field in FIELDS:
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=field)
            if field != "node_type_ptr":
                assert a.dtype == b.dtype, field
    assert (port.directed, port.name) == (ref.directed, ref.name)
    assert list(port.get_node_names()) == list(ref.get_node_names())
    for method in ("get_edge_type_names", "get_node_type_names"):
        a, b = getattr(port, method)(), getattr(ref, method)()
        assert (a is None) == (b is None), method
        if a is not None:
            assert list(a) == list(b), method
    assert port.has_node_types == ref.has_node_types
    assert port.number_of_node_types == ref.number_of_node_types
    assert port.has_multilabel_node_types() == ref.has_multilabel_node_types()
    for method in ("get_one_hot_encoded_node_types", "get_single_label_node_type_ids",
                   "get_known_node_types_mask"):
        a, b = getattr(port, method)(), getattr(ref, method)()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), method
    assert (port.is_sorted_by_decreasing_outbound_node_degree()
            == ref.is_sorted_by_decreasing_outbound_node_degree())
    assert repr(port) == repr(ref)


def _multilabel(seed, n=30, m=120, n_types=5, directed=False):
    """Arcs and a node-type CSR with nodes of 0 (unknown), 1 and 2-3 types,
    named."""
    rng = np.random.default_rng(seed)
    counts = rng.choice([0, 1, 1, 2, 3], n)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    ids = np.concatenate([rng.choice(n_types, c, replace=False) for c in counts]).astype(np.int32)
    kw = dict(n_nodes=n, directed=directed, name="ml", node_type_ptr=ptr, node_type_ids=ids,
              node_type_names=[f"t{i}" for i in range(n_types)],
              edge_types=rng.integers(0, 3, m).astype(np.int32))
    return rng.integers(0, n, m), rng.integers(0, n, m), kw


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multilabel_accessors_match_reference(directed, seed):
    src, dst, kw = _multilabel(seed, directed=directed)
    port, ref = Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)
    _same(port, ref)
    assert port.has_multilabel_node_types()
    assert (port.get_single_label_node_type_ids() == -1).any()
    for names in (["t0"], ["t1", "t3"], "t4", ["t0", "t1", "t2", "t3", "t4"]):
        got = port.get_node_ids_from_node_type_names(names)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.get_node_ids_from_node_type_names(names))
    with pytest.raises(ValueError, match="Unknown node type"):
        port.get_node_ids_from_node_type_names(["nope"])
    with pytest.raises(ValueError, match="no node types"):
        erdos_renyi(10, 20).get_node_ids_from_node_type_names(["t0"])


def test_untyped_graph_answers_as_reference():
    port = erdos_renyi(40, 100, seed=2)
    ref = ref_generators.erdos_renyi(40, 100, seed=2)
    _same(port, ref)
    assert not port.has_node_types and port.get_node_type_names() is None
    assert port.get_one_hot_encoded_node_types().shape == (40, 0)


@pytest.mark.parametrize("seed", [3, 4])
def test_graph_methods_carry_node_types(seed):
    """filter_edges, `&`, the connected and random holdouts."""
    src, dst, kw = _multilabel(seed, n=60, m=400)
    port, ref = Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)
    keep = np.random.default_rng(seed).random(port.number_of_directed_edges) < 0.6
    _same(port.filter_edges(keep), ref.filter_edges(keep))
    _same(port & port.filter_edges(~keep), ref & ref.filter_edges(~keep))
    for split, ref_split in ((connected_holdout, ref_holdouts.connected_holdout),
                             (random_holdout, ref_holdouts.random_holdout)):
        for got, want in zip(split(port, random_state=5), ref_split(ref, random_state=5)):
            _same(got, want)


@pytest.mark.parametrize("make", [
    lambda g: g.erdos_renyi(300, 1200, seed=3, weighted=True, n_edge_types=3, n_node_types=4),
    lambda g: g.erdos_renyi(200, 900, seed=5, n_node_types=2),
    lambda g: g.erdos_renyi(200, 900, seed=6, n_edge_types=8),
    lambda g: g.planted_partition(300, n_communities=3, p_in=0.05, p_out=0.002, seed=1),
    lambda g: g.planted_partition_edges(400, 1500, n_communities=5, seed=2),
    lambda g: g.random_geometric(300, 0.1, seed=1, n_grid_types=3),
], ids=["er typed", "er node types", "er edge types", "sbm", "sbm by edges", "rgg"])
def test_typed_generators_match_reference(make):
    import embiggen_tpu_torch.graph as port_generators

    _same(make(port_generators), make(ref_generators))


def test_bundled_graphs_match_reference():
    _same(karate_club(), ref_loaders.karate_club())
    _same(get_dataset("KarateClub"), ref_loaders.get_dataset("KarateClub"))
    port, ref = small_ppi(), ref_loaders.small_ppi()
    _same(port, ref)
    assert port.has_edge_types and port.has_edge_weights
    assert port.number_of_directed_edges == 6000
    _same(get_dataset("Cora", synthetic_fallback=True),
          ref_loaders.get_dataset("Cora", synthetic_fallback=True))
    assert planted_partition is not None and planted_partition_edges is not None


@pytest.mark.parametrize("first_seen", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_from_csv_with_edge_types_matches_reference(tmp_path, first_seen, weighted):
    """The pandas path numbers names and types sorted, the native parser in
    order of first appearance."""
    rng = np.random.default_rng(4)
    names = np.array([f"G{i}" for i in rng.permutation(50)])
    kinds = np.array(["inhibits", "binds", "activates"])
    rows = [(names[a], names[b], round(float(w), 3), kinds[t]) for a, b, w, t in zip(
        rng.integers(0, 50, 200), rng.integers(0, 50, 200), rng.uniform(0.1, 2, 200),
        rng.integers(0, 3, 200))]
    header = ["subject", "object", "weight", "edge_label"]
    keep = [0, 1, 2, 3] if weighted else [0, 1, 3]
    path = tmp_path / "typed.tsv"
    path.write_text("\n".join("\t".join(str(r[i]) if j else header[i] for i in keep)
                              for j, r in enumerate([rows[0]] + rows)) + "\n")
    got = from_csv(str(path), first_seen_ids=first_seen)
    want = ref_loaders.from_csv(str(path), use_native_parser=first_seen)
    _same(got, want)
    seen = list(dict.fromkeys(r[3] for r in rows))
    assert list(got.get_edge_type_names()) == (seen if first_seen else sorted(seen))


@pytest.mark.parametrize("cap, seed", [(8, 0), (8, 3), (1000, 0)])
@pytest.mark.parametrize("which", ["er typed", "er node types", "er edge types", "multilabel"])
def test_walk_type_tables_match_reference(cap, seed, which):
    """node_type_of, ell_ntypes and ell_etypes of `device(ell_cap,
    with_walk_types=True)`: at cap 8, over-cap rows hold a seeded subsample
    and their types follow it; at 1000, whole rows."""
    if which == "multilabel":
        src, dst, kw = _multilabel(seed, n=80, m=900)
        port = Graph.from_edge_arrays(src, dst, **kw)
        ref = RefGraph.from_edge_arrays(src, dst, **kw)
    else:
        kw = {"er typed": dict(n_edge_types=3, n_node_types=4, weighted=True),
              "er node types": dict(n_node_types=4),
              "er edge types": dict(n_edge_types=5)}[which]
        port = erdos_renyi(200, 1500, seed=seed, **kw)
        ref = ref_generators.erdos_renyi(200, 1500, seed=seed, **kw)
    tg = port.device("cpu", ell_cap=cap, ell_seed=seed, with_walk_types=True)
    dg = ref.device(ell_cap=cap, ell_seed=seed, with_walk_types=True)
    assert tg.ell_cap == dg.ell_cap
    if cap == 8:
        assert int(port.degrees.max()) > cap
    for field in ("ell_cols", "node_type_of", "ell_ntypes", "ell_etypes", "edge_types"):
        a, b = getattr(tg, field), getattr(dg, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == torch.int32, field
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)
    # Without with_walk_types, no type tables; the arcs' edge types stay.
    plain = port.device("cpu", ell_cap=cap, ell_seed=seed)
    assert plain.node_type_of is None and plain.ell_ntypes is None and plain.ell_etypes is None
    assert (plain.edge_types is None) == (port.edge_types is None)
    # Without an ELL table, node_type_of alone.
    bare = port.device("cpu", with_walk_types=True)
    assert bare.ell_ntypes is None and bare.ell_etypes is None
    assert (bare.node_type_of is None) == (not port.has_node_types)
