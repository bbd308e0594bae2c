"""The port's host copies for the evaluation harness — Barabasi-Albert
graphs, the k-fold split, edge-set intersection, name lookups, the
edge-list loader, `get_dataset` and the holdout-to-worker filter — held
exactly against embiggen_tpu on the same inputs."""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import loaders as ref_loaders
from embiggen_tpu.graph.generators import barabasi_albert as ref_barabasi_albert
from embiggen_tpu.graph.holdouts import edge_prediction_kfold as ref_kfold
from embiggen_tpu.parallel.distributed import (
    holdout_belongs_to_this_worker as ref_belongs,
)
from embiggen_tpu_torch.graph import (
    Graph, barabasi_albert, edge_prediction_kfold, erdos_renyi, from_csv,
    get_dataset, karate_club, small_ppi,
)
from embiggen_tpu_torch.parallel import holdout_belongs_to_this_worker

torch.set_num_threads(1)


def _same_csr(port, ref, names=False):
    np.testing.assert_array_equal(port.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(port.col_idx, ref.col_idx)
    assert port.directed == ref.directed and port.name == ref.name
    assert (port.weights is None) == (ref.weights is None)
    if port.weights is not None:
        np.testing.assert_array_equal(port.weights, ref.weights)
    if names:
        assert list(port.get_node_names()) == list(ref.get_node_names())


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_nodes=120, n_edges=500, seed=9, weighted=True)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


@pytest.mark.parametrize("n_nodes, m, seed", [(300, 3, 0), (60, 5, 4), (4, 5, 1)])
def test_barabasi_albert_matches_reference(n_nodes, m, seed):
    _same_csr(barabasi_albert(n_nodes, m, seed=seed),
              ref_barabasi_albert(n_nodes, m, seed=seed))


@pytest.mark.parametrize("k, holdout_number", [(10, 0), (10, 13), (3, 2)])
def test_kfold_matches_reference(graphs, k, holdout_number):
    port, ref = graphs
    for a, b in zip(edge_prediction_kfold(port, k, holdout_number, random_state=5),
                    ref_kfold(ref, k, holdout_number, random_state=5)):
        _same_csr(a, b)


def test_intersection_filters_and_names_match_reference(graphs):
    port, ref = graphs
    other_p = erdos_renyi(120, 900, seed=10)
    other_r = ref_erdos_renyi(120, 900, seed=10)
    _same_csr(port & other_p, ref & other_r)
    mask = np.arange(port.number_of_directed_edges) % 3 == 0
    _same_csr(port.filter_edges(mask, name="f"), ref.filter_edges(mask, name="f"))
    names = [f"n{i:03d}" for i in range(6)]
    kw = dict(n_nodes=6, node_names=names, name="d")
    flagged = Graph.from_edge_arrays([0, 1, 4], [1, 2, 4], directed=True,
                                     directed_flag=False, **kw)
    _same_csr(flagged, RefGraph.from_edge_arrays(
        [0, 1, 4], [1, 2, 4], directed=True, directed_flag=False, **kw), names=True)
    assert not flagged.directed and flagged.number_of_directed_edges == 3
    ref_flagged = RefGraph.from_edge_arrays([0, 1, 4], [1, 2, 4], directed=True, **kw)
    query = ["n004", "n000", "n002"]
    np.testing.assert_array_equal(flagged.get_node_ids_from_names(query),
                                  ref_flagged.get_node_ids_from_names(query))
    np.testing.assert_array_equal(flagged.get_node_ids_from_prefixes(["n00"]),
                                  ref_flagged.get_node_ids_from_prefixes(["n00"]))
    with pytest.raises(KeyError):
        flagged.get_node_ids_from_names(["missing"])


def _write_tsv(path, rows, header="subject\tobject\tweight", sep="\t"):
    path.write_text(header + "\n" + "\n".join(sep.join(map(str, r)) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("directed", [False, True])
def test_from_csv_matches_reference(tmp_path, directed):
    rng = np.random.default_rng(2)
    names = np.array([f"G{i}" for i in rng.permutation(40)])
    rows = [(names[a], names[b], round(float(w), 3)) for a, b, w in zip(
        rng.integers(0, 40, 150), rng.integers(0, 40, 150), rng.uniform(0.1, 2, 150))]
    path = _write_tsv(tmp_path / "edges.tsv", rows)
    got = from_csv(path, directed=directed)
    want = ref_loaders.from_csv(path, directed=directed, use_native_parser=False)
    _same_csr(got, want, names=True)
    unweighted = _write_tsv(tmp_path / "plain.csv", [r[:2] for r in rows], "subject,object", ",")
    _same_csr(from_csv(unweighted, sep=","),
              ref_loaders.from_csv(unweighted, sep=",", use_native_parser=False), names=True)
    typed = _write_tsv(tmp_path / "typed.tsv",
                       [r[:2] + ("xy"[i % 2],) for i, r in enumerate(rows)],
                       "subject\tobject\tedge_label")
    got_typed = from_csv(typed)
    want_typed = ref_loaders.from_csv(typed, use_native_parser=False)
    _same_csr(got_typed, want_typed, names=True)
    np.testing.assert_array_equal(got_typed.edge_types, want_typed.edge_types)
    assert list(got_typed.get_edge_type_names()) == list(want_typed.get_edge_type_names())
    with pytest.raises(ValueError, match="no column"):
        from_csv(path, source_column="source")


def test_get_dataset_matches_reference(tmp_path, monkeypatch):
    rows = [("a", "b", 1.0), ("b", "c", 2.0), ("c", "a", 0.5), ("d", "a", 1.5)]
    path = _write_tsv(tmp_path / "Usair97.tsv", rows)
    _same_csr(get_dataset("Usair97", path=path),
              ref_loaders.get_dataset("Usair97", path=path), names=True)
    monkeypatch.setenv("EMBIGGEN_DATA_DIR", str(tmp_path))
    _same_csr(get_dataset("usair-97"), ref_loaders.get_dataset("usair-97"), names=True)
    monkeypatch.delenv("EMBIGGEN_DATA_DIR")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="synthetic_fallback"):
        get_dataset("Usair97")
    stand_in = get_dataset("Usair97", synthetic_fallback=True)
    _same_csr(stand_in, ref_loaders.get_dataset("Usair97", synthetic_fallback=True))
    assert stand_in.name == "Usair97SyntheticStandIn" and stand_in.number_of_nodes == 332
    _same_csr(get_dataset("Synthetic"), ref_loaders.get_dataset("Synthetic"))
    with pytest.raises(KeyError, match="repository"):
        get_dataset("Usair97", repository="linqs")
    with pytest.raises(KeyError, match="Unknown dataset"):
        get_dataset("NoSuchGraph")
    # The typed datasets: their stand-in, the bundled graphs.
    for port_graph, ref_graph in (
        (get_dataset("Cora", synthetic_fallback=True),
         ref_loaders.get_dataset("Cora", synthetic_fallback=True)),
        (get_dataset("KarateClub"), ref_loaders.get_dataset("KarateClub")),
        (karate_club(), ref_loaders.karate_club()), (small_ppi(), ref_loaders.small_ppi()),
    ):
        _same_csr(port_graph, ref_graph, names=True)
        for field in ("edge_types", "node_type_ids"):
            a, b = getattr(port_graph, field), getattr(ref_graph, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_holdout_worker_filter_matches_reference(monkeypatch):
    cases = [(h, w, i) for h in range(6) for w in (None, 1, 2, 3) for i in (None, 0, 1, 2)]
    for h, w, i in cases:
        assert holdout_belongs_to_this_worker(h, w, i) == ref_belongs(h, w, i)
    monkeypatch.setenv("EMBIGGEN_TPU_WORKER_COUNT", "3")
    monkeypatch.setenv("EMBIGGEN_TPU_WORKER_ID", "2")
    for h in range(6):
        assert holdout_belongs_to_this_worker(h) == ref_belongs(h) == (h % 3 == 2)
