"""The spectral rows (HOPE, Laplacian Eigenmaps, GLEE, SocioDim) and HOPE's
similarity matrices against embiggen_tpu's, on the CPU: both compute on the
host with scipy and ARPACK in float64.

- `_similarity_matrix`: the sparsity pattern exactly the reference's, the
  values within 1e-12, for each of the 11 metrics on karate club (the
  three DAG metrics raise in both: karate club is undirected, so every arc
  lies on a cycle) and on the reference's toy DAG.
- The rows: the singular values (HOPE) or eigenvalues (the others), read
  from the ARPACK calls of both fits, within 1e-8 relative of the
  reference's. The embeddings agree up to what ARPACK leaves free. `svds`
  with `v0=None` draws its start vector from numpy's global state, and
  ARPACK's own start vector differs from call to call, so each vector
  comes back with either sign, and a basis of an eigenspace of repeated
  values comes back in any rotation. So: a column whose value is apart
  from its neighbours' by more than 1e-6 relative must have |cosine| >=
  1 - 1e-6 with the reference's column; a group of columns with values
  closer than that must span the reference's space, its orthogonal
  projector within 1e-6 of the reference's.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse.linalg

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import karate_club as ref_karate_club
from embiggen_tpu.models.embedders import spectral as ref_spectral
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.models import MODELS_LIBRARY
from embiggen_tpu_torch.models.embedders import spectral

MATRIX_ATOL = 1e-12     # the similarity matrices' values
VALUE_RTOL = 1e-8       # singular values and eigenvalues
GAP_RTOL = 1e-6         # a value this far from its neighbours has its own vector
COSINE_TOL = 1e-6       # |cosine| >= 1 - COSINE_TOL for such a vector
PROJECTOR_ATOL = 1e-6   # a group of close values: its projector

ROWS = {"HOPE": ref_spectral.HOPE, "Laplacian Eigenmaps": ref_spectral.LaplacianEigenmaps,
        "GLEE": ref_spectral.GeometricLaplacianEigenmaps, "SocioDim": ref_spectral.SocioDim}


def _port_graph(ref: RefGraph) -> Graph:
    return Graph(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(RefGraph)})


def _toy_dag() -> RefGraph:
    # tests/test_parity_breadth.py's: 0 is the root; arcs child -> parent.
    return RefGraph.from_edge_arrays(
        np.array([1, 2, 3, 4, 5, 6]), np.array([0, 0, 1, 1, 2, 2]), n_nodes=7, directed=True,
        node_names=[f"t{i}" for i in range(7)], name="toy_dag")


def _random_dag(n: int, seed: int) -> RefGraph:
    # tests/test_utils_extras.py's: each node but 0 picks 1-3 parents of
    # smaller id.
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(1, n):
        for p in rng.choice(v, size=int(rng.integers(1, min(3, v) + 1)), replace=False):
            src.append(v)
            dst.append(int(p))
    return RefGraph.from_edge_arrays(np.asarray(src), np.asarray(dst), n_nodes=n,
                                     directed=True, name=f"rand_dag{n}")


GRAPHS = {"karate": ref_karate_club, "toy_dag": _toy_dag}


def test_metric_lists_match_reference():
    assert spectral.HOPE_METRICS == ref_spectral.HOPE_METRICS
    assert spectral.DAG_METRICS == ref_spectral.DAG_METRICS


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("metric", ref_spectral.HOPE_METRICS)
def test_similarity_matrix_matches_reference(graph, metric):
    ref = GRAPHS[graph]()
    port = _port_graph(ref)
    if graph == "karate" and metric in ref_spectral.DAG_METRICS:
        for fn, g in ((ref_spectral._similarity_matrix, ref),
                      (spectral._similarity_matrix, port)):
            with pytest.raises(ValueError, match="not a DAG"):
                fn(g, metric)
        return
    want = ref_spectral._similarity_matrix(ref, metric).tocsr()
    got = spectral._similarity_matrix(port, metric).tocsr()
    want.sort_indices()
    got.sort_indices()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=MATRIX_ATOL)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="Unknown HOPE metric"):
        spectral.HOPE(metric="Cosine", device="cpu")
    with pytest.raises(ValueError, match="Unknown HOPE metric"):
        spectral._similarity_matrix(_port_graph(ref_karate_club()), "Cosine")


class _Recorder:
    """Wraps scipy's `svds` and `eigsh` and keeps the values each call
    returns (the singular values of svds, the eigenvalues of eigsh)."""

    def __init__(self, monkeypatch):
        self.values = []
        for name in ("svds", "eigsh"):
            fn = getattr(scipy.sparse.linalg, name)
            monkeypatch.setattr(scipy.sparse.linalg, name, self._wrap(fn, name))

    def _wrap(self, fn, name):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.values.append(np.asarray(out[1] if name == "svds" else out[0]))
            return out
        return call


def _fit_both(name, ref_graph, monkeypatch, **kwargs):
    """(port values, port embeddings, reference values, reference
    embeddings) of one fit each, the values read from the ARPACK call."""
    recorder = _Recorder(monkeypatch)
    port_cls = MODELS_LIBRARY["Node Embedding"][name]["Torch"]
    got = port_cls(device="cpu", **kwargs).fit_transform(_port_graph(ref_graph))
    want = ROWS[name](**kwargs).fit_transform(ref_graph)
    (got_values, want_values) = recorder.values
    return (got_values, [np.asarray(e) for e in got.node_embeddings],
            want_values, [np.asarray(e) for e in want.node_embeddings])


def _sorted_values(name, values, embedding_size):
    """The values of the returned columns, in the order the row returns
    them."""
    if name == "Laplacian Eigenmaps":
        return np.sort(values)[1:embedding_size + 1]
    return -np.sort(-values)


def _assert_same_columns(got, want, values):
    """Each column with a value apart from its neighbours' by more than
    GAP_RTOL (relative) against the reference's column by |cosine|; each
    group of closer values by the orthogonal projector of its columns."""
    scale = max(float(np.abs(values).max()), 1e-300)
    groups, start = [], 0
    for j in range(1, len(values) + 1):
        if j == len(values) or abs(values[j] - values[j - 1]) > GAP_RTOL * scale:
            groups.append(slice(start, j))
            start = j
    for group in groups:
        a, b = got[:, group].astype(np.float64), want[:, group].astype(np.float64)
        if a.shape[1] == 1:
            cosine = float(a[:, 0] @ b[:, 0] / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert abs(cosine) >= 1 - COSINE_TOL, (group, cosine)
        else:
            qa, qb = np.linalg.qr(a)[0], np.linalg.qr(b)[0]
            np.testing.assert_allclose(qa @ qa.T, qb @ qb.T, rtol=0, atol=PROJECTOR_ATOL)


def _check_row(name, ref_graph, monkeypatch, embedding_size, **kwargs):
    got_values, got, want_values, want = _fit_both(
        name, ref_graph, monkeypatch, embedding_size=embedding_size, **kwargs)
    np.testing.assert_allclose(np.sort(got_values), np.sort(want_values), rtol=VALUE_RTOL,
                               atol=VALUE_RTOL * float(np.abs(want_values).max()))
    values = _sorted_values(name, want_values, embedding_size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        _assert_same_columns(g, w, values)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_matches_reference_on_karate(name, monkeypatch):
    _check_row(name, ref_karate_club(), monkeypatch, embedding_size=6)


@pytest.mark.parametrize("metric", [m for m in ref_spectral.HOPE_METRICS
                                    if m not in ref_spectral.DAG_METRICS])
def test_hope_matches_reference_at_each_metric_on_karate(metric, monkeypatch):
    _check_row("HOPE", ref_karate_club(), monkeypatch, embedding_size=4, metric=metric)


@pytest.mark.parametrize("metric", ref_spectral.DAG_METRICS)
def test_hope_matches_reference_at_each_dag_metric(metric, monkeypatch):
    _check_row("HOPE", _random_dag(60, seed=5), monkeypatch, embedding_size=4, metric=metric)


@pytest.mark.parametrize("metric", ref_spectral.DAG_METRICS)
def test_hope_on_the_toy_dag_with_its_root(metric):
    """tests/test_parity_breadth.py's end-to-end check, on the port."""
    result = spectral.HOPE(embedding_size=3, metric=metric, root_node_name="t0",
                           device="cpu").fit_transform(_port_graph(_toy_dag()))
    assert [e.shape for e in result.node_embeddings] == [(7, 3), (7, 3)]
    assert all(np.isfinite(e).all() for e in result.node_embeddings)


def test_unknown_root_raises():
    with pytest.raises(ValueError, match="Root node"):
        spectral.HOPE(embedding_size=3, metric="Resnik", root_node_name="nope",
                      device="cpu").fit_transform(_port_graph(_toy_dag()))


def test_rows_pad_to_the_embedding_size():
    """Laplacian Eigenmaps and SocioDim pad with zero columns where the
    graph has fewer vectors to give, as the reference's do."""
    ref = _random_dag(12, seed=1)
    for name in ("Laplacian Eigenmaps", "SocioDim"):
        got = MODELS_LIBRARY["Node Embedding"][name]["Torch"](
            embedding_size=16, device="cpu").fit_transform(_port_graph(ref)).node_embeddings[0]
        want = ROWS[name](embedding_size=16).fit_transform(ref).node_embeddings[0]
        assert got.shape == want.shape == (12, 16), name
        zero_columns = [int((~e.any(axis=0)).sum()) for e in (got, want)]
        assert zero_columns[0] == zero_columns[1] > 0, (name, zero_columns)
        assert not got[:, -zero_columns[0]:].any(), name


@pytest.mark.parametrize("name", sorted(ROWS))
def test_parameters_and_names_match_reference(name):
    port = MODELS_LIBRARY["Node Embedding"][name]["Torch"]
    assert port.model_name() == ROWS[name].model_name() == name
    assert not port.is_stochastic()
    assert port(device="cpu").parameters() == ROWS[name]().parameters()
