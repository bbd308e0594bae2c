"""The port's node-label and edge-label tasks on the CPU, held to
embiggen_tpu on the same numpy inputs: the label splits mask for mask
(stratified and not, k-fold, multilabel, unknown labels, directed), the
multiclass and multilabel panel against the reference's sklearn numbers
within 1e-12 with nan exactly where the reference gives nan (absent
classes, rows that do not sum to 1, one-class columns, non-finite
probabilities), the classifier's dispatch between the panels, and the two
evaluation facades, whose rows carry the reference's columns and splits."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import holdouts as ref_holdouts
from embiggen_tpu.ops.metrics import multiclass_metrics as ref_multiclass_metrics
from embiggen_tpu_torch.graph import Graph, erdos_renyi, holdouts
from embiggen_tpu_torch.ops.metrics import multiclass_metrics

torch.set_num_threads(1)


def _relabel(port, ref, rng, multilabel=False, unknown=0.0, unknown_edges=0.0):
    """Both graphs with the same node types (several a node when
    `multilabel`, none for a share `unknown` of the nodes) and a share
    `unknown_edges` of the edge types -1."""
    n = port.number_of_nodes
    counts = rng.integers(1, 4 if multilabel else 2, n)
    counts[rng.random(n) < unknown] = 0
    ids = np.concatenate([rng.choice(5, c, replace=False) for c in counts]).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    kw = dict(node_type_ptr=ptr, node_type_ids=ids)
    if port.edge_types is not None and unknown_edges:
        # Both arcs of an edge lose their type together.
        lo = np.minimum(port.sources, port.col_idx).astype(np.int64)
        hi = np.maximum(port.sources, port.col_idx).astype(np.int64)
        edge = np.unique(lo * n + hi, return_inverse=True)[1]
        types = port.edge_types.copy()
        types[(rng.random(edge.max() + 1) < unknown_edges)[edge]] = -1
        kw["edge_types"] = types
    return dataclasses.replace(port, **kw), dataclasses.replace(ref, **kw)


def _graphs(kind):
    rng = np.random.default_rng(11)
    kw = dict(n_nodes=200, n_edges=800, seed=7, weighted=True, n_edge_types=3, n_node_types=4)
    port, ref = erdos_renyi(**kw), ref_erdos_renyi(**kw)
    if kind == "typed":
        return port, ref
    if kind == "multilabel":
        return _relabel(port, ref, rng, multilabel=True, unknown=0.1)
    if kind == "unknown":
        return _relabel(port, ref, rng, unknown=0.2, unknown_edges=0.3)
    src, dst = rng.integers(0, 120, 700), rng.integers(0, 120, 700)
    types = rng.integers(-1, 4, 700).astype(np.int32)
    port = Graph.from_edge_arrays(src, dst, n_nodes=120, directed=True, edge_types=types)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=120, directed=True, edge_types=types)
    return _relabel(port, ref, rng, unknown=0.1)


GRAPH_KINDS = ("typed", "multilabel", "unknown", "directed")
SPLITS = [
    ("node_label_holdout", dict(train_size=0.8, random_state=3)),
    ("node_label_holdout", dict(train_size=0.7, random_state=5, use_stratification=False)),
    ("node_label_kfold", dict(k=5, holdout_number=2, random_state=4)),
    ("node_label_kfold", dict(k=3, holdout_number=4, random_state=1, use_stratification=False)),
    ("edge_label_holdout", dict(train_size=0.8, random_state=3)),
    ("edge_label_holdout", dict(train_size=0.6, random_state=9, use_stratification=False)),
    ("edge_label_kfold", dict(k=4, holdout_number=1, random_state=2)),
    ("edge_label_kfold", dict(k=10, holdout_number=13, random_state=8)),
]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
@pytest.mark.parametrize("name, kwargs", SPLITS)
def test_label_splits_equal_reference(kind, name, kwargs):
    port, ref = _graphs(kind)
    got = getattr(holdouts, name)(port, **kwargs)
    want = getattr(ref_holdouts, name)(ref, **kwargs)
    for g, w in zip(got, want):
        assert g.name == w.name
        np.testing.assert_array_equal(g.row_ptr, w.row_ptr)
        np.testing.assert_array_equal(g.col_idx, w.col_idx)
        if name.startswith("node"):
            np.testing.assert_array_equal(g.node_type_ptr, w.node_type_ptr)
            np.testing.assert_array_equal(g.node_type_ids, w.node_type_ids)
            np.testing.assert_array_equal(g.edge_types, w.edge_types)
        else:
            assert g.edge_types.dtype == w.edge_types.dtype
            np.testing.assert_array_equal(g.edge_types, w.edge_types)
            np.testing.assert_array_equal(g.node_type_ptr, w.node_type_ptr)
    # Every labelled node (typed arc) is in one side, whose labels are the
    # graph's own.
    if name.startswith("node"):
        known = [g.get_known_node_types_mask() for g in got]
        assert not (known[0] & known[1]).any()
    else:
        known = [g.get_known_edge_types_mask() for g in got]
        assert not (known[0] & known[1]).any()
        both = known[0] | known[1]
        np.testing.assert_array_equal(both, port.get_known_edge_types_mask())


def test_graph_label_accessors_equal_reference():
    port, ref = _graphs("unknown")
    np.testing.assert_array_equal(port.get_known_edge_types_mask(),
                                  ref.get_known_edge_types_mask())
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 200, 500), rng.integers(0, 200, 500)
    np.testing.assert_array_equal(port.get_edge_ids(src, dst), ref.get_edge_ids(src, dst))
    untyped = erdos_renyi(50, 100, seed=1)
    assert not untyped.get_known_edge_types_mask().any()
    with pytest.raises(ValueError, match="no edge types"):
        holdouts.edge_label_holdout(untyped)


# --------------------------------------------------------------------- panel
def _softmax(logits):
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


def _panel_case(case):
    """(labels, probabilities, multilabel) of panel case `case`."""
    rng = np.random.default_rng(case)
    n, c = int(rng.integers(2, 80)), int(rng.integers(1, 7))
    logits = rng.normal(size=(n, c)) * rng.choice([0.1, 1.0, 5.0])
    if case % 4 == 0:
        logits = np.round(logits)             # ties in the scores
    dtype = np.float64 if case % 3 == 0 else np.float32
    if case % 2:
        # Multilabel: one-hot rows, some columns of one class.
        labels = (rng.random((n, c)) < rng.random()).astype(np.float32)
        proba = (1 / (1 + np.exp(-logits))).astype(dtype)
        if case % 5 == 1:
            proba[rng.integers(n), rng.integers(c)] = np.nan
        return labels, proba, True
    labels = rng.integers(0, int(rng.integers(1, c + 1)), n)
    if case % 10 == 2 and c >= 4:
        labels = rng.choice([0, 2, 3], n)     # a class absent from the labels
    proba = _softmax(logits).astype(dtype)
    if case % 6 == 4:
        # Rows that do not sum to 1: within np.allclose's tolerance or not.
        proba = proba * rng.choice([1.0 + 1e-6, 1.0 + 1e-4, 0.9])
    if case % 14 == 6:
        proba[0, 0] = np.inf
    return labels, proba, False


EXPLICIT = {
    # three classes, rows off by 1e-3: no AUROC
    "unnormalised rows": (np.array([0, 1, 2, 0, 1, 2]),
                          np.full((6, 3), 1 / 3 * 1.001), False),
    "absent class": (np.array([0, 0, 1, 1, 0, 1]), _softmax(np.eye(6)[:, :3]), False),
    "two classes, two columns": (np.array([0, 1, 1, 0, 1]), _softmax(np.eye(5)[:, :2]), False),
    "one class, one column": (np.zeros(4, np.int64), np.ones((4, 1)), False),
    "one-class column": (np.array([[1, 0], [1, 1], [1, 0]], np.float32),
                         np.array([[0.9, 0.2], [0.6, 0.7], [0.8, 0.4]]), True),
    "one column multilabel": (np.array([[1], [0], [1], [0]], np.float32),
                              np.array([[0.7], [0.6], [0.2], [0.1]]), True),
    "classes only predicted": (np.array([0, 0, 1, 1]), _softmax(np.eye(4) * 5), False),
}


def _assert_panels_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), (k, got[k])
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("case", list(range(120)) + list(EXPLICIT))
def test_multiclass_panel_equals_reference(case):
    labels, proba, multilabel = EXPLICIT[case] if case in EXPLICIT else _panel_case(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_multiclass_metrics(labels, proba, multilabel=multilabel)
    _assert_panels_equal(multiclass_metrics(labels, proba, multilabel=multilabel), want)


def test_panel_cases_cover_both_auroc_outcomes():
    """The cases above reach the AUROC and each of its nan cases."""
    outcomes = set()
    for case in list(range(120)) + list(EXPLICIT):
        labels, proba, multilabel = EXPLICIT[case] if case in EXPLICIT else _panel_case(case)
        outcomes.add((multilabel, bool(np.isnan(
            multiclass_metrics(labels, proba, multilabel)["auroc_macro_ovr"]))))
    assert outcomes == {(False, False), (False, True), (True, False), (True, True)}
    got = multiclass_metrics(*EXPLICIT["unnormalised rows"])
    assert np.isnan(got["auroc_macro_ovr"]) and got["accuracy"] == 1 / 3


# ------------------------------------------------------- dispatch and facades
def test_classifier_dispatches_between_the_panels():
    from embiggen_tpu_torch.models.gcn import KipfGCNNodeLabelPrediction

    model = KipfGCNNodeLabelPrediction(device="cpu")
    labels, proba, _ = _panel_case(2)
    model._multilabel, model._n_classes = False, proba.shape[1]
    if proba.shape[1] == 2:
        model._n_classes = 3
    assert "balanced_accuracy" in model.evaluate_prediction_probabilities(labels, proba)
    model._n_classes = 2
    binary = model.evaluate_prediction_probabilities(np.array([0, 1, 1]),
                                                     np.array([[0.8, 0.2], [0.3, 0.7],
                                                               [0.6, 0.4]]))
    assert binary["auprc"] == 1.0 and "matthews_correlation_coefficient" in binary
    model._multilabel = True
    labels, proba, _ = _panel_case(1)
    assert "hamming_loss" in model.evaluate_prediction_probabilities(labels, proba)


def test_label_models_refuse_untyped_graphs():
    from embiggen_tpu_torch.models.gcn import KipfGCNEdgeLabelPrediction, KipfGCNNodeLabelPrediction

    g = erdos_renyi(40, 100, seed=0)
    with pytest.raises(ValueError, match="requires node types"):
        KipfGCNNodeLabelPrediction(device="cpu", epochs=1).fit(g)
    with pytest.raises(ValueError, match="requires edge types"):
        KipfGCNEdgeLabelPrediction(device="cpu", epochs=1).fit(g)


def _typed_karate(port=True):
    """Karate with an edge type per arc: whether its ends' clubs differ."""
    from embiggen_tpu.graph import karate_club as ref_karate_club
    from embiggen_tpu_torch.graph import karate_club

    g = karate_club() if port else ref_karate_club()
    labels = g.get_single_label_node_type_ids()
    return dataclasses.replace(
        g, edge_types=(labels[g.sources] != labels[g.col_idx]).astype(np.int32))


FACADES = [
    ("node_label_prediction_evaluation", "GNN", "Stratified Monte Carlo", "multilabel"),
    ("node_label_prediction_evaluation", "Kipf GCN", "Stratified Kfold", "typed"),
    ("node_label_prediction_evaluation", "GraphSAGE", "Monte Carlo", "karate"),
    ("edge_label_prediction_evaluation", "Kipf GCN", "Stratified Monte Carlo", "typed"),
    ("edge_label_prediction_evaluation", "GNN", "Kfold", "karate"),
]


@pytest.mark.parametrize("facade, model, schema, kind", FACADES)
def test_facades_return_the_reference_rows(facade, model, schema, kind):
    """Rows of the two facades on the CPU: one per split with labels, the
    reference's columns and counts of labelled nodes or typed arcs, every
    metric nan where the reference's is (a split without positives) and
    only there."""
    import embiggen_tpu.pipelines as ref_pipelines
    import embiggen_tpu_torch.pipelines as pipelines

    if kind == "karate":
        port, ref = _typed_karate(), _typed_karate(port=False)
    else:
        port, ref = _graphs(kind)
    kw = dict(holdouts_number=2, models=model, evaluation_schema=schema, smoke_test=True,
              random_state=5)
    rows = getattr(pipelines, facade)(graphs=port, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(ref_pipelines, facade)(graphs=ref, **kw)
    assert isinstance(rows, list) and len(rows) == len(want) == 4
    assert set(rows[0]) == set(want.columns)
    count = "number_of_nodes" if facade.startswith("node") else "number_of_edges"
    assert [r[count] for r in rows] == want[count].tolist()
    assert [r["evaluation_mode"] for r in rows] == want["evaluation_mode"].tolist()
    for r, (_, w) in zip(rows, want.iterrows()):
        for key, value in r.items():
            if isinstance(value, float):
                assert np.isnan(value) == np.isnan(w[key]), key
