"""The port's sklearn-like node-label and edge-label adapters on the CPU,
held to embiggen_tpu's: every one of the 18 node-label and 17 edge-label
named rows fit on the same graph, features and random_state in both
packages gives `predict_proba` within 1e-12 of the reference's (classes
mapped back onto the full class space, including a class no training row
has), on a multilabel node-label graph (the estimator wrapped in
`MultiOutputClassifier`), a 2-class node-label and edge-label graph, and with
`use_edge_metrics`; and both facades with a named row, whose rows equal the
reference's."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.edge_label_prediction import sklearn_like as ref_edge_label
from embiggen_tpu.models.node_label_prediction import sklearn_like as ref_node_label
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models.edge_label_prediction import sklearn_like as edge_label
from embiggen_tpu_torch.models.node_label_prediction import sklearn_like as node_label

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_thread_a_pool():
    """The estimators' BLAS and OpenMP pools on one thread: the suite runs
    several test processes at once, and pools of a thread a core in each
    contend (their OpenMP threads spin while they wait)."""
    with threadpool_limits(limits=1):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
N = 90
NODE_ROWS = list(node_label.SKLEARN_NODE_LABEL_MODELS)
EDGE_ROWS = list(edge_label.SKLEARN_EDGE_LABEL_MODELS)
# Rows whose estimators have predict_proba, so MultiOutputClassifier serves
# them on a multilabel graph.
MULTILABEL_ROWS = ("Random Forest Classifier", "Decision Tree Classifier",
                   "Logistic Regression Classifier", "K-Neighbour Classifier",
                   "MLP Regression", "Gaussian Naive Bayes")


def _graphs(kind="typed"):
    kw = dict(n_nodes=N, n_edges=360, seed=6, n_edge_types=3, n_node_types=4)
    port, ref = erdos_renyi(**kw), ref_erdos_renyi(**kw)
    rng = np.random.default_rng(2)
    if kind == "typed":
        # No node has type 2 of the 4: the estimator's classes_ skip it.
        ids = port.node_type_ids.copy()
        ids[ids == 2] = 0
        counts = np.ones(N, np.int64)
        counts[rng.random(N) < 0.1] = 0
        ids = np.where(counts == 1, ids, -1)
        kw = dict(node_type_ptr=np.concatenate([[0], np.cumsum(counts)]),
                  node_type_ids=ids[ids >= 0].astype(np.int32))
    elif kind == "multilabel":
        counts = rng.integers(0, 3, N)
        kw = dict(node_type_ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                  node_type_ids=np.concatenate([rng.choice(4, c, replace=False)
                                                for c in counts]).astype(np.int32))
    elif kind == "binary":
        kw = dict(node_type_ids=(port.node_type_ids % 2).astype(np.int32),
                  edge_types=(port.edge_types % 2).astype(np.int32))
    return dataclasses.replace(port, **kw), dataclasses.replace(ref, **kw)


def _features(d=5):
    return np.random.default_rng(3).standard_normal((N, d)).astype(np.float32)


def _fit_both(port, ref, g, rg):
    x = _features()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port.fit(g, node_features=x)
        ref.fit(rg, node_features=x)
        got, want = port.predict_proba(g), ref.predict_proba(rg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    assert port.parameters() == ref.parameters()
    for method in ("is_binary_prediction_task", "is_multilabel_prediction_task"):
        assert getattr(port, method)() == getattr(ref, method)(), method
    return got


def test_rows_equal_the_reference_rows():
    for port, ref, n in ((node_label, ref_node_label, 18), (edge_label, ref_edge_label, 17)):
        assert len(port._WRAPPERS) == n and list(port._WRAPPERS) == list(ref._WRAPPERS)
        for name, cls in port._WRAPPERS.items():
            assert cls.__name__ == ref._WRAPPERS[name].__name__ and cls.model_name() == name
            assert cls.library_name() == "scikit-learn"
            assert getattr(port, cls.__name__) is cls


@pytest.mark.parametrize("name", NODE_ROWS)
def test_node_label_row_predicts_as_the_reference(name):
    g, rg = _graphs()
    got = _fit_both(node_label._WRAPPERS[name](device="cpu", random_state=3),
                    ref_node_label._WRAPPERS[name](random_state=3), g, rg)
    assert got.shape == (N, 4) and (got[:, 2] == 0).all()


@pytest.mark.parametrize("name", MULTILABEL_ROWS)
def test_node_label_row_on_a_multilabel_graph(name):
    g, rg = _graphs("multilabel")
    assert g.has_multilabel_node_types()
    port = node_label._WRAPPERS[name](device="cpu", random_state=4)
    _fit_both(port, ref_node_label._WRAPPERS[name](random_state=4), g, rg)
    assert port.is_multilabel_prediction_task()
    assert type(port._model_instance).__name__ == "MultiOutputClassifier"


@pytest.mark.parametrize("name", EDGE_ROWS)
def test_edge_label_row_predicts_as_the_reference(name):
    g, rg = _graphs()
    got = _fit_both(edge_label._WRAPPERS[name](device="cpu", random_state=3),
                    ref_edge_label._WRAPPERS[name](random_state=3), g, rg)
    assert got.shape == (g.number_of_directed_edges, 3)


@pytest.mark.parametrize("name, kw", [
    ("Decision Tree Classifier", dict(use_edge_metrics=True, edge_embedding_methods="Hadamard")),
    ("Ridge Classifier", dict(use_edge_metrics=True)),
    ("Linear Support Vector Classifier", dict(edge_embedding_methods=["L2", "CosineSimilarity"])),
    ("Logistic Regression Classifier", dict(use_edge_metrics=True, C=0.5)),
])
def test_edge_label_options_predict_as_the_reference(name, kw):
    g, rg = _graphs()
    port = edge_label._WRAPPERS[name](device="cpu", random_state=5, **kw)
    _fit_both(port, ref_edge_label._WRAPPERS[name](random_state=5, **kw), g, rg)
    if kw.get("use_edge_metrics"):
        # The edge features' width, then the four metric columns.
        width = port._transformer.transform(g)[0].shape[1]
        assert port._model_instance.n_features_in_ == width + 4


@pytest.mark.parametrize("task", ["node", "edge"])
@pytest.mark.parametrize("name", ["Ridge Classifier", "Random Forest Classifier",
                                  "Linear Support Vector Classifier"])
def test_two_class_graphs_predict_as_the_reference(task, name):
    g, rg = _graphs("binary")
    module, ref_module = (node_label, ref_node_label) if task == "node" else (
        edge_label, ref_edge_label)
    port = module._WRAPPERS[name](device="cpu", random_state=6)
    _fit_both(port, ref_module._WRAPPERS[name](random_state=6), g, rg)
    assert port.is_binary_prediction_task()


def test_model_instance_and_device_stay_apart():
    from sklearn.linear_model import LogisticRegression

    g, rg = _graphs()
    _fit_both(node_label.SklearnNodeLabelPredictionAdapter(
        model_instance=LogisticRegression(max_iter=300), device="cpu"),
        ref_node_label.SklearnNodeLabelPredictionAdapter(
            model_instance=LogisticRegression(max_iter=300)), g, rg)
    port = edge_label._WRAPPERS["Ridge Classifier"](device="cpu", alpha=3.0)
    assert port._model_instance.alpha == 3.0 and "device" not in port.parameters()
    for cls in (node_label.SklearnNodeLabelPredictionAdapter,
                edge_label.SklearnEdgeLabelPredictionAdapter):
        with pytest.raises(ValueError, match="requires a model_instance"):
            cls(device="cpu")


@pytest.mark.parametrize("facade, model", [
    ("node_label_prediction_evaluation", "Random Forest Classifier"),
    ("edge_label_prediction_evaluation", "Decision Tree Classifier"),
])
def test_facades_with_a_named_row_equal_the_reference(facade, model):
    import embiggen_tpu.pipelines as ref_pipelines
    import embiggen_tpu_torch.pipelines as pipelines

    g, rg = _graphs()
    kw = dict(holdouts_number=2, models=model, node_features=[_features(6)],
              evaluation_schema="Stratified Monte Carlo", random_state=3)
    rows = getattr(pipelines, facade)(graphs=g, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(ref_pipelines, facade)(graphs=rg, **kw)
    assert len(rows) == len(want) == 4 and set(rows[0]) == set(want.columns)
    for r, (_, w) in zip(rows, want.iterrows()):
        assert r["library_name"] == "scikit-learn"
        for key, value in r.items():
            if "time" in key or "seconds" in key:
                continue
            if isinstance(value, float):
                np.testing.assert_allclose(value, w[key], **TOL, err_msg=key)
            elif isinstance(value, (str, int)) and key not in ("hostname", "platform"):
                assert value == w[key], key
