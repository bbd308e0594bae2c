"""The port's sklearn-like edge prediction adapters on the CPU, held to
embiggen_tpu's: every one of the 18 named rows fit on the same graph,
features and random_state in both packages gives `predict_proba` within
1e-12 of the reference's (the same training negatives, the same features
and metric columns, the same shuffle, so the same estimator), at the
defaults and with `use_edge_metrics`, another unbalance rate and uniform
negatives; `predict_proba_compat` on margins; `device` never reaching the
estimator; and "Decision Tree Classifier" through
`edge_prediction_evaluation` on karate with the reference's rows."""
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import karate_club as ref_karate_club
from embiggen_tpu.models.edge_prediction import sklearn_like as ref_sklearn_like
from embiggen_tpu.utils.sklearn_compat import predict_proba_compat as ref_compat
from embiggen_tpu_torch.graph import erdos_renyi, karate_club
from embiggen_tpu_torch.models.edge_prediction import sklearn_like
from embiggen_tpu_torch.utils.sklearn_compat import predict_proba_compat

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_thread_a_pool():
    """The estimators' BLAS and OpenMP pools on one thread: the suite runs
    several test processes at once, and pools of a thread a core in each
    contend (their OpenMP threads spin while they wait)."""
    with threadpool_limits(limits=1):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
ROWS = list(sklearn_like.SKLEARN_EDGE_PREDICTION_MODELS)
DECISION_ONLY = ("Linear Support Vector Classifier", "Ridge Classifier",
                 "Ridge Classifier Cross Validator")


def _graphs():
    kw = dict(n_nodes=70, n_edges=260, seed=2)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


def _features(n=70, d=6):
    return np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)


def _pair(name, **kw):
    port = sklearn_like._WRAPPERS[name](device="cpu", **kw)
    ref = ref_sklearn_like._WRAPPERS[name](**kw)
    return port, ref


def _assert_fits_agree(port, ref, g, rg, x):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port.fit(g, node_features=x)
        ref.fit(rg, node_features=x)
        got, want = port.predict_proba(g), ref.predict_proba(rg)
        rng = np.random.default_rng(9)
        src, dst = rng.integers(0, g.number_of_nodes, (2, 500))
        pairs = (port.predict_proba_from_edge_node_ids(src, dst),
                 ref.predict_proba_from_edge_node_ids(src, dst))
    assert got.shape == want.shape == (g.number_of_directed_edges,)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(*pairs, **TOL)
    assert port.parameters() == ref.parameters()


def test_rows_equal_the_reference_rows():
    assert list(sklearn_like.SKLEARN_EDGE_PREDICTION_MODELS) == list(
        ref_sklearn_like.SKLEARN_EDGE_PREDICTION_MODELS)
    assert len(ROWS) == 18
    for name in ROWS:
        port, ref = sklearn_like._WRAPPERS[name], ref_sklearn_like._WRAPPERS[name]
        assert port.__name__ == ref.__name__ and port.model_name() == name
        assert port.library_name() == ref.library_name() == "scikit-learn"
        assert getattr(sklearn_like, port.__name__) is port


@pytest.mark.parametrize("name", ROWS)
def test_named_row_predicts_as_the_reference(name):
    g, rg = _graphs()
    port, ref = _pair(name, random_state=3)
    _assert_fits_agree(port, ref, g, rg, _features())
    if name in DECISION_ONLY:
        assert not hasattr(port._model_instance, "predict_proba")


@pytest.mark.parametrize("name, kw", [
    ("Decision Tree Classifier", dict(use_edge_metrics=True, edge_embedding_methods="Hadamard")),
    ("Ridge Classifier", dict(use_edge_metrics=True, edge_embedding_methods=["Hadamard", "L1"])),
    ("Logistic Regression Classifier", dict(use_edge_metrics=True)),
    ("Random Forest Classifier", dict(training_unbalance_rate=2.0,
                                      use_scale_free_distribution=False)),
    ("Linear Support Vector Classifier", dict(use_edge_metrics=True,
                                              edge_embedding_methods="CosineSimilarity",
                                              prediction_batch_size=64)),
    ("K-Neighbour Classifier", dict(n_neighbors=3, edge_embedding_methods="Average")),
])
def test_options_predict_as_the_reference(name, kw):
    g, rg = _graphs()
    port, ref = _pair(name, random_state=4, **kw)
    _assert_fits_agree(port, ref, g, rg, _features())
    if kw.get("use_edge_metrics"):
        # The edge features' width, then the four metric columns.
        width = port._transformer.transform(g, g, shuffle=False)[0].shape[1]
        assert port._model_instance.n_features_in_ == width + 4


def test_a_model_instance_of_numpy_fits_and_device_stays_out():
    """An estimator passed as model_instance: the same one fitted in both
    packages; `device` is the port's own parameter and the sklearn
    estimator's kwargs come from model_kwargs alone."""
    from sklearn.linear_model import LogisticRegression

    g, rg = _graphs()
    kw = dict(edge_embedding_methods="Hadamard", use_edge_metrics=True, random_state=0)
    port = sklearn_like.SklearnEdgePredictionAdapter(
        model_instance=LogisticRegression(max_iter=200), device="cpu", **kw)
    ref = ref_sklearn_like.SklearnEdgePredictionAdapter(
        model_instance=LogisticRegression(max_iter=200), **kw)
    _assert_fits_agree(port, ref, g, rg, _features())
    assert "device" not in port.parameters()
    named = sklearn_like._WRAPPERS["Ridge Classifier"](device="cpu", alpha=2.0)
    assert named._model_instance.alpha == 2.0 and named.device == torch.device("cpu")
    assert named.clone()._model_instance.alpha == 2.0
    with pytest.raises(ValueError, match="requires a model_instance"):
        sklearn_like.SklearnEdgePredictionAdapter(device="cpu")


def test_predict_proba_compat_equals_reference():
    class Margin:
        def __init__(self, margin):
            self.margin = margin

        def decision_function(self, x):
            return self.margin

    rng = np.random.default_rng(0)
    for margin in (rng.standard_normal(20), rng.standard_normal((20, 4)) * 30):
        np.testing.assert_array_equal(predict_proba_compat(Margin(margin), None),
                                      ref_compat(Margin(margin), None))
    for compat in (predict_proba_compat, ref_compat):
        with pytest.raises(AttributeError, match="neither predict_proba"):
            compat(object(), np.zeros((2, 2)))


def test_decision_tree_evaluation_on_karate_equals_reference():
    """`edge_prediction_evaluation` of "Decision Tree Classifier" over the
    same node features: the reference's rows (the split, the negatives,
    the fit and the panel), every metric within 1e-12."""
    import embiggen_tpu.pipelines as ref_pipelines
    import embiggen_tpu_torch.pipelines as pipelines

    x = _features(34, 8)
    kw = dict(holdouts_number=1, models="Decision Tree Classifier", node_features=x,
              evaluation_schema="Monte Carlo", random_state=3)
    rows = pipelines.edge_prediction_evaluation(graphs=karate_club(), device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_pipelines.edge_prediction_evaluation(graphs=ref_karate_club(), **kw)
    assert len(rows) == len(want) == 2
    assert set(rows[0]) == set(want.columns)
    assert rows[0]["library_name"] == "scikit-learn"
    for r, (_, w) in zip(rows, want.iterrows()):
        for key, value in r.items():
            if "time" in key or "seconds" in key:
                continue
            if isinstance(value, float):
                np.testing.assert_allclose(value, w[key], **TOL, err_msg=key)
            elif isinstance(value, (str, int)) and key not in ("hostname", "platform"):
                assert value == w[key], key
