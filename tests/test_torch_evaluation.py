"""The port's evaluation harness (slice S4) on the CPU.

Parity: a deterministic scorer (the cosine of fixed numpy features, as a
subclass of each package's AbstractEdgePredictionModel) through both
packages' `edge_prediction_evaluation`, 2 holdouts of each schema and two
unbalance rates: the splits and negatives are copied host code, so the rows
match in order, keys and every value (metrics within 1e-6; seconds are not
compared). Structure: the checks of tests/test_pipelines.py on the port's
models — row counts, deferred features refitted per holdout, the GCN in the
pipeline, the bipartite and clique candidate sets, subgraphs of interest
and the model-level `evaluate` — and the harness script at a tiny size."""
import math

import numpy as np
import pytest
import torch

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.edge_prediction.model import (
    AbstractEdgePredictionModel as RefAbstractEdgePredictionModel,
)
from embiggen_tpu.pipelines import edge_prediction_evaluation as ref_evaluation
from embiggen_tpu_torch.graph import (
    Graph, connected_holdout, edge_prediction_kfold, erdos_renyi, planted_partition_edges,
    random_geometric,
)
from embiggen_tpu_torch.graph.sampling import sample_negative_graph
from embiggen_tpu_torch.models.classifier import AbstractClassifierModel
from embiggen_tpu_torch.models.edge_prediction import (
    AbstractEdgePredictionModel, PerceptronEdgePrediction,
)
from embiggen_tpu_torch.models.embedders import SkipGram
from embiggen_tpu_torch.pipelines import (
    edge_label_prediction_evaluation, edge_prediction_evaluation,
    node_label_prediction_evaluation, rows_to_dataframe,
)
from embiggen_tpu_torch.pipelines.evaluation import _align_subgraph
from embiggen_tpu_torch.scripts import harness

torch.set_num_threads(1)
N = 120
FEATS = np.random.default_rng(0).normal(size=(N, 8))
SECONDS = {"split_time", "feature_time", "fit_time", "evaluation_time",
           "predict_positive_seconds", "negative_sampling_seconds",
           "predict_negative_seconds", "metrics_seconds"}


def _cosine(graph):
    a, b = FEATS[graph.sources], FEATS[graph.col_idx]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return (cos + 1.0) / 2.0


def _scorer(base):
    class CosineScorer(base):
        @classmethod
        def model_name(cls):
            return "Cosine scorer"

        @classmethod
        def library_name(cls):
            return "test"

        @classmethod
        def is_stochastic(cls):
            return False

        def _fit(self, graph, support, node_features, **kwargs):
            pass

        def _predict_proba(self, graph, support=None, **kwargs):
            return _cosine(graph)
    return CosineScorer


@pytest.mark.parametrize("schema", ["Connected Monte Carlo", "Monte Carlo", "Kfold"])
def test_rows_match_reference(schema):
    kw = dict(holdouts_number=2, evaluation_schema=schema, random_state=7,
              unbalance_rates=(1.0, 2.0), holdouts_kwargs={"k": 4})
    rows = edge_prediction_evaluation(
        models=_scorer(AbstractEdgePredictionModel)(device="cpu"),
        graphs=erdos_renyi(N, 500, seed=1), **kw)
    want = ref_evaluation(models=_scorer(RefAbstractEdgePredictionModel)(),
                          graphs=ref_erdos_renyi(N, 500, seed=1), **kw)
    want = want.to_dict("records")
    assert len(rows) == len(want) == 2 * 2 * 2
    for got, ref in zip(rows, want):
        assert got.keys() == ref.keys()
        for key in set(ref) - SECONDS:
            if isinstance(ref[key], float):
                assert math.isclose(got[key], ref[key], rel_tol=0, abs_tol=1e-6), key
            else:
                assert got[key] == ref[key], key


@pytest.fixture(scope="module")
def rgg():
    return random_geometric(300, radius=0.1, seed=1)


def test_edge_prediction_evaluation_perceptron(rgg):
    rows = edge_prediction_evaluation(
        holdouts_number=2,
        models=PerceptronEdgePrediction(
            edge_features=["Degree", "AdamicAdar", "JaccardCoefficient"],
            number_of_epochs=50, random_state=0, device="cpu"),
        graphs=rgg, evaluation_schema="Connected Monte Carlo", random_state=3)
    # rows = holdouts x {train, test} x unbalances x models
    assert len(rows) == 2 * 2 * 1 * 1
    assert {r["evaluation_mode"] for r in rows} == {"train", "test"}
    assert all(r["auroc"] > 0.5 for r in rows)
    assert {"auprc", "f1_score", "holdout_number", "fit_time"} <= set(rows[0])
    assert [r["holdout_number"] for r in rows] == [0, 0, 1, 1]
    frame = rows_to_dataframe(rows)
    assert list(frame.columns) == list(rows[0]) and len(frame) == 4


def test_gcn_in_pipeline_smoke(rgg):
    rows = edge_prediction_evaluation(
        holdouts_number=1, models="Kipf GCN", graphs=rgg, smoke_test=True,
        evaluation_schema="Monte Carlo", random_state=3, device="cpu")
    assert len(rows) == 2
    assert rows[0]["model_name"] == "Kipf GCN" and rows[0]["library_name"] == "Torch"


def test_deferred_embedding_feature_refit_per_holdout(rgg, monkeypatch):
    """Stochastic embedding features are fitted on each holdout's train
    graph, once per holdout however many models share it."""
    model = SkipGram.into_smoke_test(random_state=5, device="cpu")
    normalized = PerceptronEdgePrediction(device="cpu").normalize_node_features(
        rgg, [model], skip_evaluation_biased_feature=True)
    assert normalized[0] is model
    fitted = AbstractClassifierModel.fit_deferred_features(normalized, rgg)
    assert isinstance(fitted[0], np.ndarray) and fitted[0].shape == (300, 5)
    seen = []
    fit_transform = SkipGram.fit_transform

    def spy(self, graph, **kwargs):
        seen.append(graph.arcs_fingerprint)
        return fit_transform(self, graph, **kwargs)
    monkeypatch.setattr(SkipGram, "fit_transform", spy)
    perceptron = PerceptronEdgePrediction(edge_embeddings=["Hadamard"], edge_features=[],
                                          number_of_epochs=2, device="cpu")
    rows = edge_prediction_evaluation(
        holdouts_number=2, models=[perceptron, perceptron], graphs=rgg,
        node_features=model, evaluation_schema="Monte Carlo", random_state=3)
    assert len(rows) == 8 and len(seen) == 2 and seen[0] != seen[1]
    assert rows[0]["feature_time"] == rows[4]["feature_time"]
    assert seen[0] != rgg.arcs_fingerprint


def test_perceptron_bipartite_clique(rgg):
    model = PerceptronEdgePrediction(edge_features=["Degree", "AdamicAdar"],
                                     number_of_epochs=10, random_state=0, device="cpu")
    model.fit(rgg)
    src, dst = np.array([0, 1, 2]), np.array([30, 31, 32, 33])
    bi = model.predict_proba_bipartite_graph_from_edge_node_ids(src, dst)
    assert bi.shape == (3, 4) and ((bi >= 0) & (bi <= 1)).all()
    np.testing.assert_allclose(
        bi.ravel(), model.predict_proba_from_edge_node_ids(np.repeat(src, 4), np.tile(dst, 3)),
        rtol=1e-6)
    model.PREDICTION_CHUNK_SIZE = 5   # chunking is only a memory bound
    np.testing.assert_array_equal(
        model.predict_proba_bipartite_graph_from_edge_node_ids(src, dst), bi)
    cl = model.predict_proba_clique_graph_from_node_ids(np.arange(5))
    assert cl.shape == (5, 5)
    names = rgg.get_node_names()
    np.testing.assert_array_equal(
        model.predict_proba_bipartite_graph_from_edge_node_names(rgg, names[src], names[dst]), bi)
    np.testing.assert_array_equal(
        model.predict_proba_clique_graph_from_node_prefixes(rgg, ["node_1"]),
        model.predict_proba_clique_graph_from_node_ids(rgg.get_node_ids_from_prefixes("node_1")))
    np.testing.assert_array_equal(model.predict_clique_graph_from_node_ids(np.arange(5)),
                                  cl > 0.5)
    frame = model.predict_proba_bipartite_graph_from_edge_node_ids(
        src, dst, graph=rgg, return_predictions_dataframe=True)
    assert list(frame.index) == list(names[src]) and list(frame.columns) == list(names[dst])
    with pytest.raises(ValueError, match="graph"):
        model.predict_proba_clique_graph_from_node_ids(src, return_predictions_dataframe=True)
    # Candidate sets by node type: the random geometric graph's grid cells.
    cells = rgg.get_node_ids_from_node_type_names(["cell_0", "cell_3"])
    np.testing.assert_array_equal(
        model.predict_clique_graph_from_node_type_names(rgg, ["cell_0", "cell_3"]),
        model.predict_clique_graph_from_node_ids(cells))
    np.testing.assert_array_equal(
        model.predict_proba_bipartite_graph_from_edge_node_types(rgg, ["cell_1"], "cell_2"),
        model.predict_proba_bipartite_graph_from_edge_node_ids(
            rgg.get_node_ids_from_node_type_names("cell_1"),
            rgg.get_node_ids_from_node_type_names("cell_2")))
    with pytest.raises(ValueError, match="Unknown node type"):
        model.predict_clique_graph_from_node_type_names(rgg, ["a"])


@pytest.fixture(scope="module")
def er():
    g = erdos_renyi(200, 800, seed=7)
    group = np.arange(200) % 4
    a, b = group[g.sources], group[g.col_idx]
    mask = ((a == 0) & (b == 1)) | ((a == 1) & (b == 0))
    return g, g.filter_edges(mask, name="type0-type1")


def test_subgraph_of_interest_evaluation(er):
    g, sub = er
    assert 0 < sub.number_of_directed_edges < g.number_of_directed_edges
    rows = edge_prediction_evaluation(
        holdouts_number=2,
        models=PerceptronEdgePrediction(edge_features=["Degree", "AdamicAdar"],
                                        number_of_epochs=30, random_state=0, device="cpu"),
        graphs=g, evaluation_schema="Connected Monte Carlo", random_state=3,
        subgraph_of_interest=sub)
    assert len(rows) == 2 * 2
    for h in (0, 1):
        total = sum(r["size_of_positive_set"] for r in rows if r["holdout_number"] == h)
        assert 0 < total <= sub.number_of_directed_edges
    assert all(np.isfinite(r["auprc"]) for r in rows)
    # Negatives ride the subgraph's degrees and avoid the whole graph's edges.
    neg = sample_negative_graph(sub, number_of_negative_samples=64, random_state=7, support=g,
                                device="cpu")
    active = np.flatnonzero(sub.degrees > 0)
    assert np.isin(neg.sources, active).all() and np.isin(neg.col_idx, active).all()
    assert not g.has_edges(neg.sources, neg.col_idx).any()
    # A subgraph with its own node dictionary is aligned by names.
    keep = np.flatnonzero(np.isin(np.arange(200) % 4, (0, 1)))
    local = {v: i for i, v in enumerate(keep)}
    s_src = np.array([local[v] for v in sub.sources])
    s_dst = np.array([local[v] for v in sub.col_idx])
    remapped = Graph.from_edge_arrays(s_src, s_dst, n_nodes=len(keep), directed=True,
                                      directed_flag=False, name="sub",
                                      node_names=g.get_node_names()[keep])
    aligned = _align_subgraph(g, remapped)
    assert aligned.number_of_nodes == g.number_of_nodes and not aligned.directed
    np.testing.assert_array_equal(aligned.row_ptr, sub.row_ptr)
    np.testing.assert_array_equal(aligned.col_idx, sub.col_idx)
    assert _align_subgraph(g, sub) is sub


def test_subgraph_of_interest_empty_raises(er):
    g, _ = er
    empty = g.filter_edges(np.zeros(g.number_of_directed_edges, bool))
    with pytest.raises(ValueError, match="no edges left"):
        edge_prediction_evaluation(
            holdouts_number=1,
            models=PerceptronEdgePrediction(edge_features=["Degree"], number_of_epochs=5,
                                            random_state=0, device="cpu"),
            graphs=g, random_state=3, subgraph_of_interest=empty)


def test_subgraph_use_as_support_and_model_level_evaluate(er):
    g, sub = er
    model = PerceptronEdgePrediction(edge_features=["Degree"], number_of_epochs=20,
                                     random_state=0, device="cpu")
    rows = model.evaluate(g, evaluation_schema="Connected Monte Carlo", holdouts_number=1,
                          random_state=3, subgraph_of_interest=sub,
                          use_subgraph_as_support=True)
    assert len(rows) == 2
    assert all(r["size_of_positive_set"] <= sub.number_of_directed_edges for r in rows)
    assert all(np.isfinite(r["auprc"]) for r in rows)
    assert model.evaluate(g, holdouts_number=1)[0]["evaluation_schema"] == "Connected Monte Carlo"


def test_workers_kfold_and_what_still_raises(er, tmp_path):
    g, _ = er
    kw = dict(models=PerceptronEdgePrediction(edge_features=["Degree"], number_of_epochs=2,
                                              device="cpu"),
              graphs=g, evaluation_schema="Kfold", holdouts_kwargs={"k": 3})
    rows = edge_prediction_evaluation(3, number_of_workers=2, worker_id=1, **kw)
    assert [r["holdout_number"] for r in rows] == [1, 1]
    fold = edge_prediction_kfold(g, 3, 1, random_state=42)
    assert [r["size_of_positive_set"] for r in rows] == [
        fold[0].number_of_directed_edges, fold[1].number_of_directed_edges]
    # The experiment cache (ROADMAP A12, ported since) is off across workers.
    cache_dir = tmp_path / "cache"
    again = edge_prediction_evaluation(3, number_of_workers=2, worker_id=1, enable_cache=True,
                                       cache_dir=str(cache_dir), **kw)
    assert [r["auprc"] for r in again] == [r["auprc"] for r in rows]
    assert not cache_dir.exists()
    # The label facades are ported; the Perceptron has no label-task row.
    for facade in (node_label_prediction_evaluation, edge_label_prediction_evaluation):
        with pytest.raises(ValueError, match="'Perceptron' not found"):
            facade(1, "Perceptron", g)


def test_harness_script_on_the_cpu():
    er = erdos_renyi(1500, 6000, seed=0)
    out = harness.run("cpu", er_graph=er)
    keys = {"eval_total_s", "eval_negative_sampling_s", "eval_split_s", "eval_feature_s",
            "eval_fit_s", "eval_predict_metrics_s", "eval_predict_positive_s",
            "eval_predict_negative_s", "eval_neg_sampling_inner_s", "eval_metric_panels_s",
            "eval_fit_by_model", "eval_predict_by_model", "eval_test_auprc",
            "eval_test_auprc_by_model", "eval_split_sha1",
            "eval_graph", "device"}
    assert set(out) == keys and out["device"] == "cpu"
    eval_graph = planted_partition_edges(1500, er.number_of_directed_edges // 2, seed=0)
    assert out["eval_split_sha1"] == harness.split_sha1(
        *connected_holdout(eval_graph, train_size=0.8, random_state=0))
    assert set(out["eval_test_auprc_by_model"]) == {"Perceptron", "Kipf GCN"}
    assert out["eval_test_auprc"] == pytest.approx(
        np.mean(list(out["eval_test_auprc_by_model"].values())))
    assert 0.5 < out["eval_test_auprc"] <= 1.0
    assert out["eval_total_s"] >= out["eval_fit_s"] + out["eval_feature_s"]
    rows = [dict(holdout_number=h, model_name=m, split_time=1.0 + h, feature_time=2.0,
                 fit_time=3.0, evaluation_time=4.0, predict_positive_seconds=0.5,
                 predict_negative_seconds=0.25, negative_sampling_seconds=0.0,
                 metrics_seconds=0.0, evaluation_mode=mode, auprc=0.75)
            for h in (0, 1) for m in ("a", "b") for mode in ("train", "test")]
    got = harness.summarize(rows)
    assert (got["eval_split_s"], got["eval_feature_s"], got["eval_fit_s"]) == (3.0, 4.0, 12.0)
    assert got["eval_predict_by_model"] == {"a": 3.0, "b": 3.0}
    assert got["eval_fit_by_model"] == {"a": 6.0, "b": 6.0}
