"""Quality gates of the port's link-prediction slice on the CPU, on the
reference's gate fixture (`tests/test_quality_gates.py`):
`random_geometric(1000, radius=0.07, seed=42)`, one connected holdout with
random_state 3, scored by `_evaluate` as the evaluation pipeline does.

The Perceptron uses Degree + Hadamard over SkipGram embeddings (the
reference gate's Jaccard and Adamic-Adar features need kernel K8, not
ported yet); the GCN learns a node embedding with no static features (the
reference gate's Degree-based SPINE comes with ROADMAP A11).

One fit is one draw: over the model's seed, the reference GCN's test AUPRC
on this split ranges from 0.882 to 0.981 (seeds 0-7), so a single seed
cannot hold the port to 0.03. Both packages are held by their mean over
seeds 0-7 instead (the features are fitted once, as the evaluation
pipeline does per holdout): the port's mean must reach the reference's
less 0.03, and 0.80. The reference means were measured with embiggen_tpu on
the CPU, JAX_PLATFORMS=cpu, by this procedure with the reference's classes
(`embiggen_tpu.graph.random_geometric`, `embiggen_tpu.graph.holdouts.
connected_holdout`, `AbstractClassifierModel.fit_deferred_features`, the
same MODELS and SKIPGRAM settings without `device`, and
`model.set_random_state(seed)` before each fit). Per seed they were, for
the Perceptron, 0.96272 0.96246 0.96292 0.96285 0.96236 0.96260 0.96290
0.96266, and for the GCN, 0.91688 0.94601 0.97289 0.97510 0.98081 0.97668
0.95877 0.88230; seed 3 is the reference gate's own
(`edge_prediction_evaluation(..., random_state=3)` gives 0.96285 and
0.97510).
"""
import numpy as np
import pytest
import torch

from embiggen_tpu_torch.graph import connected_holdout, random_geometric
from embiggen_tpu_torch.models.classifier import AbstractClassifierModel
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models.embedders import SkipGram
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction

torch.set_num_threads(2)

REFERENCE_MEAN_TEST_AUPRC = {"perceptron": 0.9626831024263514, "gcn": 0.9511797508504303}
SEEDS = range(8)
MARGIN = 0.03
SKIPGRAM = dict(embedding_size=32, epochs=100, batch_size=256, walk_length=16,
                window_size=2, number_of_negative_samples=5,
                learning_rate_decay=0.99, random_state=0,
                early_stopping_patience=10**6, learning_rate_plateau_patience=10**6)
MODELS = {
    "perceptron": lambda: PerceptronEdgePrediction(
        edge_embeddings=["Hadamard"], edge_features=["Degree"],
        number_of_epochs=100, random_state=0, device="cpu"),
    "gcn": lambda: GCNEdgePrediction(
        units=[32], tower_units=[16], head_units=[16], epochs=50,
        use_node_embedding=True, node_embedding_size=32, dropout_rate=0.2,
        batch_size=1024, random_state=0, device="cpu"),
}


@pytest.fixture(scope="module")
def holdout():
    rgg = random_geometric(1000, radius=0.07, seed=42)
    train, test = connected_holdout(rgg, random_state=3)
    return rgg, train, test


def evaluate(name, seed, graph, train, test, node_features):
    model = MODELS[name]()
    model.set_random_state(seed)
    model.fit(train, support=train, node_features=node_features)
    rows = model._evaluate(graph, train, test, support=train, random_state=3)
    return {r["evaluation_mode"]: r for r in rows}


@pytest.mark.parametrize("name", ["perceptron", "gcn"])
def test_link_prediction_auprc(holdout, name):
    graph, train, test = holdout
    features = None
    if name == "perceptron":
        features = AbstractClassifierModel.fit_deferred_features(
            [SkipGram(device="cpu", **SKIPGRAM)], train)
        assert len(features) == 2 and features[0].shape == (1000, 32)
    auprc = []
    for seed in SEEDS:
        rows = evaluate(name, seed, graph, train, test, features)
        auprc.append(rows["test"]["auprc"])
        assert rows["test"]["size_of_positive_set"] == test.number_of_directed_edges
        # Both arcs of each of the test graph's edges, and of as many negatives.
        assert rows["test"]["size_of_negative_set"] == 2 * test.number_of_edges
        assert np.isfinite(rows["train"]["auroc"])
    floor = max(0.80, REFERENCE_MEAN_TEST_AUPRC[name] - MARGIN)
    assert np.mean(auprc) >= floor, auprc
