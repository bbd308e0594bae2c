"""Quality gates of the port's link prediction on the CPU, on the reference's
gate fixture (`tests/test_quality_gates.py`):
`random_geometric(1000, radius=0.07, seed=42)`, one connected holdout with
random_state 3.

The Perceptron runs the reference's own gate verbatim
(`tests/test_quality_gates.py:39-67`): SkipGram features, a Perceptron on
Jaccard, Adamic-Adar and Hadamard, through the port's
`edge_prediction_evaluation(..., evaluation_schema="Connected Monte Carlo",
random_state=3)`. It is held to the reference's thresholds (test AUPRC and
AUROC at least 0.90) and to the reference's test AUPRC for the same call
less 0.03. That call gave test AUPRC 0.9913790290856157 and AUROC
0.991004758345661, measured with embiggen_tpu on the CPU
(JAX_PLATFORMS=cpu, the reference's test body with its DataFrame printed).

The GCN learns a node embedding with no static features (the reference
gate's Degree-based SPINE comes with ROADMAP A11). One fit is one draw:
over the model's seed, the reference GCN's test AUPRC on this split ranges
from 0.882 to 0.981 (seeds 0-7), so a single seed cannot hold the port to
0.03. It is held by its mean over seeds 0-7 instead, which must reach the
reference's mean less 0.03, and 0.80. The reference mean was measured with
embiggen_tpu on the CPU, JAX_PLATFORMS=cpu, by this procedure with the
reference's classes (`embiggen_tpu.graph.random_geometric`,
`embiggen_tpu.graph.holdouts.connected_holdout`, the same GCN settings
without `device`, `model.set_random_state(seed)` before each fit, and
`_evaluate(graph, train, test, support=train, random_state=3)`). Per seed
the reference gave 0.91688 0.94601 0.97289 0.97510 0.98081 0.97668 0.95877
0.88230; seed 3 is the reference gate's own.

Node2Vec CBOW over p/q walks (return 2, explore 0.5; the SkipGram gate's
other settings) feeds a Perceptron on Hadamard alone, on the same split,
with embedding seeds 0-3: the mean test AUPRC must reach the reference's
less 0.03. The reference mean was measured with embiggen_tpu on the CPU,
JAX_PLATFORMS=cpu, by this procedure with the reference's classes (CBOW and
PerceptronEdgePrediction without `device`, the embedding's table 0 as the
node features, `_evaluate(graph, train, test, random_state=3)`); per seed it
gave 0.98682 0.98854 0.98902 0.98883. `test_cbow_pq_reference_mean` runs
that measurement again.
"""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import random_geometric as ref_random_geometric
from embiggen_tpu.graph.holdouts import connected_holdout as ref_connected_holdout
from embiggen_tpu.models.edge_prediction import PerceptronEdgePrediction as RefPerceptron
from embiggen_tpu.models.embedders import CBOW as RefCBOW
from embiggen_tpu_torch.graph import connected_holdout, random_geometric
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models.embedders import CBOW, SkipGram
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
from embiggen_tpu_torch.pipelines import edge_prediction_evaluation

torch.set_num_threads(2)

REFERENCE_GATE_TEST_AUPRC = 0.9913790290856157
REFERENCE_GCN_MEAN_TEST_AUPRC = 0.9511797508504303
REFERENCE_CBOW_PQ_MEAN_TEST_AUPRC = 0.9883034355107209
SEEDS = range(8)
MARGIN = 0.03
# The CBOW p/q gate: the SkipGram gate's settings with p/q walks, embedding
# seeds CBOW_PQ_SEEDS, a Perceptron on Hadamard alone.
CBOW_PQ = dict(embedding_size=32, epochs=100, batch_size=256, walk_length=16,
               window_size=2, number_of_negative_samples=5, learning_rate_decay=0.99,
               early_stopping_patience=10**6, learning_rate_plateau_patience=10**6,
               return_weight=2.0, explore_weight=0.5)
CBOW_PQ_SEEDS = range(4)


@pytest.fixture(scope="module")
def rgg():
    return random_geometric(1000, radius=0.07, seed=42)


def _perceptron_gate(graph):
    rows = edge_prediction_evaluation(
        holdouts_number=1,
        models=PerceptronEdgePrediction(
            edge_embeddings=["Hadamard"],
            edge_features=["JaccardCoefficient", "AdamicAdar"],
            number_of_epochs=100, random_state=0, device="cpu"),
        graphs=graph,
        node_features=SkipGram(
            embedding_size=32, epochs=100, batch_size=256, walk_length=16,
            window_size=2, number_of_negative_samples=5,
            learning_rate_decay=0.99, random_state=0,
            early_stopping_patience=10**6,
            learning_rate_plateau_patience=10**6, device="cpu"),
        evaluation_schema="Connected Monte Carlo",
        random_state=3,
    )
    test = [r for r in rows if r["evaluation_mode"] == "test"]
    assert len(rows) == 2 and len(test) == 1
    assert all(r["auprc"] >= 0.90 for r in test), [r["auprc"] for r in test]
    assert all(r["auroc"] >= 0.90 for r in test), [r["auroc"] for r in test]
    assert abs(test[0]["auprc"] - REFERENCE_GATE_TEST_AUPRC) <= MARGIN


def _gcn_seeds(graph):
    train, test = connected_holdout(graph, random_state=3)
    auprc = []
    for seed in SEEDS:
        model = GCNEdgePrediction(
            units=[32], tower_units=[16], head_units=[16], epochs=50,
            use_node_embedding=True, node_embedding_size=32, dropout_rate=0.2,
            batch_size=1024, random_state=0, device="cpu")
        model.set_random_state(seed)
        model.fit(train, support=train)
        rows = {r["evaluation_mode"]: r for r in
                model._evaluate(graph, train, test, support=train, random_state=3)}
        auprc.append(rows["test"]["auprc"])
        assert rows["test"]["size_of_positive_set"] == test.number_of_directed_edges
        # Both arcs of each of the test graph's edges, and of as many negatives.
        assert rows["test"]["size_of_negative_set"] == 2 * test.number_of_edges
        assert np.isfinite(rows["train"]["auroc"])
    assert np.mean(auprc) >= max(0.80, REFERENCE_GCN_MEAN_TEST_AUPRC - MARGIN), auprc


def _cbow_pq_auprc(graph, train, test, cbow, perceptron, **device):
    """Test AUPRC per embedding seed of the CBOW p/q gate, with the given
    package's classes."""
    auprc = []
    for seed in CBOW_PQ_SEEDS:
        emb = cbow(random_state=seed, **CBOW_PQ, **device).fit_transform(
            train).node_embeddings[0]
        model = perceptron(edge_embeddings=["Hadamard"], edge_features=None,
                           number_of_epochs=100, random_state=0, **device)
        model.fit(train, node_features=np.asarray(emb))
        rows = {r["evaluation_mode"]: r for r in
                model._evaluate(graph, train, test, random_state=3)}
        auprc.append(rows["test"]["auprc"])
    return auprc


def _cbow_pq_seeds(graph):
    train, test = connected_holdout(graph, random_state=3)
    auprc = _cbow_pq_auprc(graph, train, test, CBOW, PerceptronEdgePrediction, device="cpu")
    assert np.mean(auprc) >= REFERENCE_CBOW_PQ_MEAN_TEST_AUPRC - MARGIN, auprc


@pytest.mark.parametrize("name", ["perceptron", "gcn", "cbow p/q"])
def test_link_prediction_auprc(rgg, name):
    {"perceptron": _perceptron_gate, "gcn": _gcn_seeds, "cbow p/q": _cbow_pq_seeds}[name](rgg)


def test_cbow_pq_reference_mean():
    """The CBOW p/q gate's reference mean is what embiggen_tpu gives on the
    CPU by the same procedure."""
    graph = ref_random_geometric(1000, radius=0.07, seed=42)
    train, test = ref_connected_holdout(graph, random_state=3)
    auprc = _cbow_pq_auprc(graph, train, test, RefCBOW, RefPerceptron)
    assert abs(np.mean(auprc) - REFERENCE_CBOW_PQ_MEAN_TEST_AUPRC) <= 0.005, auprc
