"""The label tasks' quality gates for the port on the CPU: the reference's
Kipf GCN node-label gate (`tests/test_quality_gates.py:70-89`) on
planted_partition(1000, 4, p_in=0.05, p_out=0.002, seed=42), and the
reference's edge-label GCN test on karate (`tests/test_gcn.py:81`)."""
import dataclasses

import numpy as np
import torch

from embiggen_tpu_torch.graph import karate_club, planted_partition
from embiggen_tpu_torch.models import embedders, gcn
from embiggen_tpu_torch.pipelines import node_label_prediction_evaluation

torch.set_num_threads(2)

# The reference's node-label gate (tests/test_quality_gates.py:70-89): its
# call verbatim through node_label_prediction_evaluation, then model seeds
# 1-7 fitted on the same holdout's SPINE features and scored by _evaluate.
# The reference's mean test accuracy over seeds 0-7, 1.0 (every seed 1.0),
# was measured with embiggen_tpu on the CPU, JAX_PLATFORMS=cpu, by the
# same procedure with the reference's classes.
NODE_GATE = dict(units=[32], head_units=[32], epochs=100, use_node_embedding=True,
                 node_embedding_size=32, dropout_rate=0.2, random_state=0)
REFERENCE_NODE_GATE_MEAN_TEST_ACCURACY = 1.0


def test_kipf_gcn_node_label_gate():
    sbm = planted_partition(1000, 4, p_in=0.05, p_out=0.002, seed=42)
    rows = node_label_prediction_evaluation(
        holdouts_number=1,
        models=gcn.KipfGCNNodeLabelPrediction(device="cpu", **NODE_GATE), graphs=sbm,
        node_features="Degree-based SPINE", evaluation_schema="Stratified Monte Carlo",
        random_state=3, device="cpu")
    test_rows = [r for r in rows if r["evaluation_mode"] == "test"]
    assert len(test_rows) == 1 and test_rows[0]["accuracy"] >= 0.85, test_rows
    accuracy = [test_rows[0]["accuracy"]]
    cls = gcn.KipfGCNNodeLabelPrediction
    train, test = cls.split_graph_following_evaluation_schema(
        sbm, "Stratified Monte Carlo", 0, random_state=3)
    spine = embedders.DegreeSPINE(device="cpu").fit_transform(train).node_embeddings[0]
    for seed in range(1, 8):
        model = cls(device="cpu", **NODE_GATE)
        model.set_random_state(seed)
        model.fit(train, support=train, node_features=spine)
        got = {r["evaluation_mode"]: r for r in
               model._evaluate(sbm, train, test, support=train, random_state=3)}
        accuracy.append(got["test"]["accuracy"])
    assert min(accuracy) >= 0.85, accuracy
    assert np.mean(accuracy) >= REFERENCE_NODE_GATE_MEAN_TEST_ACCURACY - 0.03, accuracy


def test_edge_label_gcn_on_karate():
    """tests/test_gcn.py:81 for the port: intra-club edges type 0, others
    1; the fitted model's accuracy on every arc above 0.8."""
    g = karate_club()
    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    g = dataclasses.replace(g, edge_types=etypes)
    model = gcn.KipfGCNEdgeLabelPrediction(
        units=[16], tower_units=[16], head_units=[8], epochs=120, learning_rate=0.02,
        batch_size=256, use_node_embedding=True, node_embedding_size=16, dropout_rate=0.1,
        random_state=0, device="cpu")
    model.fit(g)
    proba = model.predict_proba(g)
    assert proba.shape == (g.number_of_directed_edges, 2)
    assert model.is_binary_prediction_task()
    assert (proba.argmax(1) == etypes).mean() > 0.8
