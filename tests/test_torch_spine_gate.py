"""The reference's edge-GCN quality gate with its own node features,
"Degree-based SPINE" (`tests/test_quality_gates.py:92-111`), for the port
on the CPU, on the gate fixture `random_geometric(1000, radius=0.07,
seed=42)` and its connected holdout with random_state 3.

Model seed 0 runs the reference's call verbatim through the port's
`edge_prediction_evaluation` (which fits SPINE on the train graph); seeds
1-7 fit on the same train graph's SPINE embedding and are scored by
`_evaluate`, as the port's feature-free GCN gate in
`test_torch_link_prediction.py` is. One fit is one draw, so the port is
held by its mean test AUPRC over seeds 0-7: at least the reference's mean
less 0.03, and 0.80 (the reference gate's threshold). The reference mean
0.9654934446163882 (per seed 0.97242 0.96904 0.96983 0.97581 0.96771
0.96000 0.97575 0.93340) was measured with embiggen_tpu on the CPU,
JAX_PLATFORMS=cpu, by this procedure with the reference's classes;
`test_torch_gcn_edge_features.py::test_spine_gate_reference_mean` measures
it again.
"""
import numpy as np
import torch

from embiggen_tpu_torch.graph import connected_holdout, random_geometric
from embiggen_tpu_torch.models.embedders import DegreeSPINE
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
from embiggen_tpu_torch.pipelines import edge_prediction_evaluation

torch.set_num_threads(2)

REFERENCE_SPINE_GCN_MEAN_TEST_AUPRC = 0.9654934446163882
GATE_GCN = dict(units=[32], tower_units=[16], head_units=[16], epochs=50,
                use_node_embedding=True, node_embedding_size=32, dropout_rate=0.2,
                batch_size=1024, random_state=0)
SEEDS = range(8)
MARGIN = 0.03


def test_spine_gcn_gate():
    graph = random_geometric(1000, radius=0.07, seed=42)
    rows = edge_prediction_evaluation(
        holdouts_number=1, models=GCNEdgePrediction(device="cpu", **GATE_GCN), graphs=graph,
        node_features="Degree-based SPINE", evaluation_schema="Connected Monte Carlo",
        random_state=3, device="cpu")
    test_rows = [r for r in rows if r["evaluation_mode"] == "test"]
    assert len(test_rows) == 1
    auprc = [test_rows[0]["auprc"]]
    train, test = connected_holdout(graph, random_state=3)
    spine = DegreeSPINE(device="cpu").fit_transform(train).node_embeddings[0]
    assert spine.dtype == np.uint8 and spine.shape == (1000, 100)
    for seed in SEEDS[1:]:
        model = GCNEdgePrediction(device="cpu", **GATE_GCN)
        model.set_random_state(seed)
        model.fit(train, support=train, node_features=spine)
        got = {r["evaluation_mode"]: r for r in
               model._evaluate(graph, train, test, support=train, random_state=3)}
        auprc.append(got["test"]["auprc"])
    assert np.mean(auprc) >= max(0.80, REFERENCE_SPINE_GCN_MEAN_TEST_AUPRC - MARGIN), auprc
