"""The S9 quality gate on the CPU: RandNE and NetMF features on the gate
fixture's connected holdout (`random_geometric(1000, radius=0.07, seed=42)`,
random state 3), embedding seeds 0-3 at the rows' defaults (D 100), each
feeding a Perceptron on Hadamard alone (100 epochs, seed 0) scored by
`_evaluate`. The reference has no gate for these rows; with embiggen_tpu on
the CPU (JAX_PLATFORMS=cpu; this procedure with the reference's classes,
which `test_gate_reference_means` runs again) the mean test AUROC is
REFERENCE_MEAN_AUROC[name] (RandNE per seed 0.99354 0.99364 0.99400 0.99446;
NetMF 0.99664 0.99659 0.99664 0.99660). The port's mean must reach it less
0.03, here and on the card (`chip_smoke.py` phase 27).
"""
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import random_geometric as ref_random_geometric
from embiggen_tpu.graph.holdouts import connected_holdout as ref_connected_holdout
from embiggen_tpu.models.edge_prediction import PerceptronEdgePrediction as RefPerceptron
from embiggen_tpu.models.embedders import factorization as ref_factorization
from embiggen_tpu_torch.graph import connected_holdout, random_geometric
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models.embedders import factorization

torch.set_num_threads(1)

GATE_SEEDS = range(4)
REFERENCE_MEAN_AUROC = {"RandNE": 0.9939066727236255, "NetMF": 0.9966186807699228}
MARGIN = 0.03


def _gate_auroc(graph, train, test, embedder, perceptron, **device):
    """Test AUROC per embedding seed, with the given package's classes."""
    auroc = []
    for seed in GATE_SEEDS:
        emb = embedder(random_state=seed, **device).fit_transform(train).node_embeddings[0]
        model = perceptron(edge_embeddings=["Hadamard"], edge_features=None,
                           number_of_epochs=100, random_state=0, **device)
        model.fit(train, node_features=np.asarray(emb))
        rows = {r["evaluation_mode"]: r for r in
                model._evaluate(graph, train, test, random_state=3)}
        auroc.append(rows["test"]["auroc"])
    return auroc


@pytest.mark.parametrize("name", sorted(REFERENCE_MEAN_AUROC))
def test_gate_reference_means(name):
    """Each reference mean is what embiggen_tpu gives on the CPU."""
    graph = ref_random_geometric(1000, radius=0.07, seed=42)
    train, test = ref_connected_holdout(graph, random_state=3)
    auroc = _gate_auroc(graph, train, test, getattr(ref_factorization, name), RefPerceptron)
    assert abs(np.mean(auroc) - REFERENCE_MEAN_AUROC[name]) <= 0.005, auroc


@pytest.mark.parametrize("name", sorted(REFERENCE_MEAN_AUROC))
def test_gate_on_cpu(name):
    graph = random_geometric(1000, radius=0.07, seed=42)
    train, test = connected_holdout(graph, random_state=3)
    auroc = _gate_auroc(graph, train, test, getattr(factorization, name),
                        PerceptronEdgePrediction, device="cpu")
    assert np.mean(auroc) >= REFERENCE_MEAN_AUROC[name] - MARGIN, auroc
