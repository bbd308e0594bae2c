"""The port's Perceptron on the CPU, held against embiggen_tpu: the feature
block for every topological feature (Degree and the five from the edge
heuristics, K8) and every edge-embedding method, whole fits on the
reference's own minibatch indices (injected), and scoring with the
reference's fitted (w, b, mean, std) carried across. Float32 sums in
another order: tolerance 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.edge_prediction import PerceptronEdgePrediction as RefPerceptron
from embiggen_tpu.ops import edge_ops as ref_edge_ops
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.ops import edge_ops
from embiggen_tpu_torch.utils.convert import perceptron_params_from_jax

torch.set_num_threads(1)
N = 90
TOL = dict(rtol=1e-5, atol=1e-5)
METHODS = list(ref_edge_ops.PERCEPTRON_EDGE_METHODS)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_nodes=N, n_edges=350, seed=8)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(0).normal(size=(N, 6)).astype(np.float32)


def test_method_tables_match_reference():
    for name in ("EDGE_TRANSFORMER_METHODS", "EDGE_GCN_METHODS", "PERCEPTRON_EDGE_METHODS"):
        assert list(getattr(edge_ops, name)) == list(getattr(ref_edge_ops, name))


@pytest.mark.parametrize("table", ["EDGE_TRANSFORMER_METHODS", "EDGE_GCN_METHODS"])
def test_edge_ops_match_reference_on_numpy_and_torch(table, feats):
    a, b = feats[:40], feats[40:80]
    for name, fn in getattr(edge_ops, table).items():
        want = np.asarray(getattr(ref_edge_ops, table)[name](jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(fn(a, b), want, **TOL, err_msg=name)
        got = fn(torch.from_numpy(a), torch.from_numpy(b))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)
        assert want.shape[1] == edge_ops.output_dim(name, 6) == ref_edge_ops.output_dim(name, 6)


K8_FEATURES = ["AdamicAdar", "JaccardCoefficient", "ResourceAllocationIndex",
               "PreferentialAttachment", "Cooccurrence"]


@pytest.mark.parametrize("edge_features, edge_embeddings", [
    (["Degree"], METHODS),
    (["Degree"] + K8_FEATURES, []),
    (K8_FEATURES[::-1], ["Hadamard"]),
])
def test_features_match_reference(graphs, feats, edge_features, edge_embeddings):
    g, rg = graphs
    kw = dict(edge_features=edge_features, edge_embeddings=edge_embeddings, random_state=0)
    ref = RefPerceptron(**kw)
    port = PerceptronEdgePrediction(device="cpu", **kw)
    ref._node_features = port._node_features = feats
    rng = np.random.default_rng(1)
    src = np.concatenate([g.sources[::4], rng.integers(0, N, 200)])
    dst = np.concatenate([g.col_idx[::4], rng.integers(0, N, 200)])
    want = ref._features_device(rg.device(with_weights=False), jnp.asarray(feats),
                                jnp.asarray(src), jnp.asarray(dst))
    got = port._features_device(port._device_ctx(g), torch.from_numpy(src),
                                torch.from_numpy(dst))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _reference_indices(seed):
    """The JAX Perceptron's minibatch indices for epoch `epoch`."""
    def indices(generator, epoch, n, steps, batch):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), epoch), steps)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.randint(k, (batch,), 0, n)) for k in keys]).astype(np.int64))
    return indices


@pytest.mark.parametrize("kw", [
    dict(edge_features=["Degree"], edge_embeddings=["CosineSimilarity"]),
    dict(edge_features=[], edge_embeddings=["Hadamard", "L2"], l2_regularization=0.01),
    dict(edge_features=["Degree", "AdamicAdar", "JaccardCoefficient"],
         edge_embeddings=["CosineSimilarity"]),
    dict(edge_features=["ResourceAllocationIndex", "PreferentialAttachment",
                        "Cooccurrence"], edge_embeddings=[]),
])
def test_fit_on_the_reference_batches_matches_reference(graphs, feats, kw):
    g, rg = graphs
    kw = dict(kw, number_of_epochs=3, number_of_edges_per_mini_batch=128,
              learning_rate=0.1, random_state=3)
    ref = RefPerceptron(**kw).fit(rg, node_features=feats)
    port = PerceptronEdgePrediction(device="cpu", **kw)
    port._epoch_indices = _reference_indices(3)
    port.fit(g, node_features=feats)
    for key, want in (("mean", ref._mean), ("std", ref._std), ("w", ref._w), ("b", ref._b)):
        np.testing.assert_allclose(port._linear[key].numpy(), want, **TOL, err_msg=key)
    np.testing.assert_allclose(port._last_loss, ref._last_loss, **TOL)
    np.testing.assert_allclose(port.predict_proba(g), ref.predict_proba(rg), **TOL)


def test_predict_with_carried_parameters_matches_reference(graphs, feats):
    g, rg = graphs
    kw = dict(edge_features=["Degree"], edge_embeddings=["CosineSimilarity", "Hadamard"],
              number_of_epochs=2, random_state=0)
    ref = RefPerceptron(**kw).fit(rg, node_features=feats)
    port = PerceptronEdgePrediction(device="cpu", **kw).fit(g, node_features=feats)
    port._linear = perceptron_params_from_jax(ref._w, ref._b, ref._mean, ref._std, "cpu")
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, N, 500), rng.integers(0, N, 500)
    np.testing.assert_allclose(port.predict_proba_from_edge_node_ids(src, dst),
                               ref.predict_proba_from_edge_node_ids(src, dst), **TOL)
    port.CHUNK = 64   # chunking is only a memory bound
    np.testing.assert_allclose(port.predict_proba_from_edge_node_ids(src, dst),
                               ref.predict_proba_from_edge_node_ids(src, dst), **TOL)
    assert port.predict_proba_from_edge_node_ids([], []).shape == (0,)


def test_parameters_registry_and_errors():
    kw = dict(edge_features=["Degree"], edge_embeddings=["Hadamard"], random_state=4)
    assert PerceptronEdgePrediction(device="cpu", **kw).parameters() == RefPerceptron(**kw).parameters()
    assert get_model_from_library("Perceptron", task_name="Edge Prediction") is PerceptronEdgePrediction
    for feature in K8_FEATURES:
        kw = dict(edge_features=["Degree", feature], random_state=4)
        assert (PerceptronEdgePrediction(device="cpu", **kw).parameters()
                == RefPerceptron(**kw).parameters())
    with pytest.raises(ValueError, match="Unknown edge feature"):
        PerceptronEdgePrediction(edge_features=["Katz"], device="cpu")
    with pytest.raises(ValueError):
        PerceptronEdgePrediction(edge_features=[], device="cpu")
    with pytest.raises(ValueError, match="does not support"):
        PerceptronEdgePrediction(device="cpu").fit(
            erdos_renyi(10, 20), edge_features=[np.zeros((40, 1))])
