"""The port's edge GCN on the CPU, held against embiggen_tpu with the
reference's parameters carried across (`gcn_params_from_jax`) and dropout
0: the encoder, the edge logits, chunked inference, the loss and three Adam
steps on injected batches, and the TrainLoop's early-stopping, plateau and
NaN decisions on scripted losses. Sums run in another order (the CSR SpMM
against the reference's ELLPACK), so activations agree to rtol/atol 1e-5
and parameters after Adam to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import io_callback

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.gcn import GCNEdgePrediction as RefGCNEdgePrediction
from embiggen_tpu.models.gcn.core import GCNEncoder as RefGCNEncoder
from embiggen_tpu.models.gcn.core import TrainLoop as RefTrainLoop
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.gcn import (
    GCNEdgePrediction, GCNEncoder, GNNEdgePrediction, GraphSAGEEdgePrediction,
    KipfGCNEdgePrediction, TrainLoop,
)
from embiggen_tpu_torch.models.gcn.core import map_params
from embiggen_tpu_torch.utils.convert import gcn_params_from_jax

torch.set_num_threads(1)
N = 80
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_nodes=N, n_edges=400, seed=6)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


def _features(width, seed=0):
    return np.random.default_rng(seed).normal(size=(N, width)).astype(np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


@pytest.mark.parametrize("kernels, combiner, residual", [
    (["Symmetric Normalized Laplacian"], "sum", False),              # Kipf
    (["Left Normalized Laplacian"], "mean", False),                  # GraphSAGE
    (["Symmetric Normalized Laplacian"], "sqrtn", True),             # residual
    (["Symmetric Normalized Laplacian", "Left Normalized Laplacian"], "sum", False),
])
def test_encoder_matches_reference(graphs, kernels, combiner, residual):
    g, rg = graphs
    x = _features(10)
    ref = RefGCNEncoder(kernels, [16, 8], combiner=combiner, dropout_rate=0.0,
                        residual=residual)
    params = ref.init(jax.random.PRNGKey(0), 10)
    want = ref.apply(params, ref.build_kernels(rg), jnp.asarray(x), N)
    enc = GCNEncoder(kernels, [16, 8], combiner=combiner, dropout_rate=0.0,
                     residual=residual)
    got = enc.apply(_to_torch(params), enc.build_kernels(g, "cpu"), torch.from_numpy(x), N)
    assert enc.output_dim(10) == ref.output_dim(10) == got.shape[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _carried_pair(graphs, **kw):
    """Reference and port models with the same initial parameters."""
    g, rg = graphs
    kw = dict(dropout_rate=0.0, random_state=0, **kw)
    feats = [_features(12, seed=1)]
    ref = RefGCNEdgePrediction(**kw)
    ref._n_outputs = 1
    rparams, rkernels = ref._build_common(rg, rg, feats, jax.random.PRNGKey(0))
    port = GCNEdgePrediction(device="cpu", **kw)
    port._n_outputs = 1
    port._params, kernels = port._build_common(g, g, feats, torch.Generator().manual_seed(0))
    params = gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), port)
    return ref, rparams, rkernels, port, params, kernels


CONFIGS = [
    dict(units=[16, 8], tower_units=[8], head_units=[4]),
    dict(units=[8], tower_units=[6, 5], head_units=[4], siamese_towers=False,
         edge_embedding_method="Hadamard", use_node_embedding=True,
         node_embedding_size=6, combiner="mean"),
    dict(units=[8], kernels=["Left Normalized Laplacian"], residual=True,
         edge_embedding_method="Dot"),
    dict(units=[8], tower_units=[6], head_units=[4], use_edge_metrics=True),
]


def _pairs(seed, n=300):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N, n).astype(np.int32), rng.integers(0, N, n).astype(np.int32)


@pytest.mark.parametrize("config", CONFIGS)
def test_edge_logits_and_chunked_inference_match_reference(graphs, config):
    ref, rparams, rkernels, port, params, kernels = _carried_pair(graphs, **config)
    src, dst = _pairs(2)
    want = ref._edge_logits(rparams, rkernels, jnp.asarray(src), jnp.asarray(dst), N)
    got = port._edge_logits(params, kernels, torch.from_numpy(src), torch.from_numpy(dst), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref._params, ref._kernels_coo, ref._n_nodes = rparams, rkernels, N
    port._params, port._n_nodes, port._predict_h = params, N, None
    for rep in (False, True):
        np.testing.assert_allclose(
            port._chunked_logits(src, dst, chunk=64, representation=rep),
            ref._chunked_logits(src, dst, chunk=64, representation=rep), **TOL)
    np.testing.assert_allclose(
        port.predict_proba_from_edge_node_ids(src, dst),
        ref.predict_proba_from_edge_node_ids(src, dst), **TOL)


@pytest.mark.parametrize("config", CONFIGS[:2])
def test_loss_and_three_adam_steps_match_reference(graphs, config):
    g, _ = graphs
    ref, rparams, rkernels, port, params, kernels = _carried_pair(graphs, **config)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        src, dst = _pairs(int(rng.integers(1 << 30)), 200)
        batches.append((src, dst, (rng.random(200) < 0.5).astype(np.float32)))
    lr = 0.01
    opt = optax.adam(lr)
    state = opt.init(rparams)
    want_losses = []
    for src, dst, labels in batches:
        def loss_fn(p):
            logits = ref._edge_logits(p, rkernels, jnp.asarray(src), jnp.asarray(dst), N)[:, 0]
            return (jax.nn.softplus(logits) - labels * logits).mean()

        loss, grads = jax.value_and_grad(loss_fn)(rparams)
        updates, state = opt.update(grads, state, rparams)
        rparams = optax.apply_updates(rparams, updates)
        want_losses.append(float(loss))
    tg = g.device("cpu", with_sources=True)
    it = iter(batches)

    def loss_step(p):
        return port._loss(p, kernels, tg, tuple(map(torch.from_numpy, next(it))), None, None)

    loop = TrainLoop(epochs=3, learning_rate=lr, steps_per_epoch=1,
                     early_stopping_patience=10**6)
    _, history = loop.run(params, loss_step)   # updates params in place
    np.testing.assert_allclose(history, want_losses, rtol=1e-5, atol=1e-6)
    for got, want in zip(jax.tree_util.tree_leaves(map_params(lambda t: t.detach().numpy(), params)),
                         jax.tree_util.tree_leaves(rparams)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("losses, kw", [
    ([1.0, 0.9, 0.95, 0.92, 0.89995, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.1],
     dict(early_stopping_patience=7, reduce_lr_patience=2)),
    ([1.0, 0.8, 0.85, 0.79, 0.7, 0.71, 0.72, 0.73, 0.74, 0.2],
     dict(early_stopping_patience=20, reduce_lr_patience=1, reduce_lr_factor=0.1)),
    ([1.0, 0.8, float("nan"), 0.1], dict()),
])
def test_train_loop_decisions_match_reference(losses, kw):
    """Gradients of ones, scaled by the plateau factor before Adam: the
    returned (best epoch's) parameters record the plateau decisions up to
    that epoch, the history length the stop. One decision taken otherwise
    moves them by about 1e-2; Adam's rounding in the two packages differs
    by about 1e-5 of that, hence rtol 1e-5."""
    feed = iter(losses)

    def ref_step(params, key):
        loss = io_callback(lambda: np.float32(next(feed)),
                           jax.ShapeDtypeStruct((), jnp.float32))
        return loss, jax.tree_util.tree_map(jnp.ones_like, params)

    want_best, want_history = RefTrainLoop(
        epochs=len(losses), learning_rate=0.1, steps_per_epoch=1, **kw,
    ).run({"w": jnp.zeros(3)}, ref_step, jax.random.PRNGKey(0))
    port_feed = iter(losses)

    def port_step(params):
        w = params["w"]
        return w.sum() - w.sum().detach() + next(port_feed)

    params = {"w": torch.zeros(3)}
    best, history = TrainLoop(epochs=len(losses), learning_rate=0.1,
                              steps_per_epoch=1, **kw).run(params, port_step)
    np.testing.assert_allclose(history, np.asarray(want_history, np.float32), rtol=1e-6)
    np.testing.assert_allclose(best["w"].numpy(), np.asarray(want_best["w"]), rtol=1e-5, atol=1e-7)


def test_fit_predict_and_presets(graphs):
    g, _ = graphs
    kw = dict(units=[8], tower_units=[8], head_units=[4], epochs=3,
              batch_size=64, random_state=0, device="cpu")
    feats = _features(6)
    model = KipfGCNEdgePrediction(**kw).fit(g, node_features=feats)
    proba = model.predict_proba(g)
    assert proba.shape == (g.number_of_directed_edges,) and np.isfinite(proba).all()
    assert model._steps_per_epoch == g.number_of_directed_edges // 64
    assert len(model._epoch_seconds) == len(model._history) == 3
    reps = model.transform_edges(g).edge_embeddings[0]
    assert reps.shape == (g.number_of_directed_edges, 16)
    again = KipfGCNEdgePrediction(**kw).fit(g, node_features=feats).predict_proba(g)
    np.testing.assert_array_equal(proba, again)
    assert model.predict(g).dtype == np.int32
    assert get_model_from_library("Kipf GCN", task_name="Edge Prediction") is KipfGCNEdgePrediction
    assert get_model_from_library("GraphSAGE") is GraphSAGEEdgePrediction
    assert GraphSAGEEdgePrediction(device="cpu")._kernels == ["Left Normalized Laplacian"]
    gnn = GNNEdgePrediction(tower_units=[8], head_units=[4], epochs=2, batch_size=64,
                            random_state=0, device="cpu").fit(g)
    assert np.isfinite(gnn.predict_proba(g)).all()
    assert "kernels" not in gnn.parameters() and "units" not in gnn.parameters()
    assert KipfGCNEdgePrediction(**kw).clone().device == torch.device("cpu")


def test_parameters_match_reference():
    kw = dict(units=[8], epochs=3, random_state=5)
    for port_cls, ref_cls in ((GCNEdgePrediction, RefGCNEdgePrediction),):
        assert port_cls(device="cpu", **kw).parameters() == ref_cls(**kw).parameters()


@pytest.mark.parametrize("kwargs, item", [
    (dict(checkpoint_dir="ckpt"), "A12"),
])
def test_unported_options_raise(kwargs, item):
    """The options of ROADMAP `item` are ported since: the model takes and
    keeps them (its resumed fit: tests/test_torch_checkpoint.py)."""
    model = GCNEdgePrediction(device="cpu", **kwargs)
    ((name, value),) = kwargs.items()
    assert item == "A12" and getattr(model, f"_{name}") == value


def test_use_edge_metrics_fits_and_widens_the_head(graphs):
    """`use_edge_metrics` appends the four edge heuristics of the support
    graph to the edge representation (the reference's own test of the
    option is tests/test_combinatorial_gcn.py:129)."""
    g, _ = graphs
    kw = dict(units=[8], tower_units=[8], head_units=[8], epochs=3, batch_size=64,
              random_state=0, device="cpu")
    feats = _features(6)
    model = GCNEdgePrediction(use_edge_metrics=True, **kw).fit(g, node_features=feats)
    assert model.parameters()["use_edge_metrics"] is True
    scores = model.predict_proba(g)
    assert scores.shape == (g.number_of_directed_edges,) and np.isfinite(scores).all()
    base = GCNEdgePrediction(**kw).fit(g, node_features=feats)
    assert (model._params["head"][0]["w"].shape[0]
            == base._params["head"][0]["w"].shape[0] + 4)
    reps = model.transform_edges_from_edge_node_ids(g.sources[:5], g.col_idx[:5])
    assert reps.shape == (5, 2 * 8 + 4)   # Concatenate of two towers, then K8


@pytest.mark.parametrize("kwargs", [dict(use_node_type_embedding=True),
                                    dict(use_edge_type_embedding=True)])
def test_type_embedding_options_fit(graphs, kwargs):
    """The type embeddings are ported: on a graph with node and edge types
    they widen the encoder's input or the head's, and score every arc."""
    g = erdos_renyi(N, 400, seed=4, n_edge_types=3, n_node_types=4)
    kw = dict(units=[8], tower_units=[8], head_units=[8], epochs=2, batch_size=64,
              random_state=0, device="cpu")
    feats = _features(6)
    model = GCNEdgePrediction(**kw, **kwargs).fit(g, node_features=feats)
    base = GCNEdgePrediction(**kw).fit(g, node_features=feats)
    assert model.parameters()[next(iter(kwargs))] is True
    if "use_node_type_embedding" in kwargs:
        assert model._params["embed"]["node_type_embedding"].shape == (5, 50)
        assert (model._params["enc"]["kernels"][0][0]["w"].shape[0]
                == base._params["enc"]["kernels"][0][0]["w"].shape[0] + 50)
    else:
        assert model._params["edge_type_embedding"].shape == (4, 16)
        assert (model._params["head"][0]["w"].shape[0]
                == base._params["head"][0]["w"].shape[0] + 16)
    scores = model.predict_proba(g)
    assert scores.shape == (g.number_of_directed_edges,) and np.isfinite(scores).all()


@pytest.mark.parametrize("kwargs, item", [
    (dict(edge_type_features=[np.zeros((1, 1))]), "no edge types"),
])
def test_unported_feature_classes_raise(graphs, kwargs, item):
    """Edge-type features are ported; on a graph without edge types they
    raise the reference's error before any fit."""
    with pytest.raises(ValueError, match=item):
        GCNEdgePrediction(device="cpu", epochs=1).fit(graphs[0], **kwargs)
