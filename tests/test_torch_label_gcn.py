"""The port's label GCNs, GraphConvolution and node-label anchors on the
CPU, held to embiggen_tpu on the same numpy inputs.

The reference's parameters are carried across (`gcn_params_from_jax`; the
reference's initial ones are those of a fit of 0 epochs) with dropout 0:
node-label logits and probabilities, and three Adam steps of the real fits
(both packages' TrainLoop started from the carried parameters), within
1e-5; the edge-label logits, chunked inference and three Adam steps on
injected batches within 1e-5. GraphConvolution within 1e-5 of the
reference and of a dense product, in both transposes and concatenated;
Node-label-based SPINE and WINE exactly. The edge-label batch is uniform
over the arcs of known type (chi-square), the node-label GCN's fit on a
2-rank gloo mesh equals one device, and the constructors' parameters equal
the reference's (the quality gates are in test_torch_label_gate.py). Sums
run in another order (the CSR SpMM against the reference's ELLPACK), hence
the tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models import embedders as ref_embedders
from embiggen_tpu.models import gcn as ref_gcn
from embiggen_tpu.models.feature_preprocessors import GraphConvolution as RefGraphConvolution
from embiggen_tpu.models.gcn.core import TrainLoop as RefTrainLoop
from embiggen_tpu.models.gcn.core import apply_mlp as ref_apply_mlp
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.graph.laplacians import kernel_coo
from embiggen_tpu_torch.models import embedders, gcn
from embiggen_tpu_torch.models.feature_preprocessors import GraphConvolution
from embiggen_tpu_torch.models.gcn.core import TrainLoop, map_params
from embiggen_tpu_torch.utils.convert import gcn_params_from_jax

import dist_ranks

torch.set_num_threads(2)
N = 80
TOL = dict(rtol=1e-5, atol=1e-5)


def _typed(seed=6, multilabel=False):
    """The port's and the reference's erdos_renyi(N, 400) with 4 node
    types (several a node when `multilabel`, some nodes unlabelled) and 3
    edge types."""
    kw = dict(n_nodes=N, n_edges=400, seed=seed, n_edge_types=3, n_node_types=4)
    port, ref = erdos_renyi(**kw), ref_erdos_renyi(**kw)
    if multilabel:
        rng = np.random.default_rng(seed)
        counts = rng.integers(0, 4, N)
        ids = np.concatenate([rng.choice(4, c, replace=False) for c in counts]).astype(np.int32)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        port = dataclasses.replace(port, node_type_ptr=ptr, node_type_ids=ids)
        ref = dataclasses.replace(ref, node_type_ptr=ptr, node_type_ids=ids)
    return port, ref


def _features(width, seed=1):
    return np.random.default_rng(seed).normal(size=(N, width)).astype(np.float32)


# --------------------------------------------------------------- node label
NODE_CONFIGS = [
    ("KipfGCNNodeLabelPrediction", dict(units=[16, 8], head_units=[8]), 12, False),
    ("GraphSAGENodeLabelPrediction", dict(units=[8], head_units=[6], combiner="mean",
                                          use_class_weights=False), 12, False),
    ("GCNNodeLabelPrediction", dict(kernels=["Symmetric Normalized Laplacian",
                                             "Left Normalized Laplacian"], units=[8],
                                    head_units=[4], residual=True,
                                    use_node_type_embedding=True,
                                    node_type_embedding_size=5), 6, False),
    ("GNNNodeLabelPrediction", dict(head_units=[8], node_embedding_size=6), 0, False),
    ("KipfGCNNodeLabelPrediction", dict(units=[8], head_units=[8]), 0, True),
]


_NODE_PAIRS = {}


def _node_pair(cls, kw, width, multilabel):
    """Reference and port node-label models fitted for 0 epochs, the port
    holding the reference's initial parameters, and the features they took;
    built once a configuration and shared by the tests that read them."""
    key = repr((cls, kw, width, multilabel))
    if key not in _NODE_PAIRS:
        _NODE_PAIRS[key] = _build_node_pair(cls, kw, width, multilabel)
    return _NODE_PAIRS[key]


def _build_node_pair(cls, kw, width, multilabel):
    g, rg = _typed(multilabel=multilabel)
    feats = _features(width) if width else None
    kw = dict(kw, dropout_rate=0.0, random_state=0, epochs=0)
    ref = getattr(ref_gcn, cls)(**kw)
    ref.fit(rg, node_features=feats)
    port = getattr(gcn, cls)(device="cpu", **kw)
    port.fit(g, node_features=feats)
    carried = gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, ref._params), port)
    port._params = carried
    return ref, port, g, rg, feats


def _ref_logits(ref, params):
    x = ref._spec.materialize(params["embed"])
    h = ref._encoder.apply(params["enc"], ref._kernels_coo, x, N)
    return ref_apply_mlp(params["head"], h)


@pytest.mark.parametrize("cls, kw, width, multilabel", NODE_CONFIGS)
def test_node_label_logits_match_reference(cls, kw, width, multilabel):
    ref, port, g, rg, _ = _node_pair(cls, kw, width, multilabel)
    assert port.parameters() == ref.parameters()
    assert port.is_multilabel_prediction_task() == ref.is_multilabel_prediction_task()
    got = port._logits(port._params, port._csr_kernels, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(_ref_logits(ref, ref._params)), **TOL)
    np.testing.assert_allclose(port.predict_proba(g), ref.predict_proba(rg), **TOL)
    np.testing.assert_allclose(port.predict_proba(g, support=g),
                               ref.predict_proba(rg, support=rg), **TOL)
    with pytest.raises(ValueError, match="head ends in"):
        gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, ref._params),
                            type("M", (), {"device": "cpu", "_n_classes": 99})())


@pytest.mark.parametrize("cls, kw, width, multilabel", NODE_CONFIGS)
def test_node_label_three_adam_steps_match_reference(monkeypatch, cls, kw, width, multilabel):
    """Both packages' real fits, 3 epochs of one full-graph Adam step each,
    started from the same parameters: the loss history and the parameters
    after the steps agree."""
    ref, port, g, rg, feats = _node_pair(cls, kw, width, multilabel)
    start = map_params(lambda t: t.clone(), port._params)
    ref_start = ref._params
    ref_run, port_run = RefTrainLoop.run, TrainLoop.run
    monkeypatch.setattr(RefTrainLoop, "run",
                        lambda self, params, *a, **k: ref_run(self, ref_start, *a, **k))
    monkeypatch.setattr(TrainLoop, "run",
                        lambda self, params, step, **k: port_run(self, start, step, **k))
    kw = dict(kw, dropout_rate=0.0, random_state=0, epochs=3, learning_rate=0.01,
              early_stopping_patience=10**6)
    ref = getattr(ref_gcn, cls)(**kw)
    ref.fit(rg, node_features=feats)
    port = getattr(gcn, cls)(device="cpu", **kw)
    port.fit(g, node_features=feats)
    np.testing.assert_allclose(port._history, ref._history, **TOL)
    assert port._history[-1] < port._history[0]
    for got, want in zip(jax.tree_util.tree_leaves(map_params(lambda t: t.numpy(), port._params)),
                         jax.tree_util.tree_leaves(ref._params)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_node_label_fit_predict_and_options():
    g, _ = _typed()
    model = gcn.KipfGCNNodeLabelPrediction(units=[8], head_units=[8], epochs=4, random_state=0,
                                           device="cpu")
    model.fit(g)     # no features: a learned node embedding
    assert model.parameters()["use_node_embedding"] is True
    proba = model.predict_proba(g)
    assert proba.shape == (N, 4)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    assert len(model._history) == len(model._epoch_seconds) == 4
    again = model.clone().fit(g).predict_proba(g)
    np.testing.assert_array_equal(proba, again)
    assert model.predict(g).dtype == np.int32
    assert gcn.GCNNodeLabelPrediction(checkpoint_dir="ckpt",
                                      device="cpu")._checkpoint_dir == "ckpt"


# --------------------------------------------------------------- edge label
EDGE_CONFIGS = [
    dict(units=[16, 8], tower_units=[8], head_units=[4]),
    dict(units=[8], tower_units=[6, 5], head_units=[4], siamese_towers=False,
         edge_embedding_method="Hadamard", use_node_embedding=True, node_embedding_size=6,
         combiner="mean"),
    dict(units=[8], tower_units=[6], head_units=[4], use_edge_metrics=True),
]


def _edge_pair(config):
    g, rg = _typed()
    kw = dict(config, dropout_rate=0.0, random_state=0)
    feats = [_features(12)]
    ref = ref_gcn.GCNEdgeLabelPrediction(**kw)
    ref._n_outputs = 3
    rparams, rkernels = ref._build_common(rg, rg, feats, jax.random.PRNGKey(0))
    port = gcn.GCNEdgeLabelPrediction(device="cpu", **kw)
    port._n_outputs = 3
    port._params, kernels = port._build_common(g, g, feats, torch.Generator().manual_seed(0))
    params = gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), port)
    port._n_nodes = N
    return g, ref, rparams, rkernels, port, params, kernels


def _arcs(g, seed, n):
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, g.number_of_directed_edges, n)
    return (g.sources[pick].astype(np.int32), g.col_idx[pick].astype(np.int32),
            g.edge_types[pick].astype(np.int32))


@pytest.mark.parametrize("config", EDGE_CONFIGS)
def test_edge_label_logits_match_reference(config):
    g, ref, rparams, rkernels, port, params, kernels = _edge_pair(config)
    src, dst, _ = _arcs(g, 2, 300)
    want = ref._edge_logits(rparams, rkernels, jnp.asarray(src), jnp.asarray(dst), N)
    got = port._edge_logits(params, kernels, torch.from_numpy(src), torch.from_numpy(dst), N)
    assert got.shape == (300, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref._params, ref._kernels_coo, ref._n_nodes = rparams, rkernels, N
    port._params, port._predict_h = params, None
    np.testing.assert_allclose(port._chunked_logits(src, dst, chunk=64),
                               ref._chunked_logits(src, dst, chunk=64), **TOL)
    np.testing.assert_allclose(port._predict_proba(g), ref._predict_proba(g), **TOL)


@pytest.mark.parametrize("config", EDGE_CONFIGS[:2])
def test_edge_label_three_adam_steps_match_reference(config):
    g, ref, rparams, rkernels, port, params, kernels = _edge_pair(config)
    batches = [_arcs(g, seed, 200) for seed in (3, 4, 5)]
    lr = 0.01
    opt = optax.adam(lr)
    state = opt.init(rparams)
    want_losses = []
    @jax.jit
    def loss_and_grads(p, src, dst, y):
        def loss_fn(p):
            logits = ref._edge_logits(p, rkernels, src, dst, N)
            logp = jax.nn.log_softmax(logits, axis=1)
            return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

        return jax.value_and_grad(loss_fn)(p)

    for src, dst, y in batches:
        loss, grads = loss_and_grads(rparams, *map(jnp.asarray, (src, dst, y)))
        updates, state = opt.update(grads, state, rparams)
        rparams = optax.apply_updates(rparams, updates)
        want_losses.append(float(loss))
    it = iter(batches)
    loop = TrainLoop(epochs=3, learning_rate=lr, steps_per_epoch=1,
                     early_stopping_patience=10**6)
    _, history = loop.run(params, lambda p: port._loss(
        p, kernels, None, tuple(map(torch.from_numpy, next(it))), None, None))
    np.testing.assert_allclose(history, want_losses, **TOL)
    for got, want in zip(jax.tree_util.tree_leaves(map_params(lambda t: t.detach().numpy(), params)),
                         jax.tree_util.tree_leaves(rparams)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_edge_label_batch_is_uniform_over_known_arcs():
    """50 batches of 4096 from the arcs of known type: never an arc of
    unknown type, each known arc as often as the others (chi-square, fail at
    p < 1e-3), and each batch's ends and type those of one arc."""
    g, _ = _typed()
    types = g.edge_types.copy()
    types[::3] = -1
    g = dataclasses.replace(g, edge_types=types)
    known_idx = np.nonzero(g.get_known_edge_types_mask())[0]
    known = tuple(torch.from_numpy(a[known_idx].astype(np.int32))
                  for a in (g.sources, g.col_idx, g.edge_types))
    model = gcn.GCNEdgeLabelPrediction(device="cpu")
    model._run_batch_size = 4096
    generator = torch.Generator().manual_seed(5)
    counts = np.zeros(len(known_idx))
    for _ in range(50):
        src, dst, y = (t.numpy() for t in model._draw_batch(known, generator))
        ids = g.get_edge_ids(src, dst)
        assert (ids >= 0).all() and (g.edge_types[ids] == y).all() and (y >= 0).all()
        counts += np.bincount(np.searchsorted(known_idx, ids), minlength=len(known_idx))
    assert stats.chisquare(counts).pvalue > 1e-3


def test_edge_label_fit_predict_and_options():
    g, _ = _typed()
    kw = dict(units=[8], tower_units=[8], head_units=[4], epochs=3, batch_size=64,
              random_state=0, device="cpu")
    model = gcn.KipfGCNEdgeLabelPrediction(**kw).fit(g, node_features=_features(6))
    proba = model.predict_proba(g)
    assert proba.shape == (g.number_of_directed_edges, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    assert model._steps_per_epoch == g.number_of_directed_edges // 64
    assert not model.is_binary_prediction_task()
    assert "use_edge_type_embedding" not in model.parameters()
    again = gcn.KipfGCNEdgeLabelPrediction(**kw).fit(g, node_features=_features(6))
    np.testing.assert_array_equal(proba, again.predict_proba(g))
    with pytest.raises(ValueError, match="edge_type_features"):
        gcn.KipfGCNEdgeLabelPrediction(**kw).fit(g, edge_type_features=np.ones((3, 2)))
    gnn = gcn.GNNEdgeLabelPrediction(tower_units=[8], head_units=[4], epochs=2, batch_size=64,
                                     random_state=0, device="cpu").fit(g)
    assert np.isfinite(gnn.predict_proba(g)).all()


def test_constructor_parameters_match_reference():
    kw = dict(epochs=3, random_state=5)
    for name in ("GCNNodeLabelPrediction", "KipfGCNNodeLabelPrediction",
                 "GraphSAGENodeLabelPrediction", "GNNNodeLabelPrediction",
                 "GCNEdgeLabelPrediction", "KipfGCNEdgeLabelPrediction",
                 "GraphSAGEEdgeLabelPrediction", "GNNEdgeLabelPrediction"):
        port, ref = getattr(gcn, name)(device="cpu", **kw), getattr(ref_gcn, name)(**kw)
        assert port.parameters() == ref.parameters(), name
        assert port.model_name() == ref.model_name() and port.task_name() == ref.task_name()
        assert port.clone().parameters() == ref.parameters()
    conv = dict(number_of_convolutions=3, concatenate_features=True, transpose=True,
                normalize_rows=True, dtype="f64")
    assert GraphConvolution(device="cpu", **conv).parameters() == \
        RefGraphConvolution(**conv).parameters()


# ---------------------------------------------------------- GraphConvolution
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("options", [dict(), dict(concatenate_features=True),
                                     dict(normalize_rows=True, number_of_convolutions=3),
                                     dict(dtype="f64"), dict(dtype="f16")])
def test_graph_convolution_matches_reference(transpose, options):
    g, rg = _typed(seed=3)
    x = [_features(6), _features(3, seed=2)]
    kw = dict(transpose=transpose, **options)
    got = GraphConvolution(device="cpu", **kw).transform(g, x)
    want = RefGraphConvolution(**kw).transform(rg, x)
    assert got.embedding_method_name == want.embedding_method_name
    tol = dict(rtol=2e-3, atol=2e-3) if options.get("dtype") == "f16" else TOL
    for a, b in zip(got.node_embeddings, want.node_embeddings):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float64), np.asarray(b, np.float64), **tol)
    # The sum the code means: the kernel's dense product (the transposed
    # kernel's rows are not sorted).
    rows, cols, vals = kernel_coo(g, "Transposed Left Normalized Laplacian" if transpose
                                  else "Left Normalized Laplacian")
    assert transpose == bool((rows[1:] < rows[:-1]).any())
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), vals)
    h = x[0].astype(np.float64)
    if options.get("normalize_rows"):
        h = h / np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-9)
    hops = [h]
    for _ in range(options.get("number_of_convolutions", 2)):
        hops.append(dense @ hops[-1])
    dense_want = np.concatenate(hops, axis=1) if options.get("concatenate_features") else hops[-1]
    np.testing.assert_allclose(got.node_embeddings[0].astype(np.float64), dense_want, **tol)


# ------------------------------------------------------------ node-label anchors
@pytest.mark.parametrize("cls", ["NodeLabelSPINE", "NodeLabelWINE"])
@pytest.mark.parametrize("multilabel", [False, True])
def test_node_label_anchors_equal_reference(cls, multilabel):
    g, rg = _typed(seed=9, multilabel=multilabel)
    got = getattr(embedders, cls)(device="cpu").fit_transform(g)
    want = getattr(ref_embedders, cls)().fit_transform(rg)
    assert got.node_embeddings[0].dtype == np.asarray(want.node_embeddings[0]).dtype
    assert got.node_embeddings[0].shape[1] == len(np.unique(
        g.get_single_label_node_type_ids()[g.get_known_node_types_mask()]))
    np.testing.assert_array_equal(got.node_embeddings[0], np.asarray(want.node_embeddings[0]))


# ----------------------------------------------------------------- mesh
def test_node_label_gcn_mesh_matches_single_device(tmp_path):
    """Two gloo ranks with the halo-exchange convolution, with and without
    dropout, fit as one device does (tests/test_mesh_models.py:193's
    tolerance); both ranks alike."""
    ranks = dist_ranks.spawn("node_label", 2, tmp_path)
    for rate in (0.0, 0.5):
        want, want_history = dist_ranks.node_label_gcn_fit(rate)
        got, got_history = ranks[0][rate]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_history, want_history, rtol=1e-5)
        np.testing.assert_array_equal(ranks[1][rate][0], got)
