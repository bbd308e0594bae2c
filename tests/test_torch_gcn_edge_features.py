"""The port's edge GCN with edge features on the CPU, held against
embiggen_tpu with the reference's parameters carried across
(`gcn_params_from_jax`, whose head is wider by the features' width) and
dropout 0: a lazy HyperSketching feature (kernel K16b's plain version), a
static [arcs, d] matrix looked up by arc id (K5's plain version, a zeros row
for non-edges), and both, through the edge logits, chunked inference and
three Adam steps on injected batches. Logits and losses agree to rtol /
atol 1e-5 and the parameters after Adam to 1e-4, as in `test_torch_gcn.py`
(the sketch features themselves agree to 1e-5 of their scale,
`tests/hll_checks.py`).

`test_spine_gate_reference_mean` measures the reference mean of the SPINE
edge-GCN gate (`test_torch_spine_gate.py`) again: the reference's gate
(`tests/test_quality_gates.py:92-111`, node_features "Degree-based SPINE")
on the gate fixture's connected holdout with model seeds 0-7, with
embiggen_tpu on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import random_geometric as ref_random_geometric
from embiggen_tpu.graph.holdouts import connected_holdout as ref_connected_holdout
from embiggen_tpu.models.edge_features import HyperSketching as RefHyperSketching
from embiggen_tpu.models.embedders import DegreeSPINE as RefDegreeSPINE
from embiggen_tpu.models.gcn import GCNEdgePrediction as RefGCNEdgePrediction
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models.edge_features import HyperSketching
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, KipfGCNEdgePrediction
from embiggen_tpu_torch.models.gcn.core import TrainLoop, map_params
from embiggen_tpu_torch.utils.convert import gcn_params_from_jax
from test_torch_spine_gate import GATE_GCN, REFERENCE_SPINE_GCN_MEAN_TEST_AUPRC, SEEDS

torch.set_num_threads(1)
N = 80
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
SKETCH = dict(number_of_hops=2, precision=5, random_state=3)
KW = dict(units=[8], tower_units=[6], head_units=[4], dropout_rate=0.0, random_state=0)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_nodes=N, n_edges=400, seed=6)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


def _static(g):
    return np.random.default_rng(4).normal(size=(g.number_of_directed_edges, 3)).astype(
        np.float32)


def _carried_pair(graphs, kind, **kw):
    """Reference and port GCNs with the same initial parameters and the
    edge features of `kind` ("lazy", "static" or "both")."""
    g, rg = graphs
    kw = dict(KW, **kw)
    feats = [np.random.default_rng(1).normal(size=(N, 12)).astype(np.float32)]
    lazy = kind in ("lazy", "both")
    static = [_static(g)] if kind in ("static", "both") else None
    ref = RefGCNEdgePrediction(
        edge_feature_models=[RefHyperSketching(**SKETCH)] if lazy else None, **kw)
    ref._n_outputs = 1
    rparams, rkernels = ref._build_common(rg, rg, feats, jax.random.PRNGKey(0),
                                          edge_features=static)
    port = GCNEdgePrediction(
        device="cpu", edge_feature_models=[HyperSketching(device="cpu", **SKETCH)] if lazy
        else None, **kw)
    port._n_outputs = 1
    port._params, kernels = port._build_common(g, g, feats, torch.Generator().manual_seed(0),
                                               ([], static) if static else None)
    params = gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), port)
    return ref, rparams, rkernels, port, params, kernels


def _pairs(seed, graph, n=300):
    """Half arcs, half uniform pairs."""
    rng = np.random.default_rng(seed)
    arcs = rng.integers(0, graph.number_of_directed_edges, n // 2)
    src = np.concatenate([graph.sources[arcs], rng.integers(0, N, n - n // 2)])
    dst = np.concatenate([graph.col_idx[arcs], rng.integers(0, N, n - n // 2)])
    return src.astype(np.int32), dst.astype(np.int32)


WIDTHS = {"lazy": 8, "static": 3, "both": 11}


@pytest.mark.parametrize("kind", ["lazy", "static", "both"])
def test_edge_logits_and_chunked_inference_match_reference(graphs, kind):
    ref, rparams, rkernels, port, params, kernels = _carried_pair(graphs, kind)
    g, _ = graphs
    assert params["head"][0]["w"].shape[0] == 2 * 6 + WIDTHS[kind]
    src, dst = _pairs(2, g)
    want = ref._edge_logits(rparams, rkernels, jnp.asarray(src), jnp.asarray(dst), N)
    got = port._edge_logits(params, kernels, torch.from_numpy(src), torch.from_numpy(dst), N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ref._params, ref._kernels_coo, ref._n_nodes = rparams, rkernels, N
    port._params, port._n_nodes, port._predict_h = params, N, None
    for rep in (False, True):
        np.testing.assert_allclose(
            port._chunked_logits(src, dst, chunk=64, representation=rep),
            ref._chunked_logits(src, dst, chunk=64, representation=rep), **TOL)
    pick = np.r_[0:5, len(src) - 5:len(src)]   # five arcs, five uniform pairs
    reps = port.transform_edges_from_edge_node_ids(src[pick], dst[pick])
    assert reps.shape == (10, 2 * 6 + WIDTHS[kind])
    if kind == "static":   # the arc's row of the matrix, zeros for a non-edge
        keys = g._sorted_arc_keys
        q = src[pick].astype(np.int64) * N + dst[pick]
        ids = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        is_arc = keys[ids] == q
        want_rows = np.zeros((10, 3), np.float32)
        want_rows[is_arc] = _static(g)[ids[is_arc]]
        assert is_arc[:5].all()
        np.testing.assert_array_equal(reps[:, 12:], want_rows)


@pytest.mark.parametrize("kind", ["lazy", "static", "both"])
def test_loss_and_three_adam_steps_match_reference(graphs, kind):
    g, _ = graphs
    ref, rparams, rkernels, port, params, kernels = _carried_pair(graphs, kind)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        src, dst = _pairs(int(rng.integers(1 << 30)), g, 200)
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
    np.testing.assert_allclose(history, want_losses, **TOL)
    for got, want in zip(jax.tree_util.tree_leaves(map_params(lambda t: t.detach().numpy(), params)),
                         jax.tree_util.tree_leaves(rparams)):
        np.testing.assert_allclose(got, np.asarray(want), **PARAM_TOL)


def test_fit_takes_lazy_and_static_edge_features(graphs):
    """`fit(edge_features=...)` takes a lazy model by instance or by name
    and a static matrix, beside `edge_feature_models`; the head widens by
    their widths and inference scores any pairs."""
    g, _ = graphs
    kw = dict(units=[8], tower_units=[8], head_units=[4], epochs=3, batch_size=64,
              random_state=0, device="cpu")
    feats = np.random.default_rng(0).normal(size=(N, 6)).astype(np.float32)
    model = KipfGCNEdgePrediction(
        edge_feature_models=[HyperSketching(number_of_hops=1, precision=4, device="cpu")], **kw)
    model.fit(g, node_features=feats,
              edge_features=[HyperSketching(number_of_hops=2, device="cpu"), "HyperSketching",
                             _static(g)])
    assert model._params["head"][0]["w"].shape[0] == 2 * 8 + 3 + 8 + 15 + 3
    scores = model.predict_proba(g)
    assert scores.shape == (g.number_of_directed_edges,) and np.isfinite(scores).all()
    src, dst = _pairs(5, g, 40)
    assert np.isfinite(model.predict_proba_from_edge_node_ids(src, dst)).all()
    assert model.transform_edges(g).edge_embeddings[0].shape == (
        g.number_of_directed_edges, 2 * 8 + 29)


@pytest.mark.parametrize("bad, error", [
    (np.zeros((5, 2), np.float32), "rows but graph"),
    ("nan", "NaN or Inf"),
])
def test_static_edge_features_are_validated(graphs, bad, error):
    g, _ = graphs
    if isinstance(bad, str):
        bad = np.full((g.number_of_directed_edges, 2), np.nan, np.float32)
    with pytest.raises(ValueError, match=error):
        GCNEdgePrediction(device="cpu", epochs=1).fit(g, edge_features=bad)


def test_lazy_feature_must_share_the_gcn_device(graphs):
    g, _ = graphs
    model = GCNEdgePrediction(device="cpu", epochs=1,
                              edge_feature_models=[HyperSketching(device="cuda")])
    with pytest.raises(RuntimeError, match="is on cuda, the GCN on cpu"):
        model.fit(g)


def test_spine_gate_reference_mean():
    """The SPINE gate's reference mean is what embiggen_tpu gives on the CPU
    by the same procedure."""
    graph = ref_random_geometric(1000, radius=0.07, seed=42)
    train, test = ref_connected_holdout(graph, random_state=3)
    spine = RefDegreeSPINE().fit_transform(train).node_embeddings[0]
    auprc = []
    for seed in SEEDS:
        model = RefGCNEdgePrediction(**GATE_GCN)
        model.set_random_state(seed)
        model.fit(train, support=train, node_features=spine)
        rows = {r["evaluation_mode"]: r for r in
                model._evaluate(graph, train, test, support=train, random_state=3)}
        auprc.append(rows["test"]["auprc"])
    assert abs(np.mean(auprc) - REFERENCE_SPINE_GCN_MEAN_TEST_AUPRC) <= 0.005, auprc
