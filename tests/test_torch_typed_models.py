"""The models of slice S10 on the CPU, held against embiggen_tpu: typed
SkipGram, CBOW, the Walklets rows and GloVe take the typed weights with
the reference's parameters() and run through `embed_graph` over typed walks
(the ELL route with the type tables); the edge GCN with node-type and
edge-type embeddings and feature tables gives the reference's logits,
chunked inference and three Adam steps from the same parameters
(`gcn_params_from_jax`; logits and losses rtol 1e-5 / atol 1e-6, the
parameters after Adam 1e-4, as in `test_torch_gcn.py`); the classifier's
type-feature normalization and the candidate sets by node type equal the
reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models import registry as ref_registry
from embiggen_tpu.models.edge_prediction.model import (
    AbstractEdgePredictionModel as RefAbstractEdgePredictionModel,
)
from embiggen_tpu.models.gcn import GCNEdgePrediction as RefGCNEdgePrediction
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.edge_prediction.model import AbstractEdgePredictionModel
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
from embiggen_tpu_torch.models.gcn.core import TrainLoop, map_params
from embiggen_tpu_torch.ops import walks
from embiggen_tpu_torch.utils.convert import gcn_params_from_jax

torch.set_num_threads(1)
N = 80
TYPED = dict(n_edge_types=3, n_node_types=4)
TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(units=[8], tower_units=[6], head_units=[4], dropout_rate=0.0, random_state=0)
TYPED_WALKS = dict(change_node_type_weight=2.0, change_edge_type_weight=0.5)


@pytest.fixture(scope="module")
def graphs():
    kw = dict(n_nodes=N, n_edges=400, seed=6, **TYPED)
    return erdos_renyi(**kw), ref_erdos_renyi(**kw)


# ------------------------------------------------------------ walk models
@pytest.mark.parametrize("name, extra", [
    ("Node2Vec SkipGram", {}), ("Node2Vec CBOW", dict(return_weight=2.0, explore_weight=0.5)),
    ("Walklets SkipGram", {}), ("Walklets CBOW", {}), ("Walklets GloVe", {}),
    ("Node2Vec GloVe", {}), ("Role2Vec", {}),
])
def test_typed_walk_models_match_reference(monkeypatch, graphs, name, extra):
    """parameters() equal the reference's for the same typed arguments; the
    fit walks the typed route (K9's wrapper with both factors, on the ELL
    type tables) and gives finite embeddings."""
    g, _ = graphs
    kwargs = dict(TYPED_WALKS, **extra)
    port_cls = get_model_from_library(name, task_name="Node Embedding")
    ref_cls = next(iter(ref_registry.MODELS_LIBRARY["Node Embedding"][name].values()))
    smoke = dict(port_cls.smoke_test_parameters(), random_state=0, **kwargs)
    assert port_cls(device="cpu", **smoke).parameters() == ref_cls(**smoke).parameters()
    taken = []
    real = walks.ell_walks

    def spy(tg, *args):
        taken.append((args[-2:], tg.ell_ntypes is not None, tg.ell_etypes is not None))
        return real(tg, *args)

    monkeypatch.setattr(walks, "ell_walks", spy)
    result = embed_graph(g, name, smoke_test=True, device="cpu", random_state=0, **kwargs)
    assert taken and set(taken) == {((2.0, 0.5), True, True)}
    for emb in result.node_embeddings:
        assert emb.shape[0] == N and np.isfinite(emb).all()


# ------------------------------------------------------------------- GCN
def _type_features(g, seed=2):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(g.number_of_node_types, 5)).astype(np.float32)],
            [rng.normal(size=(g.number_of_edge_types, 3)).astype(np.float32)])


def _carried_pair(graphs, **kw):
    """Reference and port GCNs with node and edge types, the same initial
    parameters, node-type and edge-type feature tables."""
    g, rg = graphs
    kw = dict(KW, use_node_type_embedding=True, node_type_embedding_size=6,
              use_edge_type_embedding=True, edge_type_embedding_size=4, **kw)
    feats = [np.random.default_rng(1).normal(size=(N, 12)).astype(np.float32)]
    nt_feats, et_feats = _type_features(g)
    ref = RefGCNEdgePrediction(**kw)
    ref._n_outputs = 1
    rparams, rkernels = ref._build_common(rg, rg, feats, jax.random.PRNGKey(0),
                                          node_type_features=nt_feats,
                                          edge_type_features=et_feats)
    port = GCNEdgePrediction(device="cpu", **kw)
    port._n_outputs = 1
    port._params, kernels = port._build_common(
        g, g, feats, torch.Generator().manual_seed(0), None, nt_feats, et_feats)
    params = gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), port)
    return ref, rparams, rkernels, port, params, kernels


def _pairs(seed, graph, n=300):
    """Half arcs, half uniform pairs."""
    rng = np.random.default_rng(seed)
    arcs = rng.integers(0, graph.number_of_directed_edges, n // 2)
    src = np.concatenate([graph.sources[arcs], rng.integers(0, N, n - n // 2)])
    dst = np.concatenate([graph.col_idx[arcs], rng.integers(0, N, n - n // 2)])
    return src.astype(np.int32), dst.astype(np.int32)


def test_typed_gcn_logits_and_inference_match_reference(graphs):
    ref, rparams, rkernels, port, params, kernels = _carried_pair(graphs)
    g, _ = graphs
    # The node-type features (5) and embedding (6) widen the encoder's input,
    # the edge-type features (3) and embedding (4) the head's.
    assert params["embed"]["node_type_embedding"].shape == (5, 6)
    assert params["edge_type_embedding"].shape == (4, 4)
    assert params["enc"]["kernels"][0][0]["w"].shape[0] == 12 + 5 + 6
    assert params["head"][0]["w"].shape[0] == 2 * 6 + 3 + 4
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
    # An arc's representation ends with its type's rows, a non-edge's with
    # the unknown rows (zeros for the feature table).
    reps = port.transform_edges_from_edge_node_ids(src, dst)
    is_arc = g.has_edges(src, dst)
    assert is_arc[:150].all() and not is_arc.all()
    np.testing.assert_array_equal(reps[~is_arc, 12:15], 0.0)
    types = g.edge_types[g.row_ptr[src[:150]] + [
        np.searchsorted(g.col_idx[g.row_ptr[s]:g.row_ptr[s + 1]], d)
        for s, d in zip(src[:150], dst[:150])]]
    np.testing.assert_allclose(reps[:150, 12:15], _type_features(g)[1][0][types], rtol=0)


def test_typed_gcn_three_adam_steps_match_reference(graphs):
    g, _ = graphs
    ref, rparams, rkernels, port, params, kernels = _carried_pair(graphs)
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
    _, history = loop.run(params, loss_step)
    np.testing.assert_allclose(history, want_losses, **TOL)
    got_leaves = jax.tree_util.tree_leaves(map_params(lambda t: t.detach().numpy(), params))
    for got, want in zip(got_leaves, jax.tree_util.tree_leaves(rparams)):
        np.testing.assert_allclose(got, np.asarray(want), **PARAM_TOL)


def test_typed_gcn_fit_and_evaluation(graphs):
    """`fit` takes node-type and edge-type features (arrays or lists) next
    to the type embeddings, and scores every arc."""
    g, _ = graphs
    nt_feats, et_feats = _type_features(g)
    model = GCNEdgePrediction(device="cpu", epochs=2, batch_size=64, use_node_type_embedding=True,
                              use_edge_type_embedding=True, **{k: v for k, v in KW.items()
                                                                if k != "dropout_rate"})
    model.fit(g, node_type_features=nt_feats[0], edge_type_features=et_feats)
    scores = model.predict_proba(g)
    assert scores.shape == (g.number_of_directed_edges,) and np.isfinite(scores).all()


# ------------------------------------------------------- type normalization
def test_type_feature_normalization_matches_reference(graphs):
    import pandas as pd

    g, rg = graphs
    port, ref = GCNEdgePrediction(device="cpu"), RefGCNEdgePrediction()
    nt_feats, et_feats = _type_features(g)
    nt_frame = pd.DataFrame(nt_feats[0][::-1], index=list(g.get_node_type_names())[::-1])
    for given in (nt_feats[0], nt_feats, [nt_feats[0][:, 0]], nt_frame):
        for got, want in zip(port.normalize_node_type_features(g, given),
                             ref.normalize_node_type_features(rg, given)):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for got, want in zip(port.normalize_edge_type_features(g, et_feats),
                         ref.normalize_edge_type_features(rg, et_feats)):
        assert got.tobytes() == want.tobytes()
    assert port.normalize_node_type_features(g, None) is None
    untyped, ref_untyped = erdos_renyi(N, 400, seed=6), ref_erdos_renyi(N, 400, seed=6)
    for method, bad_graph, ref_graph, given in (
        ("normalize_node_type_features", untyped, ref_untyped, nt_feats),
        ("normalize_edge_type_features", untyped, ref_untyped, et_feats),
        ("normalize_node_type_features", g, rg, [np.ones((3, 2))]),
        ("normalize_edge_type_features", g, rg, [np.full((3, 2), np.nan)]),
        ("normalize_node_type_features", g, rg, nt_frame.iloc[1:]),
    ):
        with pytest.raises(ValueError) as want:
            getattr(ref, method)(ref_graph, given)
        with pytest.raises(ValueError) as got:
            getattr(port, method)(bad_graph, given)
        assert str(got.value) == str(want.value)


# --------------------------------------------------- candidate sets by type
FEATS = np.random.default_rng(0).normal(size=(N, 8))


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

        def predict_proba_from_edge_node_ids(self, src, dst):
            a, b = FEATS[np.asarray(src)], FEATS[np.asarray(dst)]
            return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return CosineScorer


@pytest.mark.parametrize("src_types, dst_types", [
    (["node_type_0"], ["node_type_1", "node_type_3"]), ("node_type_2", "node_type_2"),
])
def test_candidate_sets_by_node_type_match_reference(graphs, src_types, dst_types):
    g, rg = graphs
    port, ref = _scorer(AbstractEdgePredictionModel)(device="cpu"), _scorer(
        RefAbstractEdgePredictionModel)()
    for method, args in (
        ("predict_proba_bipartite_graph_from_edge_node_types", (src_types, dst_types)),
        ("predict_bipartite_graph_from_edge_node_types", (src_types, dst_types)),
        ("predict_proba_clique_graph_from_node_type_names", (src_types,)),
        ("predict_clique_graph_from_node_type_names", (dst_types,)),
    ):
        got = getattr(port, method)(g, *args)
        want = getattr(ref, method)(rg, *args)
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=1e-12)
    frame = port.predict_proba_bipartite_graph_from_edge_node_types(
        g, src_types, dst_types, return_predictions_dataframe=True)
    names = g.get_node_names()
    assert list(frame.index) == list(names[g.get_node_ids_from_node_type_names(src_types)])
