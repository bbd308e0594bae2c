"""The port's LINE and siamese families on the CPU against embiggen_tpu:
three whole steps of each model on injected batches from the same starting
tables, the reference's own karate gates (`tests/test_line_siamese.py`)
through the port, the registry rows, the unported options, and the edge
AUROC gate that `chip_smoke.py` holds the card to.

The AUROC gate: on the reference's gate fixture `random_geometric(1000,
radius=0.07, seed=42)`, First-order LINE and Unstructured are fitted on the
whole graph (GATE_LINE and GATE_UNSTRUCTURED, seed 0) and scored as
`tests/test_line_siamese.py` scores them on karate: dot products (LINE) and
negative squared distances (Unstructured) of the edges against as many
negatives of `sample_negative_graph` (random_state 0 and 3). With
embiggen_tpu on the CPU the same call gives REFERENCE_LINE1_AUROC and
REFERENCE_UNSTRUCTURED_AUROC (`test_gate_reference_auroc` measures them
again); the port must reach each less 0.03. The settings stop short of
saturation (both reach 0.999 when trained longer), so the gate can tell a
broken update from a working one: over seeds 0-2 the reference gave 0.884,
0.892, 0.892 and 0.922, 0.921, 0.929, and the port on the CPU 0.886, 0.892,
0.885 and 0.929, 0.930, 0.928.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import random_geometric as ref_random_geometric
from embiggen_tpu.graph import sample_negative_graph as ref_sample_negative_graph
from embiggen_tpu.models.embedders import line as ref_line
from embiggen_tpu.models.embedders import siamese as ref_siamese
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu.ops.metrics import binary_auroc as ref_binary_auroc
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, random_geometric, sample_negative_graph
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.embedders import (
    FirstOrderLINE, SecondOrderLINE, StructuredEmbedding, TransE, TransH, Unstructured,
)
from embiggen_tpu_torch.ops.metrics import binary_auroc
from embiggen_tpu_torch.utils.convert import minibatch_params_from_jax

torch.set_num_threads(1)

MODELS = {
    "First-order LINE": (FirstOrderLINE, ref_line.FirstOrderLINE, False),
    "Second-order LINE": (SecondOrderLINE, ref_line.SecondOrderLINE, False),
    "Unstructured": (Unstructured, ref_siamese.Unstructured, False),
    "TransE": (TransE, ref_siamese.TransE, True),
    "TransH": (TransH, ref_siamese.TransH, True),
    "Structured Embedding": (StructuredEmbedding, ref_siamese.StructuredEmbedding, True),
}
GATE = dict(embedding_size=32, epochs=30, batch_size=1024, learning_rate_decay=0.99,
            early_stopping_patience=10**6, learning_rate_plateau_patience=10**6,
            random_state=0)
GATE_LINE1 = dict(GATE, learning_rate=0.025)
GATE_UNSTRUCTURED = dict(GATE, learning_rate=1.0)
REFERENCE_LINE1_AUROC = 0.8843448788028528
REFERENCE_UNSTRUCTURED_AUROC = 0.9216162440005579
MARGIN = 0.03


def _karate_types(karate):
    labels = karate.get_single_label_node_type_ids()
    return (labels[karate.sources] != labels[karate.col_idx]).astype(np.int32)


@pytest.fixture(scope="module")
def graphs(karate):
    """(port graph, reference graph), untyped and typed karate."""
    port = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx,
                 directed=karate.directed, name=karate.name)
    etypes = _karate_types(karate)
    return {False: (port, karate),
            True: (dataclasses.replace(port, edge_types=etypes),
                   dataclasses.replace(karate, edge_types=etypes))}


def _batch(rng, typed, line, b=64, k=5, n=34):
    """A batch over the 34 karate nodes, with many repeated rows."""
    if line:
        return (rng.integers(0, n, b).astype(np.int32), rng.integers(0, n, b).astype(np.int32),
                rng.integers(0, n, (b, k)).astype(np.int32))
    out = tuple(rng.integers(0, n, b).astype(np.int32) for _ in range(4))
    return out + ((rng.integers(0, 2, b).astype(np.int32),) if typed else ())


@pytest.mark.parametrize("name", list(MODELS))
def test_injected_steps_match_reference(graphs, name):
    """Three steps on the same batches from the same tables carried across
    with minibatch_params_from_jax: the loss of each step and every table
    after it."""
    cls, ref_cls, typed = MODELS[name]
    port_graph, ref_graph = graphs[typed]
    kw = dict(embedding_size=8 if name == "Structured Embedding" else 16, random_state=0)
    ref = ref_cls(**kw)
    params = ref._init_params(ref_graph, jnp.zeros(2, jnp.uint32))
    port = cls(device="cpu", **kw)
    ours = minibatch_params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                     port, port_graph)
    b = 64
    port._run_batch_size = b
    tg = port._prepare_data(port_graph)
    rng = np.random.default_rng(5)
    line = name.endswith("LINE")
    for step, lr in enumerate((0.05, 0.04, 0.03)):
        sl = _batch(rng, typed, line, b)
        want_loss, updates = ref._batch_updates(params, (tuple(map(jnp.asarray, sl)), ()), b)
        params = ref_apply_updates(dict(params), updates, jnp.float32(lr))
        # The port's siamese batch is K14's block of rows, [4, B] or [5, B].
        sliceable = (tuple(map(torch.from_numpy, sl)) if line
                     else torch.from_numpy(np.stack(sl)))
        with torch.no_grad():
            loss = port._step(tg, ours, torch.Generator(), lr, batch=(sliceable, ()))
        np.testing.assert_allclose(float(loss), float(want_loss) / b, rtol=1e-5, atol=1e-6)
        assert set(ours) == set(params)
        for key, table in ours.items():
            np.testing.assert_allclose(table.numpy(), np.asarray(params[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {key} step {step}")


@pytest.mark.parametrize("name", ["l1_distance", "squared_l2_distance", "margin_loss"])
def test_losses_match_reference(name):
    """The distances and the margin loss, and their gradients (the margin's
    at exact ties too, split as jnp.maximum splits them)."""
    import jax

    from embiggen_tpu.ops import losses as ref_losses
    from embiggen_tpu_torch.ops import losses

    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(50, 7)).astype(np.float32) for _ in range(2))
    if name == "margin_loss":
        a, b = a[:, 0], b[:, 0]
        b[:10] = a[:10] + 1.0     # bias + a - b == 0 exactly
    ref_fn, fn = getattr(ref_losses, name), getattr(losses, name)
    want = ref_fn(jnp.asarray(a), jnp.asarray(b))
    want_g = jax.grad(lambda x, y: ref_fn(x, y).sum(), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = fn(ta, tb)
    got_g = torch.autograd.grad(got.sum(), (ta, tb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_params_from_jax_checks_keys_and_shapes(graphs):
    port_graph, ref_graph = graphs[True]
    ref = ref_siamese.TransH(embedding_size=4, random_state=0)
    params = {k: np.asarray(v) for k, v in
              ref._init_params(ref_graph, jnp.zeros(2, jnp.uint32)).items()}
    model = TransH(embedding_size=4, random_state=0, device="cpu")
    got = minibatch_params_from_jax(params, model, port_graph)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "node_embedding": (34, 4), "edge_type_embedding": (2, 4), "normal_vector": (2, 4)}
    assert all(t.dtype == torch.float32 for t in got.values())
    with pytest.raises(KeyError, match="TransH"):
        minibatch_params_from_jax({"node_embedding": params["node_embedding"]}, model,
                                  port_graph)
    with pytest.raises(ValueError, match="shape"):
        minibatch_params_from_jax(params, TransH(embedding_size=5, random_state=0,
                                                 device="cpu"), port_graph)
    with pytest.raises(ValueError, match="shape"):
        minibatch_params_from_jax(params, model, graphs[False][0])


def test_initial_params_are_used(graphs):
    port_graph = graphs[True][0]
    tables = {"node_embedding": torch.full((34, 4), 0.5),
              "edge_type_embedding": torch.full((2, 4), -0.5)}
    kw = dict(embedding_size=4, epochs=1, batch_size=16, learning_rate=0.0,
              random_state=1, device="cpu")
    result = TransE(**kw, initial_params=tables).fit_transform(port_graph)
    np.testing.assert_array_equal(result.node_embeddings[0], 0.5)
    np.testing.assert_array_equal(result.edge_type_embeddings[0], -0.5)
    with pytest.raises(ValueError, match="shape"):
        TransE(**{**kw, "embedding_size": 3}, initial_params=tables).fit_transform(port_graph)


# ------------------------------------------------ the reference's karate gates
KARATE = dict(early_stopping_patience=10**6, learning_rate_plateau_patience=10**6,
              random_state=0, device="cpu")


def _edge_auc(emb, graph, seed=0):
    """AUROC of dot-product scores: real edges vs random non-edges."""
    emb = np.asarray(emb, float)
    neg = sample_negative_graph(graph, graph.number_of_edges, random_state=seed)
    pos_s = (emb[graph.sources] * emb[graph.col_idx]).sum(1)
    neg_s = (emb[neg.sources] * emb[neg.col_idx]).sum(1)
    labels = np.concatenate([np.ones(len(pos_s)), np.zeros(len(neg_s))])
    return binary_auroc(labels, np.concatenate([pos_s, neg_s]))


def _distance_auc(emb, graph, seed=3):
    """AUROC of negative squared distances: real edges vs random non-edges."""
    emb = np.asarray(emb, float)
    neg = sample_negative_graph(graph, graph.number_of_edges, random_state=seed)
    pos_d = -((emb[graph.sources] - emb[graph.col_idx]) ** 2).sum(1)
    neg_d = -((emb[neg.sources] - emb[neg.col_idx]) ** 2).sum(1)
    labels = np.concatenate([np.ones(len(pos_d)), np.zeros(len(neg_d))])
    return binary_auroc(labels, np.concatenate([pos_d, neg_d]))


def test_first_order_line_karate_gate(graphs):
    model = FirstOrderLINE(embedding_size=16, epochs=600, batch_size=156,
                           learning_rate=0.3, learning_rate_decay=0.995, **KARATE)
    emb = model.fit_transform(graphs[False][0]).get_node_embedding_from_index(0)
    auc = _edge_auc(emb, graphs[False][0])
    assert auc > 0.8, f"LINE1 link AUROC too low: {auc}"


def test_second_order_line_karate(graphs):
    model = SecondOrderLINE(embedding_size=16, epochs=600, batch_size=156,
                            learning_rate=0.3, learning_rate_decay=0.995, **KARATE)
    result = model.fit_transform(graphs[False][0])
    assert len(result.node_embeddings) == 2
    assert all(e.shape == (34, 16) and np.isfinite(e).all() for e in result.node_embeddings)


def test_unstructured_karate_gate(graphs):
    model = Unstructured(embedding_size=16, epochs=200, batch_size=156,
                         learning_rate=0.05, learning_rate_decay=0.995, **KARATE)
    emb = model.fit_transform(graphs[False][0]).get_node_embedding_from_index(0)
    auc = _distance_auc(emb, graphs[False][0])
    assert auc > 0.75, f"Unstructured distance AUROC too low: {auc}"


def test_transe_karate(graphs):
    model = TransE(embedding_size=16, epochs=200, batch_size=156,
                   learning_rate=0.05, learning_rate_decay=0.995, **KARATE)
    result = model.fit_transform(graphs[True][0])
    assert len(result.edge_type_embeddings) == 1
    assert result.edge_type_embeddings[0].shape == (2, 16)
    assert np.isfinite(result.node_embeddings[0]).all()


@pytest.mark.parametrize("cls", [TransH, StructuredEmbedding])
def test_transh_and_structured_karate(graphs, cls):
    model = cls(embedding_size=8, epochs=10, batch_size=64, learning_rate=0.05,
                random_state=0, device="cpu")
    emb = model.fit_transform(graphs[True][0]).get_node_embedding_from_index(0)
    assert emb.shape == (34, 8) and np.isfinite(emb).all()


# --------------------------------------------------------- registry, options
@pytest.mark.parametrize("name", list(MODELS))
def test_registry_rows(name):
    cls, ref_cls, typed = MODELS[name]
    assert get_model_from_library(name) is cls
    assert get_model_from_library(name.lower(), task_name="Node Embedding") is cls
    assert cls.model_name() == ref_cls.model_name() == name
    assert cls.requires_edge_types() == ref_cls.requires_edge_types() == typed


@pytest.mark.parametrize("name", list(MODELS))
def test_parameters_match_reference(name):
    cls, ref_cls, _ = MODELS[name]
    kw = dict(embedding_size=8, epochs=3, batch_size=32, random_state=5)
    port = cls(device="cpu", **kw)
    assert port.parameters() == ref_cls(**kw).parameters()
    assert port.clone().consistent_hash() == port.consistent_hash()
    assert port.clone().device == torch.device("cpu")
    assert cls.smoke_test_parameters() == ref_cls.smoke_test_parameters()
    assert cls.supports_distribution() == ref_cls.supports_distribution()


@pytest.mark.parametrize("name", ["TransE", "TransH", "Structured Embedding"])
def test_typed_models_require_edge_types(graphs, name):
    model = get_model_from_library(name).into_smoke_test(random_state=0, device="cpu")
    with pytest.raises(ValueError, match="edge types"):
        model.fit_transform(graphs[False][0])
    with pytest.raises(RuntimeError, match="edge types"):
        embed_graph(graphs[False][0], name, smoke_test=True, device="cpu", random_state=0)


@pytest.mark.parametrize("kwargs, item", [
    (dict(mesh=4), "A13"), (dict(checkpoint_dir="ckpt"), "A12"),
    (dict(enable_cache=True), "A12"),
])
@pytest.mark.parametrize("cls", [SecondOrderLINE, TransE])
def test_unported_options_raise(cls, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        cls(device="cpu", random_state=0, **kwargs)


def test_distribution_is_validated():
    with pytest.raises(ValueError, match="distribution"):
        FirstOrderLINE(device="cpu", random_state=0, distribution="everywhere")


@pytest.mark.parametrize("name", list(MODELS))
def test_embed_graph_smoke(graphs, name):
    typed = MODELS[name][2]
    result = embed_graph(graphs[typed][0], name, smoke_test=True, device="cpu",
                         random_state=0)
    assert result.embedding_method_name == name
    assert result.node_embeddings[0].shape == (34, 5)
    assert len(result.node_embeddings) == (2 if name == "Second-order LINE" else 1)


def test_row_sharded_keys_and_resolved_batch(graphs):
    g = graphs[True][0]
    model = TransE(device="cpu", random_state=0, embedding_size=4)
    params = model._init_params(g, torch.Generator().manual_seed(0))
    assert model._row_sharded_keys(g, params) == ("node_embedding",)
    assert model._resolve_batch_size(g, None) == 1024
    assert model._steps_per_epoch(g, None, 1024) == 1
    assert TransE(device="cpu", random_state=0, batch_size=16)._steps_per_epoch(
        g, None, 16) == g.number_of_directed_edges // 16


# ------------------------------------------------------------ the AUROC gate
def _gate_auroc(graph, embed, dist, binary_auroc_fn, sample_fn):
    emb = np.asarray(embed(graph).node_embeddings[0], float)
    neg = sample_fn(graph, graph.number_of_edges, random_state=3 if dist else 0)

    def score(a, b):
        return -((a - b) ** 2).sum(1) if dist else (a * b).sum(1)
    pos_s = score(emb[graph.sources], emb[graph.col_idx])
    neg_s = score(emb[neg.sources], emb[neg.col_idx])
    labels = np.concatenate([np.ones(len(pos_s)), np.zeros(len(neg_s))])
    return binary_auroc_fn(labels, np.concatenate([pos_s, neg_s]))


def test_gate_reference_auroc():
    """The gate's reference AUROCs are what embiggen_tpu gives on the CPU."""
    g = ref_random_geometric(1000, radius=0.07, seed=42)
    for cls, kw, dist, want in (
        (ref_line.FirstOrderLINE, GATE_LINE1, False, REFERENCE_LINE1_AUROC),
        (ref_siamese.Unstructured, GATE_UNSTRUCTURED, True, REFERENCE_UNSTRUCTURED_AUROC),
    ):
        got = _gate_auroc(g, lambda graph: cls(**kw).fit_transform(graph), dist,
                          ref_binary_auroc, ref_sample_negative_graph)
        assert abs(got - want) <= 0.005, (cls.__name__, got)


@pytest.mark.parametrize("cls, kw, dist, want", [
    (FirstOrderLINE, GATE_LINE1, False, REFERENCE_LINE1_AUROC),
    (Unstructured, GATE_UNSTRUCTURED, True, REFERENCE_UNSTRUCTURED_AUROC),
])
def test_gate_auroc_on_cpu(cls, kw, dist, want):
    g = random_geometric(1000, radius=0.07, seed=42)
    got = _gate_auroc(g, lambda graph: cls(device="cpu", **kw).fit_transform(graph), dist,
                      binary_auroc, sample_negative_graph)
    assert got >= want - MARGIN, got
