"""The port's GloVe on the CPU against embiggen_tpu: the plain version of
K13a (the windowed co-occurrence sums) against `GloVe._cooccurrences` on
the same walks, the entries' log X and f(X), the plain version of K13b (the
weighted-least-squares step, applied in place) against
`GloVe._batch_updates` + `apply_updates` on injected batches (with heavily
repeated rows too, and for Walklets GloVe's step on slices), the registry
rows and options, and fits on small graphs.

The reference draws its walks inside `_cooccurrences`; the tests hand it the
walks they give the port by replacing the reference module's `random_walks`
for the test (pytest's monkeypatch), so that nothing in embiggen_tpu changes.
Inputs are made with numpy.

The GloVe gate: the reference has none, and at the other gates' settings
(batch 1024) its GloVe does not learn, since its loss is a batch mean with
"add" updates, so each entry moves its rows by lr / B. On the gate fixture's
connected holdout (`random_geometric(1000, radius=0.07, seed=42)`, random
state 3) Node2Vec GloVe at GATE (batch 64, learning rate 2.0) feeds a
Perceptron on Hadamard alone, embedding seeds 0-3: with embiggen_tpu on the
CPU (JAX_PLATFORMS=cpu; this procedure with the reference's classes,
`test_gate_reference_mean` runs it again) the mean test AUROC is
REFERENCE_GATE_MEAN_AUROC (per seed 0.67835 0.70501 0.70980 0.71368); the
port's mean must reach it less 0.03.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import random_geometric as ref_random_geometric
from embiggen_tpu.graph.holdouts import connected_holdout as ref_connected_holdout
from embiggen_tpu.models.edge_prediction import PerceptronEdgePrediction as RefPerceptron
from embiggen_tpu.models.embedders import glove as ref_glove
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, connected_holdout, erdos_renyi, random_geometric
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.embedders import DeepWalkGloVe, GloVe, WalkletsGloVe
from embiggen_tpu_torch.ops.glove import (
    Entries, cooccurrences, draw_entries, glove_entries, glove_step, glove_step_plain,
    glove_strides,
)
from embiggen_tpu_torch.utils.convert import minibatch_params_from_jax

torch.set_num_threads(1)

MODELS = {"Node2Vec GloVe": (GloVe, ref_glove.GloVe),
          "DeepWalk GloVe": (DeepWalkGloVe, ref_glove.DeepWalkGloVe)}
TABLES = ("node_embedding", "context_embedding", "center_bias", "context_bias")
GATE = dict(embedding_size=32, epochs=30, batch_size=64, learning_rate=2.0,
            learning_rate_decay=0.99, walk_length=16, window_size=2, iterations=4,
            early_stopping_patience=10**6, learning_rate_plateau_patience=10**6)
GATE_SEEDS = range(4)
REFERENCE_GATE_MEAN_AUROC = 0.7017104723535372
MARGIN = 0.03


def _walks(seed, n, w=40, length=10, revisit=True):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, n, (w, length)).astype(np.int32)
    if revisit:
        walks[0] = 5                  # one node only: every pair diagonal
        walks[1, ::2] = walks[1, 1]   # a node at every other step
    return walks


def _reference_cooccurrences(monkeypatch, karate, walks, window):
    monkeypatch.setattr(ref_glove, "random_walks", lambda *a, **k: jnp.asarray(walks))
    ref = ref_glove.GloVe(embedding_size=4, walk_length=walks.shape[1],
                          window_size=window, iterations=1)
    return ref, ref._cooccurrences(karate)


@pytest.mark.parametrize("window", [1, 2, 3, 9, 12])
def test_cooccurrences_match_reference(monkeypatch, karate, window):
    """Keys exact, sums rtol 1e-6 (float64 sums in another order, cast to
    float32); window 9 and 12 reach and pass the walks' length (10)."""
    walks = _walks(window, 34)
    _, (ci, cj, counts) = _reference_cooccurrences(monkeypatch, karate, walks, window)
    got = cooccurrences(torch.from_numpy(walks), 34, glove_strides(window))
    np.testing.assert_array_equal(got[0].numpy(), ci)
    np.testing.assert_array_equal(got[1].numpy(), cj)
    assert got[2].dtype == torch.float32
    np.testing.assert_allclose(got[2].numpy(), counts, rtol=1e-6)
    # Symmetric, no diagonal, ascending keys.
    assert not (got[0] == got[1]).any()
    keys = got[0].long() * 34 + got[1].long()
    assert bool((keys[1:] > keys[:-1]).all())


def test_entries_match_reference(monkeypatch, karate):
    """The model's `_prepare_data` (walks, K13a, log X and f(X)) against the
    reference's on the same walks."""
    walks = _walks(3, 34, w=34)
    ref, _ = _reference_cooccurrences(monkeypatch, karate, walks, 2)
    want = ref._prepare_data(karate)
    port = GloVe(embedding_size=4, walk_length=10, window_size=2, iterations=1,
                 device="cpu")
    monkeypatch.setattr(port, "_walks", lambda graph: torch.from_numpy(walks))
    got = port._prepare_data(Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx))
    assert port._n_entries == ref._n_entries
    for name in ("ci", "cj"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want[name]))
    for name in ("f_x", "log_x"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_cooccurrences_rejects_bad_inputs():
    walks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        cooccurrences(walks, 2**31, [(1, 1.0)])
    with pytest.raises(ValueError, match="at least 1"):
        cooccurrences(walks, 10, [(0, 1.0)])
    ci, cj, sums = cooccurrences(walks, 10, [(4, 1.0), (1, 1.0)])
    assert ci.shape == cj.shape == sums.shape == (0,)


def _entries(seed, n=34, e=200):
    rng = np.random.default_rng(seed)
    counts = rng.uniform(0.5, 300.0, e).astype(np.float32)
    return (rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
            np.minimum(1.0, (counts / 100.0) ** 0.75).astype(np.float32),
            np.log(counts).astype(np.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_injected_steps_match_reference(karate, name):
    """Three steps on the same entry ids from the same tables carried across
    with minibatch_params_from_jax: the loss of each step and every table
    after it (atol 1e-6)."""
    cls, ref_cls = MODELS[name]
    ref = ref_cls(embedding_size=8, random_state=0)
    params = ref._init_params(karate, jnp.zeros(2, jnp.uint32))
    port = cls(embedding_size=8, random_state=0, device="cpu")
    g = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx)
    ours = minibatch_params_from_jax({k: np.asarray(v) for k, v in params.items()}, port, g)
    data = _entries(1)
    entries = Entries(*map(torch.from_numpy, data))
    rng = np.random.default_rng(2)
    b = 64
    port._run_batch_size = b
    for step, lr in enumerate((0.5, 0.4, 0.3)):
        ids = rng.integers(0, 200, b).astype(np.int32)
        sl = tuple(jnp.asarray(a[ids]) for a in data)
        want_loss, updates = ref._batch_updates(params, (sl, ()), b)
        params = ref_apply_updates(dict(params), updates, jnp.float32(lr))
        with torch.no_grad():
            loss = port._step(entries, ours, torch.Generator(), lr,
                              batch=((torch.from_numpy(ids),), entries))
        np.testing.assert_allclose(float(loss), float(want_loss) / b, rtol=1e-5)
        for key in TABLES:
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(params[key]), atol=1e-6,
                                       err_msg=f"{name} {key} step {step}")


def test_step_gradients_are_the_reference_loss_gradients():
    """K13b's plain version: each table's change is -lr times autograd's
    gradient of the reference's batch-mean loss (`glove_loss` times the
    weights' mean form, `glove.py:213`) with respect to the whole table, so
    repeated rows sum, and the loss returned is its sum. The changes are
    read back from float32 tables of values up to about 4, so they carry the
    tables' rounding (half an ulp, 2.4e-7, an addition): atol 1e-6."""
    data = _entries(5)
    entries = Entries(*map(torch.from_numpy, data))
    rng = np.random.default_rng(6)
    tables = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((34, 8), (34, 8), (34,), (34,))]
    ids = torch.from_numpy(rng.integers(0, 200, 50).astype(np.int32))
    lr = 0.3
    leaves = [t.clone().requires_grad_() for t in tables]
    i, j = entries.ci[ids.long()].long(), entries.cj[ids.long()].long()
    pred = (leaves[0][i] * leaves[1][j]).sum(1) + leaves[2][i] + leaves[3][j]
    f_x, log_x = entries.f_x[ids.long()], entries.log_x[ids.long()]
    want = (f_x * (pred - log_x) ** 2).sum() / 50
    grads = torch.autograd.grad(want, leaves)
    before = [t.clone() for t in tables]
    loss = glove_step(entries, ids, *tables, lr)
    assert loss.shape == ()
    np.testing.assert_allclose(float(loss) / 50, float(want.detach()), rtol=1e-6)
    for t, t0, grad in zip(tables, before, grads):
        np.testing.assert_allclose(t.double().numpy() - t0.double().numpy(),
                                   -lr * grad.double().numpy(), rtol=1e-5, atol=1e-6)
    assert len(set(i.tolist())) < 50 and len(set(j.tolist())) < 50
    assert glove_step_plain is not glove_step


def _repeated_entries(rng, n=34, e=200):
    """Entries whose centers and contexts repeat heavily: half the entries
    have center 0, a third context 1."""
    ci, cj, f_x, log_x = _entries(int(rng.integers(1 << 30)), n, e)
    ci[: e // 2] = 0
    cj[e // 3: 2 * e // 3] = 1
    return ci, cj, f_x, log_x


def _repeated_ids(rng, e, b):
    """A batch whose first quarter is one entry and whose second quarter is
    three entries; the rest uniform."""
    ids = rng.integers(0, e, b)
    ids[: b // 4] = 3
    ids[b // 4: b // 2] = rng.choice([70, 71, 90], b // 4)
    return ids.astype(np.int32)


@pytest.mark.parametrize("name", ["Node2Vec GloVe", "Walklets GloVe"])
def test_in_place_steps_with_repeated_rows_match_reference(name):
    """Three in-place steps (the plain version of K13b) against the
    reference's `GloVe._batch_updates` + `apply_updates` on batches where
    centers and contexts repeat many times: every table within atol 1e-6,
    the loss within rtol 1e-5. GloVe steps through `_step` on an injected
    batch; Walklets GloVe through `_glove_step` on views of power 1's slices
    of [P, N, D] tables, whose power 0 stays as it was."""
    rng = np.random.default_rng(11)
    n, d, power, b = 34, 8, 2, 64
    data = _repeated_entries(rng)
    entries = Entries(*map(torch.from_numpy, data))
    init = {"node_embedding": rng.normal(size=(power, n, d)).astype(np.float32) / 2,
            "context_embedding": rng.normal(size=(power, n, d)).astype(np.float32) / 2,
            "center_bias": rng.normal(size=(power, n)).astype(np.float32),
            "context_bias": rng.normal(size=n).astype(np.float32)}
    params = {k: jnp.asarray(v[1] if v.ndim > 1 and v.shape[0] == power else v)
              for k, v in init.items()}
    ref = ref_glove.GloVe(embedding_size=d)
    stacked = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    if name == "Walklets GloVe":
        port = WalkletsGloVe(embedding_size=power * d, power=power, device="cpu")
        tables = {"emb": stacked["node_embedding"][1], "ctx": stacked["context_embedding"][1],
                  "bw": stacked["center_bias"][1], "bc": stacked["context_bias"]}
        names = dict(zip(tables, TABLES))
    else:
        port = GloVe(embedding_size=d, device="cpu")
        port._run_batch_size = b
        tables = {k: stacked[k][1].clone() if k != "context_bias" else stacked[k]
                  for k in TABLES}
        names = {k: k for k in TABLES}
    for step, lr in enumerate((0.5, 0.4, 0.3)):
        ids = _repeated_ids(rng, len(data[0]), b)
        assert len(set(data[0][ids])) < b // 3 and len(set(data[1][ids])) < b // 2
        sl = tuple(jnp.asarray(a[ids]) for a in data)
        want_loss, updates = ref._batch_updates(params, (sl, ()), b)
        params = ref_apply_updates(dict(params), updates, jnp.float32(lr))
        with torch.no_grad():
            if name == "Walklets GloVe":
                loss = port._glove_step(tables, entries, torch.from_numpy(ids), lr)
            else:
                loss = port._step(entries, tables, torch.Generator(), lr,
                                  batch=((torch.from_numpy(ids),), entries))
        np.testing.assert_allclose(float(loss), float(want_loss) / b, rtol=1e-5)
        for key, ref_key in names.items():
            np.testing.assert_allclose(tables[key].numpy(), np.asarray(params[ref_key]),
                                       atol=1e-6, err_msg=f"{name} {key} step {step}")
    if name == "Walklets GloVe":
        np.testing.assert_array_equal(stacked["node_embedding"][0].numpy(),
                                      init["node_embedding"][0])
        np.testing.assert_array_equal(stacked["node_embedding"][1].numpy(),
                                      tables["emb"].numpy())


def test_draw_entries_are_uniform_ids():
    entries = Entries(*map(torch.from_numpy, _entries(0, e=7)))
    ids = draw_entries(entries, 7000, torch.Generator().manual_seed(0))
    assert ids.dtype == torch.int32 and ids.shape == (7000,)
    counts = np.bincount(ids.numpy(), minlength=7)
    assert counts.min() > 850 and counts.max() < 1150, counts


# ---------------------------------------------------------- registry, fits
@pytest.mark.parametrize("name", list(MODELS))
def test_registry_and_parameters(name):
    cls, ref_cls = MODELS[name]
    assert get_model_from_library(name) is cls
    assert cls.model_name() == ref_cls.model_name() == name
    kw = dict(embedding_size=8, epochs=3, batch_size=32, random_state=5)
    port = cls(device="cpu", **kw)
    assert port.parameters() == ref_cls(**kw).parameters()
    assert port.clone().parameters() == port.parameters()
    assert cls.smoke_test_parameters() == ref_cls.smoke_test_parameters()
    # The port applies the step in place and returns no Update, so it stays
    # on one device until multi-device training is ported; the reference's
    # GloVe steps through the Update protocol and is distributable.
    assert ref_cls.supports_distribution() and not cls.supports_distribution()


@pytest.mark.parametrize("kwargs, error, match", [
    (dict(change_node_type_weight=2.0), NotImplementedError, "A6"),
    (dict(change_edge_type_weight=0.5), NotImplementedError, "A6"),
    (dict(mesh=4), NotImplementedError, "A13"),
])
def test_unported_options_raise(kwargs, error, match):
    with pytest.raises(error, match=match):
        GloVe(device="cpu", **kwargs)


def test_deepwalk_glove_forbids_pq():
    with pytest.raises(ValueError, match="return_weight"):
        DeepWalkGloVe(device="cpu", return_weight=2.0)


@pytest.mark.parametrize("kw", [{}, dict(return_weight=2.0, explore_weight=0.5)])
def test_fit_transform(kw):
    """Fits on a weighted graph (alias walks) and with p/q walks (the ELL
    table): finite [N, D] tables, one loss an epoch, the batch the entry
    count caps."""
    g = erdos_renyi(80, 300, seed=3)
    g = dataclasses.replace(g, weights=np.random.default_rng(0).uniform(
        0.5, 2.0, g.number_of_directed_edges).astype(np.float32))
    model = GloVe(embedding_size=6, epochs=3, walk_length=8, window_size=2, iterations=2,
                  batch_size=10**6, random_state=0, device="cpu",
                  early_stopping_patience=10**6, **kw)
    result = model.fit_transform(g)
    assert [e.shape for e in result.node_embeddings] == [(80, 6), (80, 6)]
    assert all(np.isfinite(e).all() for e in result.node_embeddings)
    assert len(model._epoch_losses) == 3 and model._run_batch_size == model._n_entries


def test_embed_graph_smoke():
    g = erdos_renyi(60, 240, seed=1)
    for name in MODELS:
        result = embed_graph(g, name, smoke_test=True, device="cpu", random_state=0)
        assert result.embedding_method_name == name
        assert [e.shape for e in result.node_embeddings] == [(60, 5), (60, 5)]


# ------------------------------------------------------------------ the gate
def _gate_auroc(graph, train, test, glove, perceptron, **device):
    """Test AUROC per embedding seed of the GloVe gate, with the given
    package's classes."""
    auroc = []
    for seed in GATE_SEEDS:
        emb = glove(random_state=seed, **GATE, **device).fit_transform(train).node_embeddings[0]
        model = perceptron(edge_embeddings=["Hadamard"], edge_features=None,
                           number_of_epochs=100, random_state=0, **device)
        model.fit(train, node_features=np.asarray(emb))
        rows = {r["evaluation_mode"]: r for r in
                model._evaluate(graph, train, test, random_state=3)}
        auroc.append(rows["test"]["auroc"])
    return auroc


def test_gate_reference_mean():
    """The gate's reference mean is what embiggen_tpu gives on the CPU."""
    graph = ref_random_geometric(1000, radius=0.07, seed=42)
    train, test = ref_connected_holdout(graph, random_state=3)
    auroc = _gate_auroc(graph, train, test, ref_glove.GloVe, RefPerceptron)
    assert abs(np.mean(auroc) - REFERENCE_GATE_MEAN_AUROC) <= 0.005, auroc


def test_gate_on_cpu():
    graph = random_geometric(1000, radius=0.07, seed=42)
    train, test = connected_holdout(graph, random_state=3)
    auroc = _gate_auroc(graph, train, test, GloVe, PerceptronEdgePrediction, device="cpu")
    assert np.mean(auroc) >= REFERENCE_GATE_MEAN_AUROC - MARGIN, auroc
