"""The port's Walklets on the CPU against embiggen_tpu: the plain version of
K12 (the per-power pair gradients, added into per-node sums) with K4's
combine against the reference's `_walklet_updates` + `apply_updates`, three
whole steps of Walklets SkipGram and CBOW on injected batches from the same
starting tables, Walklets GloVe's per-power counts and steps, the registry
rows, and the reference's Walklets gate (`tests/test_quality_gates.py:
113-142`) through the port.

The gate's reference figure: the reference's test body verbatim on the CPU
(JAX_PLATFORMS=cpu) gave test AUROC 0.9963 (AUPRC 0.9951); the port must
reach 0.85, the gate's own threshold, and that figure less 0.03. Inputs of
the other tests are made with numpy and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders import glove as ref_glove
from embiggen_tpu.models.embedders import walklets as ref_walklets
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu_torch import edge_prediction_evaluation, embed_graph
from embiggen_tpu_torch.graph import Graph, random_geometric
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models.embedders import WalkletsCBOW, WalkletsGloVe, WalkletsSkipGram
from embiggen_tpu_torch.ops.glove import Entries, cooccurrences, glove_entries
from embiggen_tpu_torch.ops.scatter import SkipGramSums, skipgram_mean_combine
from embiggen_tpu_torch.ops.walklets import walklets_update, walklets_update_plain
from embiggen_tpu_torch.utils.convert import walklets_params_from_jax

torch.set_num_threads(1)

TABLES = ("node_embedding", "context_embedding", "context_bias")
MODELS = {
    "Walklets SkipGram": (WalkletsSkipGram, ref_walklets.WalkletsSkipGram, "skipgram"),
    "Walklets CBOW": (WalkletsCBOW, ref_walklets.WalkletsCBOW, "cbow"),
    "Walklets GloVe": (WalkletsGloVe, ref_walklets.WalkletsGloVe, None),
}
REFERENCE_GATE_TEST_AUROC = 0.9963
GATE_FLOOR = 0.85
MARGIN = 0.03
# K12's sums are taken in another order than the reference's segment sums
# (per power and pair, then the per-row mean), so the tables agree to
# float32 rounding of sums of up to a few hundred terms.
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, power, sub, n=60, b=12, length=12, k=5, scale=0.3):
    rng = np.random.default_rng(seed)
    return dict(
        node_embedding=(scale * rng.normal(size=(power, n, sub))).astype(np.float32),
        context_embedding=(scale * rng.normal(size=(power, n, sub))).astype(np.float32),
        context_bias=rng.normal(size=(power, n)).astype(np.float32),
        walks=rng.integers(0, n, (b, length)).astype(np.int32),
        negs=rng.integers(0, n, (b, k)).astype(np.int32),
    )


def _port_update(x, power, mode, lr):
    """K12's plain version into fresh sums, then K4's combine on the flat
    views; returns (loss per power, tables)."""
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    p, n, sub = t["node_embedding"].shape
    sums = SkipGramSums.zeros(p * n, sub, "cpu")
    loss = walklets_update(*(t[k] for k in TABLES), t["walks"], t["negs"], power, sums, mode)
    skipgram_mean_combine(t["node_embedding"].view(p * n, sub),
                          t["context_embedding"].view(p * n, sub),
                          t["context_bias"].view(p * n), sums, lr)
    assert all(not bool(buf.any()) for buf in sums.buffers())
    return loss, t


@pytest.mark.parametrize("mode", ["skipgram", "cbow"])
@pytest.mark.parametrize("power, sub", [(2, 4), (3, 4), (2, 5), (3, 3)])
def test_update_matches_reference(mode, power, sub):
    """One update: K12's plain version and the combine against the
    reference's `_walklet_updates` and mean-mode `apply_updates` on the
    stacked tables, from the same numpy tables and batch; sub 5 and 3 are
    not multiples of 4."""
    x = _inputs(power * 10 + sub, power, sub)
    cls = {"skipgram": ref_walklets.WalkletsSkipGram, "cbow": ref_walklets.WalkletsCBOW}[mode]
    ref = cls(embedding_size=power * sub, power=power, walk_length=12, window_size=2)
    params = {k: jnp.asarray(x[k]) for k in TABLES}
    b, length = x["walks"].shape
    total, updates = ref._walklet_updates(params, jnp.asarray(x["walks"]),
                                          jnp.asarray(x["negs"]), b)
    want = ref_apply_updates(dict(params), updates, jnp.float32(0.05))
    loss, got = _port_update(x, power, mode, 0.05)
    pairs = np.array([2 * b * (length - p - 1) for p in range(power)])
    np.testing.assert_allclose(float((loss.numpy() / pairs).sum()), float(total), rtol=1e-5)
    for name in TABLES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["skipgram", "cbow"])
def test_update_edges(mode):
    """Walks of power + 1 nodes (one pair at the top power), walks of one
    repeated node, and a node that is a pair member and a negative."""
    power = 3
    x = _inputs(7, power, 4, length=power + 1)
    x["walks"][0] = 9
    x["negs"][1, 0] = x["walks"][1, 2]
    ref_cls = {"skipgram": ref_walklets.WalkletsSkipGram, "cbow": ref_walklets.WalkletsCBOW}[mode]
    ref = ref_cls(embedding_size=12, power=power, walk_length=power + 3, window_size=1)
    params = {k: jnp.asarray(x[k]) for k in TABLES}
    _, updates = ref._walklet_updates(params, jnp.asarray(x["walks"]),
                                      jnp.asarray(x["negs"]), x["walks"].shape[0])
    want = ref_apply_updates(dict(params), updates, jnp.float32(0.05))
    _, got = _port_update(x, power, mode, 0.05)
    for name in TABLES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL,
                                   err_msg=name)


def test_update_counts_and_sums_layout():
    """The sums hold power p's rows at p * N + node; counts_w counts pair
    inputs (2m a walk), counts_c pair targets and negative slots."""
    power, n = 2, 60
    x = _inputs(3, power, 4, n=n)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    sums = SkipGramSums.zeros(power * n, 4, "cpu")
    walklets_update_plain(*(t[k] for k in TABLES), t["walks"], t["negs"], power, sums,
                          "skipgram")
    b, length = x["walks"].shape
    k = x["negs"].shape[1]
    for p in range(power):
        rows = slice(p * n, (p + 1) * n)
        assert float(sums.counts_w[rows].sum()) == 2 * b * (length - p - 1)
        assert float(sums.counts_c[rows].sum()) == 2 * b * (length - p - 1) + b * k


def test_update_rejects_bad_inputs():
    x = _inputs(1, 2, 4, length=2)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    sums = SkipGramSums.zeros(120, 4, "cpu")
    with pytest.raises(ValueError, match="exceed power"):
        walklets_update(*(t[k] for k in TABLES), t["walks"], t["negs"], 2, sums, "skipgram")
    with pytest.raises(ValueError, match="mode"):
        walklets_update(*(t[k] for k in TABLES), t["walks"], t["negs"], 1, sums, "glove")


# ------------------------------------------------------------ whole steps
@pytest.mark.parametrize("name", ["Walklets SkipGram", "Walklets CBOW"])
def test_injected_steps_match_reference(karate, name):
    """Three steps on the same (walks, negatives) batches, from the same
    tables carried across with walklets_params_from_jax, through one set of
    sums (zero again after each step): the loss of each step and every
    table after it."""
    cls, ref_cls, _ = MODELS[name]
    kw = dict(embedding_size=12, power=3, walk_length=10, window_size=2,
              number_of_negative_samples=5, random_state=0)
    ref = ref_cls(**kw)
    params = ref._init_params(karate, jnp.zeros(2, jnp.uint32))
    port = cls(device="cpu", **kw)
    ours = walklets_params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    sums = port._new_sums(ours)
    tg = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx).device("cpu")
    rng = np.random.default_rng(2)
    for step, lr in enumerate((0.05, 0.04, 0.03)):
        walks = rng.integers(0, 34, (16, 10)).astype(np.int32)
        negs = rng.integers(0, 34, (16, 5)).astype(np.int32)
        total, updates = ref._walklet_updates(params, jnp.asarray(walks), jnp.asarray(negs), 16)
        params = ref_apply_updates(dict(params), updates, jnp.float32(lr))
        got = port._step(tg, ours, torch.Generator(), lr,
                         batch=(torch.from_numpy(walks), torch.from_numpy(negs)), sums=sums)
        np.testing.assert_allclose(float(got), float(total) / 3, rtol=1e-5)
        for key in TABLES:
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(params[key]), **TOL,
                                       err_msg=f"{name} {key} step {step}")
        assert all(not bool(t.any()) for t in sums.buffers())


def test_extract_concatenates_the_powers(karate):
    """[P, N, sub] tables come out as [N, P * sub], power-major per node, as
    the reference's `_extract` lays them out."""
    kw = dict(embedding_size=12, power=3, walk_length=10, window_size=2)
    ref = ref_walklets.WalkletsSkipGram(**kw)
    params = {k: np.asarray(v) for k, v in
              ref._init_params(karate, jnp.zeros(2, jnp.uint32)).items()}
    want = ref._extract(params, karate).node_embeddings
    port = WalkletsSkipGram(device="cpu", **kw)
    g = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx)
    got = port._extract(walklets_params_from_jax(params, "cpu"), g).node_embeddings
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def _walklets_glove_counts(walks, n, stride):
    """`walklets.py:381-394` transcribed: the stride's symmetric keys,
    counted, the diagonal dropped, as (ci, cj, counts float32)."""
    a = walks[:, :-stride].reshape(-1).astype(np.int64)
    b = walks[:, stride:].reshape(-1).astype(np.int64)
    keys_np = np.concatenate([a * n + b, b * n + a])
    keys_np.sort(kind="stable")
    uniq, start_idx = np.unique(keys_np, return_index=True)
    counts = np.diff(np.concatenate([start_idx, [len(keys_np)]]))
    ci, cj = (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)
    keep = ci != cj
    return ci[keep], cj[keep], counts[keep].astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2, 5, 12])
def test_walklets_glove_counts_match_reference(stride):
    """K13a's plain version at one stride and weight 1, with the entries'
    log X and f(X), against the reference's per-power counts (stride 12 is
    the walks' length: no pair)."""
    rng = np.random.default_rng(stride)
    walks = rng.integers(0, 40, (30, 12)).astype(np.int32)
    walks[0] = 3   # a walk that only revisits one node: all diagonal
    ci, cj, counts = _walklets_glove_counts(walks, 40, stride)
    got = cooccurrences(torch.from_numpy(walks), 40, [(stride, 1.0)])
    np.testing.assert_array_equal(got[0].numpy(), ci)
    np.testing.assert_array_equal(got[1].numpy(), cj)
    np.testing.assert_array_equal(got[2].numpy(), counts)
    entries = glove_entries(*got, 100.0, 0.75)
    np.testing.assert_allclose(entries.log_x.numpy(), np.log(np.maximum(counts, 1e-9)),
                               rtol=1e-6)
    np.testing.assert_allclose(entries.f_x.numpy(),
                               np.minimum(1.0, (counts / 100.0) ** 0.75), rtol=1e-6)


def test_walklets_glove_steps_match_reference():
    """Three of Walklets GloVe's steps on one power's tables (its b_c fresh
    zeros) on injected entry ids, against the reference's step: the batch
    loss and updates of `walklets.py:413-428`, which are
    `GloVe._batch_updates`' (`glove.py:207-228`) on the power's slices."""
    rng = np.random.default_rng(4)
    n, sub, power = 34, 4, 2
    walks = rng.integers(0, n, (34, 10)).astype(np.int32)
    ci, cj, counts = _walklets_glove_counts(walks, n, 2)
    lx = np.log(np.maximum(counts, 1e-9))
    fx = np.minimum(1.0, (counts / 100.0) ** 0.75).astype(np.float32)
    ref = ref_glove.GloVe(embedding_size=sub)
    tables = {"node_embedding": rng.normal(size=(power, n, sub)).astype(np.float32) / 2,
              "context_embedding": rng.normal(size=(power, n, sub)).astype(np.float32) / 2,
              "context_bias": rng.normal(size=(power, n)).astype(np.float32)}
    params = {"node_embedding": jnp.asarray(tables["node_embedding"][1]),
              "context_embedding": jnp.asarray(tables["context_embedding"][1]),
              "center_bias": jnp.asarray(tables["context_bias"][1]),
              "context_bias": jnp.zeros(n, jnp.float32)}
    port = WalkletsGloVe(embedding_size=power * sub, power=power, walk_length=10,
                         device="cpu")
    ours = walklets_params_from_jax(tables, "cpu")
    state = {"emb": ours["node_embedding"][1], "ctx": ours["context_embedding"][1],
             "bw": ours["context_bias"][1], "bc": torch.zeros(n)}
    entries = Entries(*map(torch.from_numpy, (ci, cj, fx, lx)))
    batch = 48
    for step, lr in enumerate((0.05, 0.04, 0.03)):
        ids = rng.integers(0, len(ci), batch).astype(np.int32)
        sl = tuple(jnp.asarray(a[ids]) for a in (ci, cj, fx, lx))
        loss, updates = ref._batch_updates(params, (sl, ()), batch)
        params = ref_apply_updates(dict(params), updates, jnp.float32(lr))
        got = port._glove_step(state, entries, torch.from_numpy(ids), lr)
        np.testing.assert_allclose(float(got), float(loss) / batch, rtol=1e-5)
        for key, want in (("emb", "node_embedding"), ("ctx", "context_embedding"),
                          ("bw", "center_bias"), ("bc", "context_bias")):
            np.testing.assert_allclose(state[key].numpy(), np.asarray(params[want]),
                                       atol=1e-6, err_msg=f"{key} step {step}")
    # The steps wrote power 1's slices of the stacked tables in place.
    np.testing.assert_array_equal(ours["context_bias"][1].numpy(), state["bw"].numpy())
    np.testing.assert_array_equal(ours["node_embedding"][0].numpy(),
                                  tables["node_embedding"][0])


# ---------------------------------------------------------- registry, fits
@pytest.mark.parametrize("name", list(MODELS))
def test_registry_and_parameters(name):
    cls, ref_cls, _ = MODELS[name]
    assert get_model_from_library(name) is cls
    assert cls.model_name() == ref_cls.model_name() == name
    kw = dict(embedding_size=8, power=2, epochs=3, batch_size=32, random_state=5)
    port = cls(device="cpu", **kw)
    assert port.parameters() == ref_cls(**kw).parameters()
    assert port.clone().parameters() == port.parameters()
    assert cls.smoke_test_parameters() == ref_cls.smoke_test_parameters()
    with pytest.raises(ValueError, match="divisible"):
        cls(device="cpu", embedding_size=10, power=4)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("pq", [False, True])
def test_fit_transform(karate, name, pq):
    """A fit on karate (first-order and p/q walks): both tables come out as
    [N, embedding_size], finite, and the loss was recorded."""
    cls = MODELS[name][0]
    kw = dict(return_weight=2.0, explore_weight=0.5) if pq else {}
    g = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx)
    model = cls(embedding_size=8, power=2, epochs=2, walk_length=10, window_size=2,
                batch_size=16, random_state=0, device="cpu", **kw)
    result = model.fit_transform(g)
    assert [e.shape for e in result.node_embeddings] == [(34, 8), (34, 8)]
    assert all(np.isfinite(e).all() for e in result.node_embeddings)
    assert np.isfinite(model._last_loss)


def test_walklets_gate_on_cpu():
    """The reference's Walklets gate verbatim through the port on the CPU:
    test AUROC at least 0.85 and the reference's less 0.03."""
    rows = edge_prediction_evaluation(
        holdouts_number=1,
        models=PerceptronEdgePrediction(edge_embeddings=["Hadamard"], number_of_epochs=100,
                                        random_state=0, device="cpu"),
        graphs=random_geometric(1000, radius=0.07, seed=42),
        node_features=WalkletsSkipGram(
            embedding_size=32, power=2, epochs=100, batch_size=256, walk_length=16,
            window_size=2, number_of_negative_samples=5, learning_rate_decay=0.99,
            random_state=0, early_stopping_patience=10**6,
            learning_rate_plateau_patience=10**6, device="cpu"),
        evaluation_schema="Connected Monte Carlo",
        random_state=3,
        device="cpu",
    )
    auroc = [r["auroc"] for r in rows if r["evaluation_mode"] == "test"]
    assert len(auroc) == 1
    assert auroc[0] >= max(GATE_FLOOR, REFERENCE_GATE_TEST_AUROC - MARGIN), auroc


def test_embed_graph_smoke():
    g = random_geometric(100, radius=0.2, seed=1)
    for name in MODELS:
        result = embed_graph(g, name, smoke_test=True, device="cpu", random_state=0)
        assert result.embedding_method_name == name
        assert [e.shape for e in result.node_embeddings] == [(100, 4), (100, 4)]
