"""The port's CBOW step and models on the CPU against embiggen_tpu: the
plain version of K11 (the sampled-softmax gradients, and their update into
per-node sums), three whole steps on injected batches from the same starting
tables, and the new registry rows (Node2Vec CBOW with p/q walks, the
DeepWalk presets, the generic Node2Vec). Inputs are made with numpy and
handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders.walk_based import CBOW as RefCBOW
from embiggen_tpu.models.embedders.walk_based import _mean_scatter
from embiggen_tpu.ops.walks import random_walks as ref_random_walks
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, planted_partition_edges
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.embedders import (
    CBOW, DeepWalkCBOW, DeepWalkSkipGram, Node2Vec, SkipGram,
)
from embiggen_tpu_torch.ops.cbow import cbow_grads_plain, cbow_update
from embiggen_tpu_torch.ops.scatter import SkipGramSums, mean_scatter, skipgram_mean_combine
from embiggen_tpu_torch.utils.convert import cbow_params_from_jax

torch.set_num_threads(1)
TABLES = ("node_embedding", "output_embedding", "output_bias")


def _inputs(seed, n=60, d=16, b=12, length=16, k=5, scale=0.3, bias_scale=1.0):
    rng = np.random.default_rng(seed)
    return dict(
        node_embedding=(scale * rng.normal(size=(n, d))).astype(np.float32),
        output_embedding=(scale * rng.normal(size=(n, d))).astype(np.float32),
        output_bias=(bias_scale * rng.normal(size=n)).astype(np.float32),
        walks=rng.integers(0, n, (b, length)).astype(np.int32),
        negs=rng.integers(0, n, (b, k)).astype(np.int32),
        center_w=rng.uniform(0, 2, (b, length)).astype(np.float32),
    )


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("clip_binds", [False, True])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_cbow_grads_match_reference(with_center_w, clip_binds, window):
    """With clip_binds, large rows and biases drive most logits past the
    +-6 clip."""
    x = _inputs(window, scale=2.0 if clip_binds else 0.3,
                bias_scale=8.0 if clip_binds else 1.0)
    length = x["walks"].shape[1]
    ref = RefCBOW(embedding_size=16, walk_length=length, window_size=window,
                  random_state=0)
    params = {k: jnp.asarray(x[k]) for k in TABLES}
    cw = x["center_w"] if with_center_w else None
    want_loss, want_rows, want_negs = ref._gathered_grads(
        lambda name, i: params[name][i], jnp.asarray(x["walks"]),
        jnp.asarray(x["negs"]), None if cw is None else jnp.asarray(cw))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    if clip_binds:
        h = torch.einsum("bld,bld->bl", t["node_embedding"][t["walks"].long()],
                         t["output_embedding"][t["walks"].long()])
        assert float(((h + t["output_bias"][t["walks"].long()]).abs() > 6).float().mean()) > 0.3
    loss, rows, negs = cbow_grads_plain(
        *(t[k] for k in TABLES), t["walks"], t["negs"], window, 6.0,
        None if cw is None else t["center_w"])
    # Sums are taken in another order than the JAX version's.
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=1e-5)
    for got, want in zip(rows + negs, want_rows + want_negs):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _batch(case, rng, step, dg):
    """(walks [20, 12], negs [20, 5], center_w or None) for one step."""
    if case == "karate walks":
        walks = np.array(ref_random_walks(
            dg, jnp.asarray(rng.integers(0, 34, 20), jnp.int32), 12,
            jnp.asarray([0, step], jnp.uint32), return_weight=2.0,
            explore_weight=0.5))
        return walks, rng.integers(0, 34, (20, 5)).astype(np.int32), None
    walks = rng.integers(0, 33, (20, 12)).astype(np.int32)
    negs = rng.integers(0, 33, (20, 5)).astype(np.int32)
    if case == "centre and negative":
        negs[:, 0] = walks[:, 4]
        negs[:, 1] = walks[:, 7]
    elif case == "node only before w":
        # Node 33 sits only at positions 0 .. w - 1: never a centre, in the
        # window of the first centres only, never a negative.
        walks[::3, 0] = 33
        walks[1::4, 2] = 33
    cw = (rng.uniform(0, 2, (20, 12)).astype(np.float32)
          if case == "center_w" else None)
    return walks, negs, cw


@pytest.mark.parametrize("case", ["karate walks", "centre and negative",
                                  "node only before w", "center_w"])
def test_injected_steps_match_reference(karate, case):
    """Three CBOW steps on the same (walks, negatives) batches, from the
    same tables carried across with cbow_params_from_jax, through one set of
    sums (zero again after each step)."""
    kw = dict(embedding_size=16, walk_length=12, window_size=3,
              number_of_negative_samples=5, random_state=0)
    ref = RefCBOW(**kw)
    params = ref._init_params(karate, jnp.zeros(2, jnp.uint32))
    port = CBOW(device="cpu", **kw)
    ours = cbow_params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    sums = port._new_sums(ours)
    tg = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx).device("cpu")
    rng = np.random.default_rng(1)
    dg = karate.device(ell_cap=100)
    for step, lr in enumerate((0.05, 0.04, 0.03)):
        walks, negs, cw = _batch(case, rng, step, dg)
        loss, row_g, neg_g = ref._gathered_grads(
            lambda name, i: params[name][i], jnp.asarray(walks),
            jnp.asarray(negs), None if cw is None else jnp.asarray(cw))
        params = ref._apply_table_grads(
            dict(params), jnp.asarray(walks).reshape(-1),
            tuple(g.reshape((-1,) + g.shape[2:]) for g in row_g),
            jnp.asarray(negs).reshape(-1),
            tuple(g.reshape((-1,) + g.shape[2:]) for g in neg_g),
            jnp.float32(lr), mean_scatter=_mean_scatter,
        )
        port._center_weights = lambda tg, walks, gen, cw=cw: (
            None if cw is None else torch.from_numpy(cw))
        got_loss = port._step(
            tg, ours, torch.Generator(), lr,
            batch=(torch.from_numpy(walks), torch.from_numpy(negs)), sums=sums)
        np.testing.assert_allclose(float(got_loss), float(loss) / (20 * 6), rtol=1e-5)
        for name, table in ours.items():
            np.testing.assert_allclose(table.numpy(), np.asarray(params[name]),
                                       atol=1e-6, err_msg=f"{name} step {step}")
        assert all(not bool(t.any()) for t in sums.buffers())


def test_update_and_combine_are_the_plain_mean_scatter():
    """On the CPU, cbow_update and the combine take the same float
    operations as the gradients followed by mean_scatter on each table, so
    they agree exactly."""
    x = _inputs(3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    tables = [t[k].clone() for k in TABLES]
    sums = SkipGramSums.zeros(60, 16, "cpu")
    loss = cbow_update(*tables, t["walks"], t["negs"], 3, 6.0, sums, t["center_w"])
    skipgram_mean_combine(*tables, sums, 0.05)
    want_loss, (g_in, g_out, g_ob), (g_neg, g_nb) = cbow_grads_plain(
        *(t[k] for k in TABLES), t["walks"], t["negs"], 3, 6.0, t["center_w"])
    flat, negs = t["walks"].reshape(-1), t["negs"].reshape(-1)
    want = [t[k].clone() for k in TABLES]
    mean_scatter(want[0], flat, g_in.reshape(-1, 16), 0.05)
    _, counts = mean_scatter(want[1], (flat, negs),
                             (g_out.reshape(-1, 16), g_neg.reshape(-1, 16)), 0.05)
    mean_scatter(want[2], (flat, negs), (g_ob.reshape(-1), g_nb.reshape(-1)), 0.05,
                 counts=counts)
    assert float(loss) == float(want_loss)
    for got, w in zip(tables, want):
        assert torch.equal(got, w)


def test_cbow_update_raises_off_cpu_and_cuda():
    x = {k: torch.from_numpy(v).to("meta") for k, v in _inputs(2).items()}
    sums = SkipGramSums.zeros(60, 16, "meta")
    with pytest.raises(ValueError, match="meta"):
        cbow_update(*(x[k] for k in TABLES), x["walks"], x["negs"], 3, 6.0, sums)


def test_params_from_jax():
    params = {"node_embedding": np.ones((3, 2), np.float64),
              "output_embedding": np.zeros((3, 2), np.float32),
              "output_bias": np.arange(3, dtype=np.float32)}
    got = cbow_params_from_jax(params, "cpu")
    assert list(got) == list(TABLES)
    assert all(t.dtype == torch.float32 for t in got.values())
    np.testing.assert_array_equal(got["output_bias"].numpy(), [0, 1, 2])
    with pytest.raises(KeyError, match="CBOW"):
        cbow_params_from_jax({"node_embedding": params["node_embedding"]}, "cpu")


# ------------------------------------------------------------------ models
def _community_separation(emb, labels):
    emb = np.asarray(emb, dtype=np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sim = emb @ emb.T
    same = labels[:, None] == labels[None, :]
    off_diag = ~np.eye(len(labels), dtype=bool)
    return sim[same & off_diag].mean() - sim[~same].mean()


def test_embed_graph_cbow_pq_runs(karate):
    g = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx, directed=karate.directed)
    result = embed_graph(g, "Node2Vec CBOW", return_weight=2.0, explore_weight=0.5,
                         device="cpu", smoke_test=True, random_state=0)
    assert [e.shape for e in result.node_embeddings] == [(34, 5), (34, 5)]
    assert result.embedding_method_name == "Node2Vec CBOW"


def test_cbow_pq_separates_planted_blocks():
    """Node2Vec CBOW over p/q walks (p = 0.5, q = 2) on a planted-partition
    graph of four blocks: rows of one block are closer than rows of two."""
    g = planted_partition_edges(200, 1600, n_communities=4, within_fraction=0.95, seed=3)
    labels = np.random.default_rng(3).integers(0, 4, size=200)
    model = CBOW(embedding_size=16, epochs=40, batch_size=64, walk_length=20,
                 window_size=4, iterations=2, learning_rate=0.05,
                 learning_rate_decay=0.99, return_weight=2.0, explore_weight=0.5,
                 random_state=42, early_stopping_patience=10**6,
                 learning_rate_plateau_patience=10**6, device="cpu")
    emb = model.fit_transform(g).get_node_embedding_from_index(0)
    assert np.isfinite(emb).all()
    sep = _community_separation(emb, labels)
    assert sep > 0.1, f"block separation too weak: {sep}"


def test_deepwalk_presets_refuse_pq():
    for cls in (DeepWalkSkipGram, DeepWalkCBOW):
        model = cls(embedding_size=8, random_state=1, device="cpu")
        params = model.parameters()
        assert "return_weight" not in params and "explore_weight" not in params
        assert model._return_weight == model._explore_weight == 1.0
        for kw in (dict(return_weight=2.0), dict(explore_weight=0.5)):
            with pytest.raises(ValueError, match="first-order"):
                cls(random_state=1, device="cpu", **kw)
        assert cls(**params, device="cpu").consistent_hash() == model.consistent_hash()


@pytest.mark.parametrize("name, cls", [
    ("Node2Vec CBOW", CBOW), ("DeepWalk SkipGram", DeepWalkSkipGram),
    ("DeepWalk CBOW", DeepWalkCBOW), ("Node2Vec", Node2Vec),
])
def test_registry_resolves_new_rows(name, cls):
    assert get_model_from_library(name) is cls
    assert get_model_from_library(name.lower(), task_name="Node Embedding") is cls
    assert cls.model_name() == name


@pytest.mark.parametrize("cls, ref_name", [(CBOW, "CBOW"), (SkipGram, "SkipGram"),
                                           (Node2Vec, "Node2Vec")])
def test_parameters_report_pq(cls, ref_name):
    from embiggen_tpu.models.embedders import walk_based as ref_wb

    kw = dict(embedding_size=8, return_weight=2.0, explore_weight=0.5, random_state=5)
    port = cls(device="cpu", **kw)
    params = port.parameters()
    assert params["return_weight"] == 2.0 and params["explore_weight"] == 0.5
    assert params == getattr(ref_wb, ref_name)(**kw).parameters()
    assert cls(**params, device="cpu").parameters() == params


@pytest.mark.parametrize("name", ["Node2Vec CBOW", "Node2Vec SkipGram", "DeepWalk CBOW"])
def test_biased_models_export_the_ell_table(karate, name):
    g = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx)
    cls = get_model_from_library(name)
    kw = {} if name.startswith("DeepWalk") else dict(return_weight=2.0, explore_weight=0.5)
    model = cls(max_neighbours=8, random_state=4, device="cpu", **kw)
    tg = model._device_graph(g)
    if name.startswith("DeepWalk"):
        assert tg.ell_cols is None
    else:
        assert tg.ell_cap == 8
        np.testing.assert_array_equal(tg.ell_cols.numpy(), g.ell_arrays(8, 4)[0])
