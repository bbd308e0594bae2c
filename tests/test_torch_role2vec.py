"""The port's Role2Vec on the CPU against embiggen_tpu: the Weisfeiler-Lehman
roles exactly, three whole steps on injected (words, roles, negative roles)
batches from the same starting tables against the reference's
`_pair_updates` + `apply_updates`, the registry rows, fits, and the port's
registered names against the reference's. Inputs are made with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import random_geometric as ref_random_geometric
from embiggen_tpu.models.embedders.factorization import Role2Vec as RefRole2Vec
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu.models.registry import MODELS_LIBRARY as REF_MODELS_LIBRARY
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, erdos_renyi, random_geometric
from embiggen_tpu_torch.models import MODELS_LIBRARY, get_model_from_library
from embiggen_tpu_torch.models.embedders import Role2Vec
from embiggen_tpu_torch.utils.convert import role2vec_params_from_jax

torch.set_num_threads(1)


def _port_graph(ref_graph):
    return Graph(row_ptr=ref_graph.row_ptr, col_idx=ref_graph.col_idx,
                 directed=ref_graph.directed, name=ref_graph.name)


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("erase", [False, True])
def test_wl_roles_match_reference(karate, iterations, erase):
    kw = dict(weisfeiler_lehman_hashing_iterations=iterations, erase_base_features=erase)
    for ref_graph in (karate, ref_random_geometric(300, radius=0.1, seed=4)):
        want = RefRole2Vec(**kw)._wl_roles(ref_graph)
        got = Role2Vec(device="cpu", **kw)._wl_roles(_port_graph(ref_graph))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_injected_steps_match_reference(karate):
    """Three steps on the same batches from the same tables carried across
    with role2vec_params_from_jax: the loss of each step and both tables
    after it (atol 1e-6)."""
    kw = dict(embedding_size=8, walk_length=10, window_size=2,
              number_of_negative_samples=4, random_state=0)
    ref = RefRole2Vec(**kw)
    params = ref._init_params(karate, jnp.zeros(2, jnp.uint32))
    n_roles = ref._n_roles
    port = Role2Vec(device="cpu", **kw)
    g = _port_graph(karate)
    port._initial_tables(g, torch.Generator().manual_seed(0))
    assert port._n_roles == n_roles
    np.testing.assert_array_equal(port._roles.numpy(), np.asarray(ref._roles))
    ours = role2vec_params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    rng = np.random.default_rng(3)
    for step, lr in enumerate((0.5, 0.4, 0.3)):
        words = rng.integers(0, 34, 60).astype(np.int32)
        roles = rng.integers(0, n_roles, (60, 4)).astype(np.int32)
        neg_roles = rng.integers(0, n_roles, (60, 4)).astype(np.int32)
        loss, updates = ref._pair_updates(params, jnp.asarray(words), jnp.asarray(roles),
                                          jnp.asarray(neg_roles), 60)
        params = ref_apply_updates(dict(params), updates, jnp.float32(lr))
        with torch.no_grad():
            got = port._step(None, ours, torch.Generator(), lr,
                             batch=tuple(map(torch.from_numpy, (words, roles, neg_roles))))
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
        for key in ("node_embedding", "role_embedding"):
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(params[key]), atol=1e-6,
                                       err_msg=f"{key} step {step}")


def test_sampled_pairs_have_the_walks_roles():
    g = erdos_renyi(120, 500, seed=2)
    model = Role2Vec(embedding_size=4, walk_length=8, window_size=2, batch_size=16,
                     number_of_negative_samples=3, random_state=0, device="cpu")
    model._initial_tables(g, torch.Generator().manual_seed(0))
    model._run_batch_size = 16
    words, roles, neg_roles = model._sample_role_pairs(g.device("cpu"),
                                                       torch.Generator().manual_seed(1))
    assert words.shape == (16 * 4,) and roles.shape == (64, 4) and neg_roles.shape == (64, 3)
    assert int(roles.max()) < model._n_roles and int(neg_roles.max()) < model._n_roles
    assert neg_roles.dtype == torch.int32


def test_registry_and_parameters():
    assert get_model_from_library("Role2Vec") is Role2Vec
    assert Role2Vec.model_name() == RefRole2Vec.model_name()
    kw = dict(embedding_size=8, epochs=3, batch_size=32, random_state=5,
              weisfeiler_lehman_hashing_iterations=3, erase_base_features=True)
    port = Role2Vec(device="cpu", **kw)
    assert port.parameters() == RefRole2Vec(**kw).parameters()
    assert port.clone().parameters() == port.parameters()
    assert Role2Vec.smoke_test_parameters() == RefRole2Vec.smoke_test_parameters()


@pytest.mark.parametrize("kw", [{}, dict(return_weight=2.0, explore_weight=0.5)])
def test_fit_transform(kw):
    g = random_geometric(150, radius=0.15, seed=3)
    model = Role2Vec(embedding_size=6, epochs=2, walk_length=10, window_size=2,
                     batch_size=32, random_state=0, device="cpu", **kw)
    result = model.fit_transform(g)
    assert [e.shape for e in result.node_embeddings] == [(150, 6)]
    assert np.isfinite(result.node_embeddings[0]).all() and np.isfinite(model._last_loss)


def test_initial_params_are_used(karate):
    ref = RefRole2Vec(embedding_size=4, random_state=0)
    params = {k: np.asarray(v) for k, v in
              ref._init_params(karate, jnp.zeros(2, jnp.uint32)).items()}
    model = Role2Vec(embedding_size=4, epochs=0, random_state=0, device="cpu",
                     initial_params=role2vec_params_from_jax(params, "cpu"))
    emb = model.fit_transform(_port_graph(karate)).node_embeddings[0]
    np.testing.assert_array_equal(emb, params["node_embedding"])


def test_embed_graph_smoke():
    result = embed_graph(erdos_renyi(60, 240, seed=1), "Role2Vec", smoke_test=True,
                         device="cpu", random_state=0)
    assert result.embedding_method_name == "Role2Vec"
    assert [e.shape for e in result.node_embeddings] == [(60, 5)]


def test_registered_names_are_the_references():
    """The port's 140 (task, model) rows: every row of the reference's
    registry."""
    ours = {(task, name) for task, models in MODELS_LIBRARY.items() for name in models}
    theirs = {(task, name) for task, models in REF_MODELS_LIBRARY.items() for name in models}
    assert len(ours) == 140
    assert ours == theirs, ours ^ theirs
