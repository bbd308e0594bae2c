"""The port's KGE rows through their fits on the CPU, the mirror of
tests/test_kge.py: every row trains and ranks positive triples above
corrupted ones (the reference has no KGE quality gate; this is its own
ranking check, with its step sizes and 300 steps), `embed_graph` runs
each row, the embedding-size and ConvE map errors, edge types required,
and the gradients of TorusE's and BoxE's distances at exact ties (rounding
halves, zero differences, points on a box's boundary) equal to the JAX
package's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders import kge as ref_kge
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import karate_club
from embiggen_tpu_torch.models import MODELS_LIBRARY
from embiggen_tpu_torch.models.embedders import (
    KGE_MODELS, BoxE, ConvE, NodePiece, RotatE, TorusE,
)

torch.set_num_threads(1)


def _typed_karate():
    g = karate_club()
    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    return dataclasses.replace(g, edge_types=etypes)


GRAPH = _typed_karate()
# tests/test_kge.py's step sizes: the MLP-scored models need larger steps
# than the shallow bilinear and translation scorers at D 8.
_TEST_LR = {"ERMLP": 0.3, "ERMLPE": 0.2, "ConvE": 0.2}


def _mean_distances(model, params):
    """Mean distance of the graph's triples and of the same heads with
    random tails (numpy seed 3), as tests/test_kge.py measures them."""
    src = torch.from_numpy(GRAPH.sources.astype(np.int32))
    dst = torch.from_numpy(GRAPH.col_idx.astype(np.int32))
    et = torch.from_numpy(GRAPH.edge_types.astype(np.int32))
    rng = np.random.default_rng(3)
    cdst = torch.from_numpy(rng.integers(0, GRAPH.number_of_nodes, len(src), dtype=np.int32))
    pos = model._triple_scores(params, src, dst, et)
    neg = model._triple_scores(params, src, cdst, et)
    return float(pos.mean()), float(neg.mean())


@pytest.mark.parametrize("cls", KGE_MODELS, ids=lambda c: c.model_name())
def test_kge_ranks_positive_triples(cls):
    model = cls(device="cpu", random_state=7, **cls.smoke_test_parameters())
    result = model.fit_transform(GRAPH)
    emb = result.node_embeddings[0]
    assert emb.shape == (GRAPH.number_of_nodes, model.embedding_size)
    assert np.isfinite(emb).all()
    ctx = model._prepare_data(GRAPH)
    gen = torch.Generator().manual_seed(7)
    params = model._init_params(GRAPH, gen)
    lr = _TEST_LR.get(cls.model_name(), 0.1)
    with torch.no_grad():
        for _ in range(300):
            model._step(ctx, params, gen, lr)
        pos, neg = _mean_distances(model, params)
    assert np.isfinite(pos) and np.isfinite(neg)
    assert pos < neg, (cls.model_name(), pos, neg)


def test_embed_graph_runs_every_kge_row():
    for cls in KGE_MODELS:
        result = embed_graph(GRAPH, cls.model_name(), device="cpu", smoke_test=True,
                             random_state=0)
        assert result.embedding_method_name == cls.model_name()
        for emb in result.node_embeddings + (result.edge_type_embeddings or []):
            assert np.isfinite(emb).all()


def test_dim_multiple_validation():
    with pytest.raises(ValueError, match="divisible"):
        RotatE(embedding_size=7, device="cpu")


def test_conve_small_dim_rejected():
    with pytest.raises(ValueError, match="3x3"):
        ConvE(embedding_size=4, device="cpu")


def test_kge_requires_edge_types():
    from embiggen_tpu_torch.models.embedders import DistMult

    with pytest.raises(ValueError, match="edge types"):
        DistMult(device="cpu", **DistMult.smoke_test_parameters()).fit_transform(karate_club())


def test_registry_lists_the_kge_rows():
    names = set(MODELS_LIBRARY["Node Embedding"])
    for name in ("TransR", "TransD", "TransF", "RotatE", "ComplEx", "DistMult", "HolE",
                 "ConvE", "BoxE", "CrossE", "DistMA", "ERMLP", "ERMLPE", "NodePiece",
                 "PairRE", "ProjE", "QuatE", "RESCAL", "TorusE", "TuckER", "AutoSF"):
        assert name in names, name
        assert MODELS_LIBRARY["Node Embedding"][name]["Torch"].requires_edge_types()


def _tie_grads(ref_fn, port_fn, *arrays):
    """The gradients of sum(fn(...)) with respect to every input, JAX's and
    the port's."""
    want = jax.grad(lambda *xs: ref_fn(*xs).sum(), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch.autograd.grad(port_fn(*leaves).sum(), leaves)
    return got, want


def test_toruse_gradient_at_exact_ties():
    """Differences at exact halves (jnp.round and torch.round round half to
    even, so the wrapped value is +-0.5) and at exact zeros (jnp.abs's
    gradient there is +1; torch.abs's would be 0)."""
    h = np.array([[0.5, 1.5, -0.5, 0.25, 2.5, 0.0]], np.float32)
    r = np.array([[0.0, 0.0, 0.0, 0.25, 0.0, 0.75]], np.float32)
    t = np.array([[0.0, 0.0, 0.0, 0.5, 0.0, 0.75]], np.float32)
    ref = ref_kge.TorusE(embedding_size=6)
    port = TorusE(embedding_size=6, device="cpu")
    got, want = _tie_grads(
        lambda h, r, t: ref._distance(h, t, {"edge_type_embedding": r}, {}),
        lambda h, r, t: port._distance(h, t, {"edge_type_embedding": r}, {}), h, r, t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(want[0])[0, [3, 5]], 1.0)


def test_boxe_gradient_at_exact_ties():
    """Points exactly on a box's boundary (|p - c| == w / 2: the inside
    branch, on both sides), at its centre (jnp.abs's gradient +1), and
    inside and outside."""
    raw = np.zeros((1, 5), np.float32)
    w = np.asarray(jax.nn.softplus(jnp.asarray(raw)) + 1e-6, np.float32)
    center = np.array([[0.0, 1.0, -1.0, 0.5, 0.0]], np.float32)
    p = center + np.array([[1, -1, 0, 0.1, 3]], np.float32) * (w / 2)
    assert np.abs(p - center)[0, 0] == (w / 2)[0, 0]
    got, want = _tie_grads(ref_kge.BoxE._point_box_distance, BoxE._point_box_distance,
                           p, center, raw)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6, atol=1e-7)


def test_l1_distance_gradient_at_exact_zeros():
    """jnp.abs's gradient at 0 and -0 is +1 (torch.abs's is 0): the port's
    L1 distance, which Structured Embedding and the L1 norms use, follows
    the reference's."""
    from embiggen_tpu.ops.losses import l1_distance as ref_l1
    from embiggen_tpu_torch.ops.losses import l1_distance

    a = np.array([[0.0, -0.0, 1.0, 2.0]], np.float32)
    b = np.array([[0.0, 0.0, 1.0, 3.0]], np.float32)
    got, want = _tie_grads(ref_l1, l1_distance, a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
