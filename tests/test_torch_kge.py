"""The port's 21 knowledge-graph-embedding rows against embiggen_tpu on the
CPU: for every row, from the reference's initial tables carried across with
`minibatch_params_from_jax` and on the same injected [5, B] block of
triples, the loss of `_batch_updates` and every update's table, rows, mode
and gradient (rtol 1e-5 / atol 1e-6: float sums in another order), and the
tables after one applied step; the initial tables' shapes and draws;
NodePiece's tokens equal to the reference's `_tokenize` exactly, through
K15a's plain version, on undirected and directed graphs and with fewer
reachable anchors than tokens.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.models.embedders import kge as ref_kge
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.models.embedders import KGE_MODELS
from embiggen_tpu_torch.models.embedders.minibatch import apply_updates
from embiggen_tpu_torch.utils.convert import minibatch_params_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ROWS = [cls.model_name() for cls in KGE_MODELS]
PORT = {cls.model_name(): cls for cls in KGE_MODELS}
REF = {cls.model_name(): cls for cls in ref_kge.KGE_MODELS}
# NodePiece's anchors and tokens at the test's size.
NODEPIECE = dict(number_of_anchors=6, tokens_per_node=3)


def _typed(graph, etypes):
    return dataclasses.replace(graph, edge_types=etypes)


@pytest.fixture(scope="module")
def graphs(karate):
    """(port graph, reference graph): karate typed by whether an arc's ends
    are in different clubs."""
    labels = karate.get_single_label_node_type_ids()
    etypes = (labels[karate.sources] != labels[karate.col_idx]).astype(np.int32)
    port = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx, directed=karate.directed,
                 name=karate.name)
    return _typed(port, etypes), _typed(karate, etypes)


def _kwargs(name):
    return dict(embedding_size=8, random_state=0, **(NODEPIECE if name == "NodePiece" else {}))


def _block(rng, n, b=64):
    """[5, B] int32: src, dst, corrupted src and dst over n nodes (many
    repeats), and edge types 0-1."""
    return np.stack([rng.integers(0, n, b) for _ in range(4)] + [rng.integers(0, 2, b)]
                    ).astype(np.int32)


@pytest.mark.parametrize("name", ROWS)
def test_batch_updates_match_reference(graphs, name):
    port_graph, ref_graph = graphs
    ref = REF[name](**_kwargs(name))
    port = PORT[name](device="cpu", **_kwargs(name))
    ref_ctx = ref._prepare_data(ref_graph)
    params = ref._init_params(ref_graph, jnp.zeros(2, jnp.uint32))
    ours = minibatch_params_from_jax({k: np.asarray(v) for k, v in params.items()}, port,
                                     port_graph)
    block = _block(np.random.default_rng(11), port_graph.number_of_nodes)
    b = block.shape[1]
    ref_batch = tuple(jnp.asarray(x) for x in block)
    port_batch = torch.from_numpy(block)
    ref_shared = (ref_ctx["tokens"],) if name == "NodePiece" else ()
    port_shared = tuple(torch.from_numpy(np.array(x)) for x in ref_shared)
    ref_batch = (ref_batch, ref_shared)
    want_loss, want = ref._batch_updates(params, ref_batch, b)
    with torch.no_grad():
        loss, got = port._batch_updates(ours, (port_batch, port_shared), b)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert [(u.name, u.mode) for u in got] == [(u.name, u.mode) for u in want]
    for g, w in zip(got, want):
        if w.idx is None:
            assert g.idx is None
        else:
            np.testing.assert_array_equal(g.idx.numpy(), np.asarray(w.idx))
        assert tuple(g.grad.shape) == tuple(w.grad.shape), g.name
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w.grad), err_msg=f"{name} "
                                   f"{g.name}", **TOL)
    # One applied step: the same tables.
    params = ref_apply_updates(dict(params), want, jnp.float32(0.05))
    apply_updates(ours, got, 0.05)
    for key, table in ours.items():
        np.testing.assert_allclose(table.numpy(), np.asarray(params[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("name", ROWS)
def test_initial_tables_match_reference_shapes(graphs, name):
    """The port's own draws have the reference's tables and shapes, the
    constant ones (zeros, ones, NodePiece's padding token) equal."""
    port_graph, ref_graph = graphs
    want = REF[name](**_kwargs(name))._init_params(ref_graph, jnp.zeros(2, jnp.uint32))
    got = PORT[name](device="cpu", **_kwargs(name))._init_params(
        port_graph, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for key, table in got.items():
        w = np.asarray(want[key])
        assert np.isfinite(table.numpy()).all()
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(table.numpy(), w, err_msg=key)
    if name == "NodePiece":
        np.testing.assert_array_equal(got["anchor_embedding"][-1].numpy(), 0.0)
    if name == "RotatE":
        phases = got["edge_type_embedding"].numpy()
        assert phases.min() >= -np.pi and phases.max() <= np.pi


def _tokens(port_graph, ref_graph, **kw):
    from embiggen_tpu_torch.models.embedders import NodePiece

    got = NodePiece(device="cpu", embedding_size=8, **kw)._tokenize(port_graph)
    want = ref_kge.NodePiece(embedding_size=8, **kw)._tokenize(ref_graph)
    return got.numpy(), want


@pytest.mark.parametrize("kw", [dict(number_of_anchors=5, tokens_per_node=3),
                                dict(number_of_anchors=34, tokens_per_node=8),
                                dict(number_of_anchors=40, tokens_per_node=50)],
                         ids=["5x3", "all-anchors", "more-than-nodes"])
def test_nodepiece_tokens_equal_reference(graphs, kw):
    got, want = _tokens(*graphs, **kw)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("directed", [False, True])
def test_nodepiece_tokens_equal_reference_with_unreached_anchors(directed):
    """Two components, isolated nodes and (directed) one-way arcs: the
    anchors a node cannot be reached from take the padding id, and the
    distances follow the arcs away from each anchor."""
    rng = np.random.default_rng(4)
    src = np.concatenate([rng.integers(0, 20, 60), rng.integers(20, 35, 40)])
    dst = np.concatenate([rng.integers(0, 20, 60), rng.integers(20, 35, 40)])
    port = Graph.from_edge_arrays(src, dst, n_nodes=40, directed=directed)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=40, directed=directed)
    np.testing.assert_array_equal(port.col_idx, ref.col_idx)
    got, want = _tokens(port, ref, number_of_anchors=12, tokens_per_node=6)
    assert (want == 12).any() and (want < 12).any()
    np.testing.assert_array_equal(got, want)


def test_nodepiece_tokens_go_through_k15a(graphs, monkeypatch):
    """The distances are K15a's relaxations (counted by wrapping its
    wrapper): the first unchanged one stops the loop, well before the
    N - 1 the tokenizer allows."""
    from embiggen_tpu_torch.ops import bfs

    calls = []
    original = bfs.min_plus_step

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(bfs, "min_plus_step", counted)
    got, want = _tokens(*graphs, number_of_anchors=5, tokens_per_node=3)
    np.testing.assert_array_equal(got, want)
    assert 2 <= len(calls) <= 8
