"""K6's edge batch and K5's membership on the CPU, as the H100 redesign
left them (the guided search, the arcs' (source, head) records, a fit's
workspace): `graph_to_avoid` held to embiggen_tpu's
`edge_prediction_mini_batch` (the exact law of the draw-and-redraw process
against the graph to avoid, for the port's plain version and the
reference's draws alike), the fit-held workspace (`BatchDraws.edges`)
against the route without one, K5's plain version exactly against
`csr_edge_ids` on rows of every length the search treats apart, and
a GCN fit that draws exactly as without a workspace."""
import jax
import numpy as np
import pytest
import torch

from edge_batch_graphs import LONG_ROWS, held_to_law, membership_graph, membership_queries
from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.ops.negatives import edge_prediction_mini_batch as ref_mini_batch
from embiggen_tpu.ops.walks import csr_edge_ids as ref_csr_edge_ids
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models.gcn import KipfGCNEdgePrediction
from embiggen_tpu_torch.models.gcn import edge as gcn_edge
from embiggen_tpu_torch.models.gcn.core import param_leaves
from embiggen_tpu_torch.ops.negatives import BatchDraws, edge_prediction_mini_batch
from embiggen_tpu_torch.ops.walks import csr_edge_ids, csr_edge_ids_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("avoid_seed", [None, 7])
@pytest.mark.parametrize("scale_free, n_attempts", [(True, 2), (False, 1)])
def test_graph_to_avoid_matches_the_reference(avoid_seed, scale_free, n_attempts):
    """The negatives avoid the arcs of `graph_to_avoid` (a graph of more
    nodes, with other arcs) and loops at the rate of the redraw process, as
    the reference's do; without it, the sampled graph's arcs."""
    g = erdos_renyi(30, 150, seed=2)
    avoid = g if avoid_seed is None else erdos_renyi(34, 200, seed=avoid_seed)
    batch, n_pos = 40000, 20000
    tg = g.device("cpu", with_sources=True)
    src, dst, labels = edge_prediction_mini_batch(
        tg, torch.Generator().manual_seed(5), batch, use_scale_free_distribution=scale_free,
        n_attempts=n_attempts,
        graph_to_avoid=None if avoid_seed is None else avoid.device("cpu"))
    ref = RefGraph(row_ptr=g.row_ptr, col_idx=g.col_idx, directed=False)
    ref_avoid = RefGraph(row_ptr=avoid.row_ptr, col_idx=avoid.col_idx, directed=False)
    want_src, want_dst, want_labels = ref_mini_batch(
        ref.device(with_sources=True), jax.random.PRNGKey(3), batch,
        use_scale_free_distribution=scale_free, n_attempts=n_attempts,
        graph_to_avoid=None if avoid_seed is None else ref_avoid.device())
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    for s, d in ((src.numpy(), dst.numpy()),
                 (np.asarray(want_src), np.asarray(want_dst))):
        held_to_law(s[n_pos:], d[n_pos:], g, avoid, scale_free, n_attempts)


def test_graph_to_avoid_must_number_the_sampled_nodes():
    g = erdos_renyi(30, 150, seed=2)
    with pytest.raises(ValueError, match="fewer"):
        edge_prediction_mini_batch(g.device("cpu", with_sources=True),
                                   torch.Generator().manual_seed(0), 64,
                                   graph_to_avoid=erdos_renyi(20, 50, seed=1).device("cpu"))


@pytest.mark.parametrize("batch, rate, scale_free", [(1001, 0.5, True), (1000, 0.25, False),
                                                     (7, 1.0, True), (9, 0.0, True)])
def test_workspace_route_draws_as_without_one(batch, rate, scale_free):
    """From the same generator, the workspace's batches are the route
    without one's; its block and labels are reused, and the labels are
    written by the first batch only."""
    tg = erdos_renyi(50, 200, seed=1).device("cpu", with_sources=True)
    ws = BatchDraws.edges(batch, rate, "cpu")
    a, b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for step in range(3):
        want = edge_prediction_mini_batch(tg, a, batch, rate, scale_free)
        got = edge_prediction_mini_batch(tg, b, batch, rate, scale_free, workspace=ws)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2][1:], want[2][1:])
        assert got[0].data_ptr() == ws.block.data_ptr()
        assert got[1].data_ptr() == ws.block[1].data_ptr()
        assert got[2].data_ptr() == ws.views[2].data_ptr() and ws.labels_written
        # A label the first batch wrote, changed after it, stays changed:
        # later batches do not write the labels.
        assert float(got[2][0]) == (float(want[2][0]) if step == 0 else 0.5)
        ws.views[2][0] = 0.5
    with pytest.raises(ValueError, match="negatives"):
        edge_prediction_mini_batch(tg, b, batch, 0.5 if rate != 0.5 else 0.25, workspace=ws)


def test_workspace_first_offset_comes_with_its_key():
    """`BatchDraws.edges` takes its key and its first counter offset from
    one draw of the generator (the draw the route without a workspace
    makes), and each later batch the next offset."""
    ws = BatchDraws.edges(64, 0.5, "cpu")
    gen = torch.Generator().manual_seed(9)
    want = torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(9)).tolist()
    assert ws.seed(gen) == (want[0], want[1] & 0xFFFFFFFF)
    assert ws.seed(gen) == (want[0], (want[1] + 1) & 0xFFFFFFFF)


def test_arc_pairs_export():
    """`Graph.device(with_arc_pairs=True)` adds each arc's (source, head)."""
    g = erdos_renyi(50, 200, seed=1)
    tg = g.device("cpu", with_arc_pairs=True)
    np.testing.assert_array_equal(tg.arc_pairs.numpy(), np.stack([g.sources, g.col_idx], 1))
    assert tg.arc_pairs.dtype == torch.int32 and g.device("cpu").arc_pairs is None


@pytest.mark.parametrize("seed", [0, 1])
def test_membership_plain_matches_reference_on_every_row_route(seed):
    """K5's plain version is exact against the reference on empty and short
    rows, rows of about one 32-byte sector either side of its bounds, long
    rows and hubs of 5,000 and 70,000 heads, with repeated heads (the first
    arc of equal heads)."""
    row_ptr, col_idx = membership_graph(seed)
    src, dst = membership_queries(row_ptr, col_idx, seed + 1)
    ids, found = csr_edge_ids(*(torch.from_numpy(a) for a in (row_ptr, col_idx, src, dst)))
    want_ids, want_found = ref_csr_edge_ids(*(jax.numpy.asarray(a)
                                              for a in (row_ptr, col_idx, src, dst)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    # Both routes of the search are reached: a quarter of the queries are
    # arcs, some on each long row.
    assert 0.2 < found.float().mean() < 0.8
    hits = src[found.numpy()]
    assert set(range(100, 100 + len(LONG_ROWS))) <= set(hits.tolist())
    again = csr_edge_ids_plain(*(torch.from_numpy(a) for a in (row_ptr, col_idx, src, dst)))
    assert torch.equal(again[0], ids)


def test_gcn_fit_on_the_cpu_draws_as_without_a_workspace(monkeypatch):
    """A GCN fit passes K6 its workspace, and its parameters are exactly
    those of a fit whose batches are drawn without one (the parent's)."""
    g = erdos_renyi(300, 1500, seed=0)
    feats = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)

    def fit():
        model = KipfGCNEdgePrediction(units=[8], tower_units=[8], head_units=[4], epochs=3,
                                      batch_size=128, random_state=0, device="cpu")
        return model.fit(g, node_features=feats)._params

    draw = gcn_edge.edge_prediction_mini_batch
    seen = []
    monkeypatch.setattr(gcn_edge, "edge_prediction_mini_batch",
                        lambda *a, **kw: seen.append(kw["workspace"]) or draw(*a, **kw))
    got = fit()
    assert len(seen) == 3 * (g.number_of_directed_edges // 128)
    assert all(isinstance(w, BatchDraws) and w is seen[0] for w in seen)
    monkeypatch.setattr(gcn_edge, "edge_prediction_mini_batch",
                        lambda *a, workspace, **kw: draw(*a, **kw))
    want = fit()
    got, want = param_leaves(got), param_leaves(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
