"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. These need an NVIDIA GPU and nvcc, so they skip on a host
without them; run them there with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from embiggen_tpu_torch.graph import Graph, barabasi_albert, erdos_renyi
from embiggen_tpu_torch.graph.laplacians import kernel_coo
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models.embedders import (
    CBOW, DeepWalkSkipGram, GloVe, SkipGram, WalkletsSkipGram,
)
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, KipfGCNEdgePrediction
from embiggen_tpu_torch.models.gcn.core import TrainLoop, param_leaves
from embiggen_tpu_torch.models.edge_features import HyperSketching
from embiggen_tpu_torch.models.embedders import DegreeSPINE, DegreeWINE, WeightedSPINE
from embiggen_tpu_torch.ops import _build
from embiggen_tpu_torch.ops.bfs import (
    anchor_init_from_sets, min_plus_step, min_plus_step_plain, multi_source_distances,
)
from embiggen_tpu_torch.ops.hll import (
    HOP2_ROUTES, HOP_SPLIT, edge_sketch_features, edge_sketch_features_plain, hop2_route,
    hop_launch, hop_slots, khop_sketches, khop_sketches_of_singletons, khop_sketches_plain,
    singleton_registers, singleton_registers_plain,
)
from embiggen_tpu_torch.ops.cbow import cbow_update, cbow_update_plain
from embiggen_tpu_torch.ops.edge_metrics import (
    HELD, edge_metrics, edge_metrics_plain,
)
from embiggen_tpu_torch.ops.gather_probe import (
    table_gather_sums, tile_gather_sums, tile_gather_sums_plain,
)
from embiggen_tpu_torch.ops.glove import (
    Entries, GloVeStepWorkspace, cooccurrences, cooccurrences_plain, glove_step,
    glove_step_plain, glove_strides,
)
from embiggen_tpu_torch.ops.negatives import (
    BatchDraws, edge_prediction_mini_batch, first_order_batch, line_mini_batch, nce_negatives,
    siamese_mini_batch,
)
from embiggen_tpu_torch.ops.rowplan import row_plan
from embiggen_tpu_torch.ops.scatter import (
    MeanScatterSums, SkipGramSums, mean_scatter, mean_scatter_plain, skipgram_mean_combine,
    skipgram_mean_combine_plain,
)
from embiggen_tpu_torch.ops.skipgram import skipgram_nce_update, skipgram_nce_update_plain
from embiggen_tpu_torch.ops.spmm import (
    COMBINERS, SPLIT, csr_kernel, csr_spmm, csr_spmm_plain, csr_spmm_split_plain, spmm,
)
from embiggen_tpu_torch.ops.walklets import walklets_update, walklets_update_plain
from embiggen_tpu_torch.ops.walks import (
    csr_edge_ids, csr_edge_ids_plain, ell_walks, exact_walks, first_order_walks,
    rejection_walks,
)
from batch_laws import (
    arc_ids, exact_p, line_negative_law_by_source, rows_p, siamese_counts,
)
import glove_checks
from hll_checks import MAX_TIE_SHARE, feature_errors
from pq_laws import (
    Laws, arc_weights, n_tries_for, rows_of_32_and_33, two_hubs, walks_chi2_p,
)
from walk_batch_laws import batch_counts, batch_p, stream_independence_p, two_sample_p
from edge_batch_graphs import held_to_law, membership_graph, membership_queries

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _skipgram_inputs(dev, n, d, b, length, k, with_center_w, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        tables=(t((0.3 * rng.normal(size=(n, d))).astype(np.float32)),
                t((0.3 * rng.normal(size=(n, d))).astype(np.float32)),
                t((4.0 * rng.normal(size=n)).astype(np.float32))),
        walks=t(rng.integers(0, n, (b, length)).astype(np.int32)),
        negs=t(rng.integers(0, n, (b, k)).astype(np.int32)),
        center_w=(t(rng.uniform(0, 2, (b, length)).astype(np.float32))
                  if with_center_w else None))


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("d, length, window, k", [(48, 20, 4, 7), (30, 12, 3, 5)])
def test_skipgram_kernel_matches_plain(dev, with_center_w, d, length, window, k):
    """K3's sums and counts against its plain version's (autograd gradients
    added with index_add_)."""
    x = _skipgram_inputs(dev, 300, d, 40, length, k, with_center_w)
    args = (*x["tables"], x["walks"], x["negs"], window, 6.0)
    sums, want_sums = SkipGramSums.zeros(300, d, dev), SkipGramSums.zeros(300, d, dev)
    before = _build.launch_counts()["skipgram_nce_update"]
    loss = skipgram_nce_update(*args, sums, x["center_w"])
    want_loss = skipgram_nce_update_plain(*args, want_sums, x["center_w"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["skipgram_nce_update"] == before + 1
    # The sums run in another order than autograd's and the atomics'.
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-5)
    for a, w in zip(sums.buffers(), want_sums.buffers()):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("d", [30, 16])
def test_skipgram_update_and_combine_match_plain(dev, with_center_w, d):
    """Few nodes, so every node recurs in many walks and negatives and the
    atomics collide."""
    n = 60
    x = _skipgram_inputs(dev, n, d, 64, 12, 5, with_center_w, seed=d)
    args = (x["walks"], x["negs"], 3, 6.0)
    sums, want_sums = SkipGramSums.zeros(n, d, dev), SkipGramSums.zeros(n, d, dev)
    before = _build.launch_counts()
    loss = skipgram_nce_update(*x["tables"], *args, sums, x["center_w"])
    want_loss = skipgram_nce_update_plain(*x["tables"], *args, want_sums, x["center_w"])
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-5)
    # Counts add 1.0s: exact in any order. Sums: atomics add in no fixed
    # order, so they match to rounding.
    torch.testing.assert_close(sums.counts_w, want_sums.counts_w, rtol=0, atol=0)
    torch.testing.assert_close(sums.counts_c, want_sums.counts_c, rtol=0, atol=0)
    for field in ("sums_w", "sums_c", "sums_b"):
        torch.testing.assert_close(getattr(sums, field), getattr(want_sums, field),
                                   rtol=1e-5, atol=1e-5)
    got_t = [t.clone() for t in x["tables"]]
    want_t = [t.clone() for t in x["tables"]]
    skipgram_mean_combine(*got_t, sums, 0.05)
    skipgram_mean_combine_plain(*want_t, want_sums, 0.05)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["skipgram_nce_update"] == before["skipgram_nce_update"] + 1
    assert after["skipgram_mean_combine"] == before["skipgram_mean_combine"] + 1
    for a, w in zip(got_t, want_t):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    # The combine leaves the sums and counts zero for the next step.
    for t in sums.buffers():
        assert not bool(t.any())


def test_skipgram_step_launches_update_and_combine(dev):
    g = erdos_renyi(500, 3000, seed=3)
    model = SkipGram(device=dev, embedding_size=16, walk_length=12, window_size=3,
                     batch_size=64, random_state=0)
    tg = model._device_graph(g)
    model._run_batch_size = model._resolve_batch(g)
    params = model._init_params(g, torch.Generator().manual_seed(0))
    sums = model._new_sums(params)
    before = _build.launch_counts()
    with torch.no_grad():
        model._step(tg, params, torch.Generator().manual_seed(1), 0.05, sums=sums)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in (
        "skipgram_nce_update", "skipgram_mean_combine", "mean_scatter", "mean_combine")} == {
            "skipgram_nce_update": 1, "skipgram_mean_combine": 1, "mean_scatter": 0,
            "mean_combine": 0}
    assert all(not bool(t.any()) for t in sums.buffers())


@pytest.mark.parametrize("width", [None, 1, 16, 30, 128])
def test_mean_scatter_kernel_matches_plain(dev, width):
    rng = np.random.default_rng(1)
    n = 500
    shape = (n,) if width is None else (n, width)
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    idx = tuple(torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(dev)
                for m in (900, 200))
    grads = tuple(torch.from_numpy(
        rng.normal(size=(i.numel(),) + shape[1:]).astype(np.float32)).to(dev)
        for i in idx)
    before = _build.launch_counts()
    got, counts = mean_scatter(table.clone(), idx, grads, 0.05)
    want, want_counts = mean_scatter_plain(table.clone(), idx, grads, 0.05)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["mean_scatter"] - before["mean_scatter"] == 2
    assert after["mean_combine"] - before["mean_combine"] == 1
    torch.testing.assert_close(counts, want_counts, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # A second table updated with the counts of the first call, which it
    # leaves as they were.
    shared = counts.clone()
    got, kept = mean_scatter(table.clone(), idx, grads, 0.05, counts)
    want, _ = mean_scatter_plain(table.clone(), idx, grads, 0.05, counts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert kept is counts and torch.equal(counts, shared)


def _mean_scatter_segments(rng, n, shape, dev):
    """Two segments: rows [0, 300) and [200, n), so some rows are touched by
    one segment only and some by both."""
    idx = tuple(torch.from_numpy(rng.integers(lo, hi, m).astype(np.int32)).to(dev)
                for lo, hi, m in ((0, 300, 900), (200, n, 400)))
    grads = tuple(torch.from_numpy(
        rng.normal(size=(i.numel(),) + shape[1:]).astype(np.float32)).to(dev) for i in idx)
    return idx, grads


@pytest.mark.parametrize("width", [None, 1, 30, 128])
def test_mean_scatter_workspace_over_consecutive_calls(dev, width):
    """Three steps on one workspace against the plain version: the counts
    exact (a call without the workspace returns them), the sums and counts
    all zero after each combine, the counts passed in left alone."""
    rng = np.random.default_rng(4)
    n = 700
    shape = (n,) if width is None else (n, width)
    ws = MeanScatterSums.zeros(shape, dev)
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    want = table.clone()
    for lr in (0.05, 0.04, 0.03):
        idx, grads = _mean_scatter_segments(rng, n, shape, dev)
        before = _build.launch_counts()
        _, counts = mean_scatter(table, idx, grads, lr, workspace=ws)
        _, want_counts = mean_scatter_plain(want, idx, grads, lr)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert after["mean_scatter"] - before["mean_scatter"] == 2
        assert after["mean_combine"] - before["mean_combine"] == 1
        assert counts is None
        torch.testing.assert_close(table, want, rtol=0, atol=1e-5)
        assert not ws.sums.any() and not ws.counts.any()
        _, fresh = mean_scatter(table.clone(), idx, grads, lr)
        torch.testing.assert_close(fresh, want_counts, rtol=0, atol=0)
        shared = fresh.clone()
        got, kept = mean_scatter(table.clone(), idx, grads, lr, fresh, workspace=ws)
        ref, _ = mean_scatter_plain(table.clone(), idx, grads, lr, fresh)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
        assert kept is fresh and torch.equal(fresh, shared)
        assert not ws.sums.any() and not ws.counts.any()


@pytest.mark.parametrize("with_workspace", [False, True])
def test_mean_scatter_kernel_skips_rows_the_given_counts_leave_out(dev, with_workspace):
    """Counts that miss rows of the multiset: the plain version refuses
    them, the kernel leaves those rows as they were and steps the others as
    the plain version does with whole counts. On a workspace, the dropped
    rows' sums stay in it and every other row's are zero again."""
    rng = np.random.default_rng(6)
    n, d = 700, 30
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    idx, grads = _mean_scatter_segments(rng, n, (n, d), dev)
    _, whole = mean_scatter_plain(table.clone(), idx, grads, 0.05)
    dropped = torch.unique(idx[0])[::3].long()
    partial = whole.clone()
    partial[dropped] = 0.0
    with pytest.raises(ValueError, match="every row"):
        mean_scatter_plain(table.clone(), idx, grads, 0.05, partial)
    want, _ = mean_scatter_plain(table.clone(), idx, grads, 0.05, whole)
    want[dropped] = table[dropped]
    ws = MeanScatterSums.zeros((n, d), dev) if with_workspace else None
    got, kept = mean_scatter(table.clone(), idx, grads, 0.05, partial, workspace=ws)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert kept is partial
    if with_workspace:
        total = torch.zeros((n, d), device=dev)
        for s, g in zip(idx, grads):
            total.index_add_(0, s.long(), g)
        torch.testing.assert_close(ws.sums[dropped], total[dropped], rtol=1e-5, atol=1e-6)
        left = torch.ones(n, dtype=torch.bool, device=dev)
        left[dropped] = False
        assert not ws.sums[left].any() and not ws.counts.any()


def test_mean_scatter_kernel_at_an_odd_storage_offset(dev):
    """A table and gradients whose rows are not 16-byte aligned (views one
    float into their buffers) take the scalar paths and match the plain
    version."""
    rng = np.random.default_rng(5)
    n, d = 700, 128
    table = torch.randn(n * d + 1, device=dev)[1:].view(n, d)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    idx, grads = _mean_scatter_segments(rng, n, (n, d), dev)
    grads = tuple(torch.cat([torch.zeros(1, device=dev), g.reshape(-1)])[1:].view(g.shape)
                  for g in grads)
    assert all(g.data_ptr() % 16 != 0 for g in grads)
    ws = MeanScatterSums.zeros((n, d), dev)
    want, _ = mean_scatter_plain(table.clone(), idx, grads, 0.05)
    mean_scatter(table, idx, grads, 0.05, workspace=ws)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, want, rtol=0, atol=1e-5)
    assert not ws.sums.any() and not ws.counts.any()


def test_samplers_stay_on_the_graph(dev):
    g = erdos_renyi(400, 1200, seed=2, weighted=True)
    tg = g.device(dev, with_alias=True)
    gen = torch.Generator().manual_seed(0)
    starts = nce_negatives(tg, gen, (2000,), scale_free=False)
    walks = first_order_walks(tg, starts, 16, gen).cpu().numpy().astype(np.int64)
    assert (walks[:, 0] == starts.cpu().numpy()).all()
    src, dst = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    keys = g.sources.astype(np.int64) * 400 + g.col_idx
    moved = g.degrees[src] > 0
    assert (dst[~moved] == src[~moved]).all()
    assert np.isin(src[moved] * 400 + dst[moved], keys).all()
    negs = nce_negatives(tg, gen, (2000, 10)).cpu().numpy()
    assert (g.degrees[negs] > 0).all()


def _failed(p):
    return {k: v for k, v in p.items() if not v > 1e-3}


@pytest.mark.parametrize("kind", ["rows", "records", "weighted"])
@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("iterations", [1, 3])
def test_first_order_batch_kernel_matches_its_laws(dev, kind, scale_free, iterations):
    """The fused launch, reading row_ptr, the arcs' records or the alias
    tables: starts uniform and tiled over the iterations, every move an arc
    by the exact transitions, negatives by degree or uniform, and,
    unweighted, a walker's start, first step and negatives independent
    (`tests/walk_batch_laws.py`); and in law the plain version's batch."""
    weighted = kind == "weighted"
    g = erdos_renyi(300, 1500, seed=4, weighted=weighted)
    b = 24000 // iterations
    on_card = g.device(dev, with_alias=weighted, with_walk_arcs=kind == "records")
    assert (on_card.walk_arcs is not None) == (kind == "records")
    batch = first_order_batch(on_card, torch.Generator().manual_seed(2), b, iterations, 12, 7,
                              scale_free)
    torch.cuda.synchronize()
    tg = g.device("cpu", with_alias=weighted)
    walks, negs = (t.cpu() for t in batch)
    plain = first_order_batch(tg, torch.Generator().manual_seed(3), b, iterations, 12, 7,
                              scale_free)
    p = batch_p(tg, walks, negs, b, scale_free)
    if not weighted:
        p.update(stream_independence_p(tg, walks, negs, b, scale_free))
    p.update({f"{k} against plain": v for k, v in two_sample_p(
        batch_counts(tg, walks, negs, b), batch_counts(tg, *plain, b)).items()})
    assert not _failed(p), p


@pytest.mark.parametrize("records", [False, True])
@pytest.mark.parametrize("walk_length, k", [(1, 5), (2, 9), (5, 0), (300, 3)])
def test_first_order_batch_kernel_short_and_long_walks(dev, records, walk_length, k):
    """Negatives past the walk's steps (L 1 and 2), none, and long walks,
    for the fused launch and K1 alone, on row_ptr and on the arcs' records;
    a graph with zero-degree nodes keeps their walkers."""
    er = erdos_renyi(300, 1500, seed=4)
    g = Graph.from_edge_arrays(er.sources, er.col_idx, n_nodes=320, directed=True)
    tg, cpu = g.device(dev, with_walk_arcs=records), g.device("cpu")
    walks, negs = first_order_batch(tg, torch.Generator().manual_seed(5), 12000, 1,
                                    walk_length, k, True)
    assert walks.shape == (12000, walk_length) and negs.shape == (12000, k)
    p = batch_p(cpu, walks.cpu(), negs.cpu(), 12000, True)
    starts = (torch.arange(32000, device=dev) % 320).int()
    alone = first_order_walks(tg, starts, walk_length, torch.Generator().manual_seed(6))
    assert torch.equal(alone[:, 0], starts)
    if walk_length > 1:
        p.update({f"K1 {key}": v for key, v in batch_p(
            cpu, alone.cpu(), negs[:0].cpu(), 32000, True).items() if key == "moves"})
    assert not _failed(p), p


@pytest.mark.parametrize("walk_length, k", [(12, 7), (1, 3), (2, 9)])
def test_first_order_kernels_walk_on_records_as_on_rows(dev, walk_length, k):
    """The arcs' records hold each arc's head and the head's row: K1 and the
    fused batch read them in place of row_ptr and draw the same batch, draw
    for draw, from the same key (zero-degree nodes included)."""
    er = erdos_renyi(300, 1500, seed=4)
    g = Graph.from_edge_arrays(er.sources, er.col_idx, n_nodes=320, directed=True)
    rows, records = g.device(dev), g.device(dev, with_walk_arcs=True)
    for scale_free in (True, False):
        a, b = (first_order_batch(t, torch.Generator().manual_seed(9), 700, 3, walk_length, k,
                                  scale_free) for t in (rows, records))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    starts = (torch.arange(5000, device=dev) % 320).int()
    a, b = (first_order_walks(t, starts, walk_length, torch.Generator().manual_seed(10))
            for t in (rows, records))
    assert torch.equal(a, b)


def test_first_order_batch_workspace_key_and_offsets(dev):
    """A fit's workspace: the key is drawn once, each launch takes the next
    offset (so consecutive batches differ), and the same key and offset
    give the same batch."""
    tg = erdos_renyi(300, 1500, seed=4).device(dev)
    gen = torch.Generator().manual_seed(0)
    ws = BatchDraws.walks(500, 2, 10, 5, dev)

    def batch(workspace):
        return [t.clone() for t in first_order_batch(tg, gen, 500, 2, 10, 5, True, workspace)]
    first = batch(ws)
    state = gen.get_state()
    second = batch(ws)
    assert torch.equal(gen.get_state(), state) and ws.offset == 2
    assert not torch.equal(first[0], second[0]) and not torch.equal(first[1], second[1])
    again = BatchDraws.walks(500, 2, 10, 5, dev)
    again.key, again.offset = ws.key, 1
    for got, want in zip(batch(again), second):
        assert torch.equal(got, want)
    starts = nce_negatives(tg, gen, (500,), False, ws, ws.views[2])
    assert starts.data_ptr() == ws.views[2].data_ptr() and ws.offset == 3


def _fit_draws(monkeypatch, model, graph):
    """(launch counts, `_build.draw_seed` calls) of a fit."""
    calls = []
    draw_seed = _build.draw_seed
    monkeypatch.setattr(_build, "draw_seed", lambda g: calls.append(1) or draw_seed(g))
    before = _build.launch_counts()
    model.fit_transform(graph)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    return {k: after[k] - before[k] for k in after}, len(calls)


@pytest.mark.parametrize("cls", [SkipGram, DeepWalkSkipGram, WalkletsSkipGram, CBOW])
def test_walk_fits_draw_each_batch_in_one_launch(dev, monkeypatch, cls):
    """A first-order fit launches the fused batch once a step and neither K1
    nor K2, under one key drawn from the fit's generator."""
    g = erdos_renyi(500, 3000, seed=3)
    model = cls(device=dev, embedding_size=16, epochs=2, walk_length=12, window_size=3,
                batch_size=64, random_state=0, early_stopping_patience=10)
    launched, seeds = _fit_draws(monkeypatch, model, g)
    assert launched["first_order_batch"] == 2 * (500 // 64)
    assert launched["first_order_walks"] == launched["nce_negatives"] == 0
    assert seeds == 1 and model._draws is None


def test_biased_and_glove_steps_draw_k2_at_the_fit_key(dev, monkeypatch):
    """The p/q step's starts and negatives and GloVe's ids are K2 launches
    at the fit's key: no key is drawn a launch but for the walk kernels'
    own (K9 a step; K1 once for GloVe's corpus)."""
    g = erdos_renyi(500, 3000, seed=3)
    pq = SkipGram(device=dev, embedding_size=16, epochs=1, walk_length=12, window_size=3,
                  batch_size=64, random_state=0, return_weight=2.0, explore_weight=0.5)
    launched, seeds = _fit_draws(monkeypatch, pq, g)
    steps = 500 // 64
    assert launched["nce_negatives"] == 2 * steps and launched["ell_walks"] == steps
    assert launched["first_order_batch"] == 0 and seeds == 1 + steps
    glove = GloVe(device=dev, embedding_size=16, epochs=1, batch_size=256, random_state=0)
    launched, seeds = _fit_draws(monkeypatch, glove, g)
    assert launched["nce_negatives"] >= 2 and launched["first_order_walks"] == 1
    assert seeds == 2


def test_fit_on_cuda_is_reproducible_and_finite(dev):
    g = erdos_renyi(500, 3000, seed=3)
    kw = dict(device=dev, embedding_size=16, epochs=2, walk_length=16,
              window_size=3, batch_size=64, random_state=0)
    a = SkipGram(**kw).fit_transform(g).node_embeddings[0]
    b = SkipGram(**kw).fit_transform(g).node_embeddings[0]
    assert a.shape == (500, 16) and np.isfinite(a).all()
    # Float atomics add in no fixed order: equal up to rounding.
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_csr_edge_ids_kernel_matches_plain(dev):
    g = erdos_renyi(500, 3000, seed=4)
    tg = g.device(dev)
    rng = np.random.default_rng(2)
    src = np.concatenate([g.sources[::2], rng.integers(0, 500, 4000)]).astype(np.int32)
    dst = np.concatenate([g.col_idx[::2], rng.integers(0, 500, 4000)]).astype(np.int32)
    s, d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    ids, found = csr_edge_ids(tg.row_ptr, tg.col_idx, s, d)
    want_ids, want_found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, s, d)
    assert torch.equal(ids, want_ids) and torch.equal(found, want_found)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("offset", [0, 1])
def test_csr_edge_ids_kernel_on_every_row_route(dev, seed, offset):
    """K5's group search exactly against its plain version on empty and
    short rows, rows either side of one sweep at every alignment, rows of
    one and two narrowings, repeated heads; `offset` 1 stores col_idx,
    src and dst one int32 into their storage (unaligned 16-byte chunks)."""
    row_ptr, col_idx = membership_graph(seed)
    src, dst = membership_queries(row_ptr, col_idx, seed + 1)

    def put(a):
        buf = torch.zeros(len(a) + offset, dtype=torch.int32, device=dev)
        buf[offset:] = torch.from_numpy(a).to(dev)
        return buf[offset:]
    rp, ci, s, d = torch.from_numpy(row_ptr).to(dev), put(col_idx), put(src), put(dst)
    ids, found = csr_edge_ids(rp, ci, s, d)
    want_ids, want_found = csr_edge_ids_plain(rp, ci, s, d)
    assert torch.equal(ids, want_ids) and torch.equal(found, want_found)
    assert bool(found.any()) and not bool(found.all())
    assert torch.equal(csr_edge_ids(rp, ci, s, d, with_ids=False)[1], want_found)


def test_edge_batch_workspace_key_and_offsets(dev):
    """K6 on a fit's workspace: its first batch is the batch drawn without
    one from the same generator (the key and offset of one draw), later
    batches take the next offsets (so consecutive batches differ) without
    drawing again, the same key and offset give the same batch, and the
    labels are written once."""
    tg = erdos_renyi(400, 2000, seed=5).device(dev, with_sources=True)
    ws = BatchDraws.edges(20001, 0.5, dev)
    gen = torch.Generator().manual_seed(0)
    want = edge_prediction_mini_batch(tg, torch.Generator().manual_seed(0), 20001)

    def batch(workspace):
        return [t.clone() for t in edge_prediction_mini_batch(tg, gen, 20001,
                                                              workspace=workspace)]
    first = batch(ws)
    state = gen.get_state()
    for got, w in zip(first, want):
        assert torch.equal(got, w)
    second = batch(ws)
    assert torch.equal(gen.get_state(), state) and ws.labels_written
    assert not torch.equal(first[0], second[0]) and not torch.equal(first[1], second[1])
    again = BatchDraws.edges(20001, 0.5, dev)
    again.key, again.offset = ws.key, ws.offset - 1
    for got, w in zip(batch(again), second):
        assert torch.equal(got, w)
    # The positives read from the (source, head) records as from the arrays.
    paired = erdos_renyi(400, 2000, seed=5).device(dev, with_sources=True, with_arc_pairs=True)
    assert torch.equal(paired.arc_pairs, torch.stack([tg.sources, tg.col_idx], 1))
    again.offset = ws.offset - 1
    for got, w in zip(edge_prediction_mini_batch(paired, gen, 20001, workspace=again), second):
        assert torch.equal(got, w)
    ws.views[2].fill_(7.0)
    assert bool((batch(ws)[2] == 7.0).all())


@pytest.mark.parametrize("avoid_seed, pairs", [(None, True), (None, False), (7, True)])
@pytest.mark.parametrize("scale_free, n_attempts", [(True, 2), (False, 1)])
def test_edge_batch_kernel_matches_its_law(dev, avoid_seed, pairs, scale_free, n_attempts):
    """K6's negatives follow the exact law of the draw-and-redraw process
    against `graph_to_avoid` (default: the sampled graph), as on the CPU
    (tests/test_torch_edge_batch.py); its positives are arcs, read from the
    (source, head) records or the two arrays."""
    g = erdos_renyi(30, 150, seed=2)
    avoid = g if avoid_seed is None else erdos_renyi(34, 200, seed=avoid_seed)
    tg = g.device(dev, with_sources=True, with_arc_pairs=pairs)
    batch, n_pos = 40000, 20000
    src, dst, labels = edge_prediction_mini_batch(
        tg, torch.Generator().manual_seed(5), batch, use_scale_free_distribution=scale_free,
        n_attempts=n_attempts, graph_to_avoid=None if avoid_seed is None else avoid.device(dev))
    assert int(labels.sum()) == n_pos and bool((labels[:n_pos] == 1).all())
    assert bool(csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src[:n_pos], dst[:n_pos])[1].all())
    held_to_law(src[n_pos:].cpu().numpy(), dst[n_pos:].cpu().numpy(), g, avoid, scale_free,
                n_attempts)


def test_edge_batch_kernel_on_hub_rows(dev):
    """K6's redraw check on rows that take the group search's narrowings
    (an undirected graph over `membership_graph`'s arcs, whose hubs are
    scale-free sources at their degree's rate): the negatives kept as arcs
    or loops occur at the rate beta^(n_attempts + 1) of the redraw
    process, beta the chance that a drawn pair is one."""
    from scipy.stats import binomtest

    row_ptr, col_idx = membership_graph(0, n_nodes=80_000)
    sources = np.repeat(np.arange(80_000), np.diff(row_ptr))
    g = Graph.from_edge_arrays(sources, col_idx, n_nodes=80_000)
    tg = g.device(dev, with_sources=True)
    batch, n_pos = 1 << 18, 1 << 17
    src, dst, _ = edge_prediction_mini_batch(tg, torch.Generator().manual_seed(3), batch,
                                             n_attempts=1)
    p = g.degrees / g.degrees.sum()
    off = g.sources != g.col_idx
    beta = float((p[g.sources[off]] * p[g.col_idx[off]]).sum() + (p ** 2).sum())
    _, is_arc = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src[n_pos:], dst[n_pos:])
    bad = int((is_arc | (src[n_pos:] == dst[n_pos:])).sum())
    assert binomtest(bad, batch - n_pos, beta ** 2).pvalue > 1e-3
    hubs = torch.from_numpy(g.degrees > 64).to(dev)
    assert float(hubs[src[n_pos:].long()].float().mean()) > 0.3
    assert bool(csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src[:n_pos], dst[:n_pos])[1].all())


def test_gcn_fit_draws_its_batches_under_one_key(dev, monkeypatch):
    """A GCN fit launches K6 once a step on its workspace, under one key
    drawn from the fit's generator."""
    g = erdos_renyi(500, 3000, seed=3)
    feats = np.random.default_rng(0).normal(size=(500, 16)).astype(np.float32)
    model = KipfGCNEdgePrediction(units=[16], epochs=2, batch_size=512, device=dev,
                                  random_state=0)
    calls = []
    draw_seed = _build.draw_seed
    monkeypatch.setattr(_build, "draw_seed", lambda gen: calls.append(1) or draw_seed(gen))
    before = _build.launch_counts()
    model.fit(g, node_features=feats)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["edge_prediction_mini_batch"] - before["edge_prediction_mini_batch"] == (
        2 * (g.number_of_directed_edges // 512))
    assert len(calls) == 1


@pytest.mark.parametrize("scale_free", [True, False])
def test_edge_mini_batch_kernel_draws_valid_batches(dev, scale_free):
    g = erdos_renyi(400, 2000, seed=5)
    tg = g.device(dev, with_sources=True)
    src, dst, labels = edge_prediction_mini_batch(
        tg, torch.Generator().manual_seed(0), 20001,
        use_scale_free_distribution=scale_free)
    n_pos = 20001 - 10000
    assert torch.equal(labels, torch.cat([torch.ones(n_pos, device=dev),
                                          torch.zeros(10000, device=dev)]))
    _, is_arc = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst)
    assert bool(is_arc[:n_pos].all())
    # Residual arcs or loops after two redraws: about (2.5%)^3 of negatives.
    assert int((is_arc[n_pos:] | (src[n_pos:] == dst[n_pos:])).sum()) <= 3
    if scale_free:
        assert bool((tg.degrees[src.long()] > 0).all())


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("width", [32, 30])
def test_spmm_kernel_matches_plain(dev, combiner, width):
    g = erdos_renyi(600, 5000, seed=6, weighted=True)
    rows, cols, vals = kernel_coo(g, "Transposed Weighted Left Normalized Laplacian")
    k = csr_kernel(rows, cols, vals, 600, device=dev)
    x = torch.randn(600, width, device=dev, requires_grad=True)
    y = spmm(k, x, combiner)
    g_out = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g_out)
    inv = k.inverse_denominator(combiner)
    torch.testing.assert_close(y, csr_spmm_plain(k, x.detach(), inv), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        dx, csr_spmm_plain(k.transpose, g_out, None, inv), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("width", [128, 64, 30])
def test_spmm_kernel_matches_plain_at_200k_nodes(dev, combiner, width):
    """A graph whose [N, D] input is twice the L2 at D 128."""
    g = erdos_renyi(200_000, 1_000_000, seed=7)
    rows, cols, vals = kernel_coo(g, "Symmetric Normalized Laplacian")
    k = csr_kernel(rows, cols, vals, 200_000, device=dev)
    x = torch.randn(200_000, width, device=dev, requires_grad=True)
    before = _build.launch_counts()["spmm"]
    y = spmm(k, x, combiner)
    g_out = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g_out)
    torch.cuda.synchronize()
    assert _build.launch_counts()["spmm"] == before + 2
    inv = k.inverse_denominator(combiner)
    torch.testing.assert_close(y, csr_spmm_plain(k, x.detach(), inv), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        dx, csr_spmm_plain(k.transpose, g_out, None, inv), rtol=1e-5, atol=1e-5)


def test_spmm_kernel_at_an_odd_storage_offset(dev):
    """A contiguous x whose rows are not 16-byte aligned (a view one float
    into its buffer) takes the scalar path and matches the plain version."""
    g = erdos_renyi(600, 5000, seed=6, weighted=True)
    k = csr_kernel(*kernel_coo(g, "Symmetric Normalized Laplacian"), 600, device=dev)
    buf = torch.randn(600 * 128 + 1, device=dev)
    x = buf[1:].view(600, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y = spmm(k, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, csr_spmm_plain(k, x), rtol=1e-5, atol=1e-6)


def _hub_graph_200k():
    """erdos_renyi(200,000, 1,000,000) plus 16 hubs of 20,000-60,000 random
    neighbours: rows far longer than K7's and the hop launch's splits."""
    g = erdos_renyi(200_000, 1_000_000, seed=7)
    rng = np.random.default_rng(41)
    n = g.number_of_nodes
    hubs = np.repeat(np.arange(n, n + 16), rng.integers(20_000, 60_000, 16, endpoint=True))
    one = g.sources < g.col_idx
    return Graph.from_edge_arrays(
        np.concatenate([g.sources[one], hubs]),
        np.concatenate([g.col_idx[one], rng.integers(0, n + 16, len(hubs))]),
        n_nodes=n + 16, directed=False)


@pytest.mark.parametrize("combiner", COMBINERS)
@pytest.mark.parametrize("width", [128, 30])
def test_spmm_kernel_splits_hub_rows(dev, combiner, width):
    """K7 on a graph with 16 hubs: the plan cuts the 16 hub rows (and their
    columns, in the transpose) into chunks; forward and backward launch K7
    and its combine once each, match the plain version run in float64 and
    the split route's plain version (rtol 1e-5 / atol 1e-5: sums of up to
    60,000 terms in another order; the float32 plain version's atomic
    order alone is 1.7e-5 off on a hub's row), and two calls give the same
    bits."""
    g = _hub_graph_200k()
    n = g.number_of_nodes
    k = csr_kernel(*kernel_coo(g, "Symmetric Normalized Laplacian"), n, device=dev)
    assert k.plan.n_rows == 16 and k.transpose.plan.n_rows == 16
    assert k.plan.n_chunks == int(((k.plan.chunk_ptr[1:] - k.plan.chunk_ptr[:-1])).sum())
    x = torch.randn(n, width, device=dev, requires_grad=True)
    before = _build.launch_counts()
    y = spmm(k, x, combiner)
    g_out = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g_out)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert {c: after[c] - before[c] for c in ("spmm", "spmm_combine")} == {
        "spmm": 2, "spmm_combine": 2}
    inv = k.inverse_denominator(combiner)
    xd = x.detach()
    torch.testing.assert_close(y, csr_spmm_plain(k, xd.double(), inv).float(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y, csr_spmm_split_plain(k, xd.double(), inv).float(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        dx, csr_spmm_plain(k.transpose, g_out.double(), None, inv).float(),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(spmm(k, xd, combiner), y.detach())
    assert torch.equal(csr_spmm(k.transpose, g_out, None, inv), dx)


@pytest.mark.parametrize("split", [32, 1000, SPLIT])
def test_spmm_kernel_at_other_splits(dev, split):
    """K7 over plans at other splits (many rows split at 32) equals the
    plain version (in float64, as above); a plan without chunks launches no
    combine."""
    g = _hub_graph_200k()
    k = csr_kernel(*kernel_coo(g, "Symmetric Normalized Laplacian"), g.number_of_nodes,
                   device=dev)
    k = dataclasses.replace(k, plan=row_plan(k.row_ptr, split))
    x = torch.randn(g.number_of_nodes, 64, device=dev)
    inv = k.inverse_denominator("mean")
    want = csr_spmm_plain(k, x.double(), inv).float()
    torch.testing.assert_close(csr_spmm(k, x, inv), want, rtol=1e-5, atol=1e-5)
    flat = dataclasses.replace(k, plan=row_plan(k.row_ptr, 10**6))
    before = _build.launch_counts()["spmm_combine"]
    torch.testing.assert_close(csr_spmm(flat, x, inv), want, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert flat.plan.n_chunks == 0 and _build.launch_counts()["spmm_combine"] == before


@pytest.mark.parametrize("precision", [4, 5, 6, 8, 12])
def test_hop_launch_splits_hub_rows(dev, precision):
    """K16a's hop launch on a graph with 16 hubs: each hop launches the hop
    and its merge once, byte for byte the plain hops, at every number of
    neighbour slots the launch takes (8, 4, 2 at precisions 4-6, then 1),
    and through `hop_launch` between strided views too."""
    g = _hub_graph_200k()
    tg = g.device(dev)
    n, m = g.number_of_nodes, 1 << precision
    base = singleton_registers(n, precision, 6, 42, dev)
    before = _build.launch_counts()
    got = khop_sketches(tg, base, 2)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert tg.row_plan(HOP_SPLIT).n_rows == 16
    assert {c: after[c] - before[c] for c in ("khop_sketches", "khop_merge")} == {
        "khop_sketches": 2, "khop_merge": 2}
    want = khop_sketches_plain(tg, base, 2)
    assert torch.equal(got, want)
    assert hop_slots(m) == max(1, 8 >> (precision - 4))
    wide = torch.zeros((n, 3, m), dtype=torch.uint8, device=dev)
    hop_launch(tg, base.data_ptr(), m, wide[:, 1].data_ptr(), 3 * m, m)
    torch.cuda.synchronize()
    assert torch.equal(wide[:, 1], want[:, 0])
    assert not wide[:, 0].any() and not wide[:, 2].any()


@pytest.mark.parametrize("probe, tile", [(tile_gather_sums, 256), (table_gather_sums, 8192)])
def test_gather_probe_kernels_match_plain(dev, probe, tile):
    x = torch.randn(4096, 64, device=dev)
    idx = torch.randint(0, 4096, (5 * tile + 7,), device=dev, dtype=torch.int32)
    torch.testing.assert_close(probe(x, idx), tile_gather_sums_plain(x, idx, tile),
                               rtol=1e-5, atol=1e-3)


def test_gcn_fit_on_cuda_is_finite(dev):
    g = erdos_renyi(500, 3000, seed=3)
    feats = np.random.default_rng(0).normal(size=(500, 16)).astype(np.float32)
    before = _build.launch_counts()
    model = KipfGCNEdgePrediction(units=[16], epochs=2, batch_size=512, device=dev,
                                  random_state=0).fit(g, node_features=feats)
    after = _build.launch_counts()
    assert after["spmm"] > before["spmm"]
    assert after["edge_prediction_mini_batch"] > before["edge_prediction_mini_batch"]
    assert np.isfinite(model.predict_proba(g)).all()


def test_perceptron_graphed_epochs_match_the_cpu(dev):
    """On the card the SGD steps replay captured CUDA graphs (with an eager
    remainder); on the same minibatches they must give the CPU's fit."""
    g = erdos_renyi(2000, 20000, seed=1)
    feats = np.random.default_rng(0).normal(size=(2000, 8)).astype(np.float32)
    kw = dict(edge_features=["Degree"], edge_embeddings=["CosineSimilarity"],
              number_of_epochs=2, number_of_edges_per_mini_batch=128, random_state=0)
    fitted = {}
    for device in (dev, torch.device("cpu")):
        model = PerceptronEdgePrediction(device=device, **kw)
        model._epoch_indices = lambda gen, epoch, n, steps, batch, device=device: (
            torch.from_numpy(np.random.default_rng(epoch).integers(0, n, (steps, batch)))
            .to(device))
        fitted[device.type] = model.fit(g, node_features=feats)
    for key in ("w", "b", "mean", "std"):
        torch.testing.assert_close(fitted["cuda"]._linear[key].cpu(),
                                   fitted["cpu"]._linear[key], rtol=1e-4, atol=1e-5)
    assert abs(fitted["cuda"]._last_loss - fitted["cpu"]._last_loss) < 1e-5


def _multigraph():
    """Duplicate arcs and self-loops, sorted rows, and isolated nodes."""
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 40, 600), rng.integers(0, 40, 600)
    order = np.lexsort((dst, src))
    counts = np.bincount(src, minlength=45)
    return Graph(row_ptr=np.concatenate([[0], np.cumsum(counts)]),
                 col_idx=dst[order].astype(np.int32), directed=True)


@pytest.mark.parametrize("which", ["erdos_renyi", "barabasi_albert", "multigraph"])
@pytest.mark.parametrize("cap", [4, 128])
def test_edge_metrics_kernel_matches_plain(dev, which, cap):
    g = {"erdos_renyi": lambda: erdos_renyi(500, 3000, seed=4),
         "barabasi_albert": lambda: barabasi_albert(3000, 6, seed=1),
         "multigraph": _multigraph}[which]()
    tg = g.device(dev)
    n = g.number_of_nodes
    rng = np.random.default_rng(5)
    arcs = rng.integers(0, g.number_of_directed_edges, 3000)
    hubs = np.argsort(-g.degrees)[:20]
    src = np.concatenate([g.sources[arcs], rng.integers(0, n, 3000), rng.choice(hubs, 400)])
    dst = np.concatenate([g.col_idx[arcs], rng.integers(0, n, 3000), rng.choice(hubs, 400)])
    s = torch.from_numpy(src.astype(np.int32)).to(dev)
    d = torch.from_numpy(dst.astype(np.int32)).to(dev)
    before = _build.launch_counts()["edge_metrics"]
    got = edge_metrics(tg, s, d, cap=cap)
    want = edge_metrics_plain(tg, s, d, cap=cap)
    torch.cuda.synchronize()
    assert _build.launch_counts()["edge_metrics"] == before + 1
    # Jaccard and preferential attachment take the same float operations
    # on the same integers; the sums of AA and RA run in another order.
    torch.testing.assert_close(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=0, atol=0)
    torch.testing.assert_close(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5, atol=1e-6)


def _k8_spread_graph():
    """A multigraph (duplicate arcs, self-loops, sorted rows) whose rows run
    from 0 to 900 ids: most about 20, 60 of them 100-900, so other rows fall
    on both sides of K8's register capacity (HELD = 64 ids)."""
    rng = np.random.default_rng(9)
    n = 3000
    deg = rng.poisson(20, n)
    deg[rng.choice(n, 60, replace=False)] = rng.integers(100, 900, 60)
    deg[:5] = 0
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, len(src))
    dst[::50] = src[::50]                                  # self-loops
    dst[1::97] = dst[::97][:len(dst[1::97])]               # duplicate arcs
    order = np.lexsort((dst, src))
    return Graph(row_ptr=np.concatenate([[0], np.cumsum(deg)]),
                 col_idx=dst[order].astype(np.int32), directed=True)


def _k8_held(got, want, deg, src, dst):
    """K8 against its plain version: the common-neighbour counts (from
    Jaccard and the degree sum) and preferential attachment exactly,
    Jaccard within 1e-6, Adamic-Adar and resource allocation within the sum
    tolerance (their terms add in another order)."""
    total = (deg[src] + deg[dst]).double()

    def inter(m):
        jac = m[:, 1].double()
        return torch.round(jac * total / (1.0 + jac))
    assert torch.equal(inter(got), inter(want))
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap", [4, 128, 1000])
def test_edge_metrics_kernel_routes_match_plain(dev, seed, cap):
    """K8 against its plain version on pairs whose other row is held in
    registers and pairs whose other row is longer than HELD ids (samples
    bracketing a search in device memory), pairs reaching the cap,
    self-pairs, zero-degree endpoints and a batch that leaves part of the
    last warp empty."""
    g = _k8_spread_graph()
    tg = g.device(dev)
    n = g.number_of_nodes
    rng = np.random.default_rng(seed * 1000 + cap)
    long_rows = np.flatnonzero(g.degrees > 99)
    arcs = rng.integers(0, g.number_of_directed_edges, 2000)
    src = np.concatenate([g.sources[arcs], rng.integers(0, n, 2000), rng.choice(long_rows, 300),
                          rng.integers(0, n, 200), np.arange(5), [3]])
    dst = np.concatenate([g.col_idx[arcs], rng.integers(0, n, 2000), rng.choice(long_rows, 300),
                          src[4300:4500], rng.integers(0, n, 5), [3]])
    degs = g.degrees
    other = np.maximum(degs[src], degs[dst])
    assert (other > HELD).sum() > 100 and (other <= HELD).sum() > 100
    assert (np.minimum(degs[src], degs[dst]) > cap).any() == (cap < 900)
    s = torch.from_numpy(src.astype(np.int32)).to(dev)
    d = torch.from_numpy(dst.astype(np.int32)).to(dev)
    before = _build.launch_counts()["edge_metrics"]
    got = edge_metrics(tg, s, d, cap)
    torch.cuda.synchronize()
    assert _build.launch_counts()["edge_metrics"] == before + 1
    want = edge_metrics_plain(tg, s, d, cap=cap)
    _k8_held(got, want, tg.degrees.long(), s.long(), d.long())


def _ell_laws(g, tg, rw, ew, cap):
    ell = (tg.ell_cols.cpu().numpy(),
           None if tg.ell_w is None else tg.ell_w.cpu().numpy(), min(cap, tg.ell_cap))
    return Laws(g.row_ptr, g.col_idx, g.weights, rw, ew, ell=ell)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n, m, cap", [(200, 800, 100), (200, 800, 8), (60, 1100, 34),
                                       (60, 1100, 100)])
def test_ell_walks_kernel_matches_its_law(dev, weighted, n, m, cap):
    """K9's whole walks, every move against its exact step law: over the
    whole rows (cap 100), and over rows subsampled at caps 8 and 34; the
    60-node graph's rows (degree up to 36) span two 32-slot chunks."""
    g = erdos_renyi(n, m, seed=7, weighted=weighted)
    tg = g.device(dev, ell_cap=cap, ell_seed=1)
    assert tg.ell_cap == min(cap, int(g.degrees.max()))
    starts = (torch.arange(200000, device=dev) % n).int()
    before = _build.launch_counts()["ell_walks"]
    w = ell_walks(tg, starts, 16, 2.0, 0.5, cap, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert _build.launch_counts()["ell_walks"] == before + 1
    assert torch.equal(w[:, 0], starts)
    assert walks_chi2_p(w.cpu().numpy(), _ell_laws(g, tg, 2.0, 0.5, cap), n)[0] >= 1e-3


def test_ell_walks_kernel_wide_rows(dev):
    """A 1,100-neighbour hub with cap 1,100: rows wider than a warp's 32
    slots many times over, and fewer warps per block."""
    n = 1500
    src = np.concatenate([np.zeros(1100, int), np.arange(1, n - 1)])
    dst = np.concatenate([np.arange(1, 1101), np.arange(2, n)])
    g = Graph.from_edge_arrays(src, dst, n_nodes=n, directed=False)
    tg = g.device(dev, ell_cap=1100)
    assert tg.ell_cap == 1100
    starts = torch.zeros(200000, dtype=torch.int32, device=dev)
    w = ell_walks(tg, starts, 3, 2.0, 0.5, 1100, torch.Generator().manual_seed(1))
    # Only the first two moves are tested: from the hub, then back or on.
    assert walks_chi2_p(w.cpu().numpy(), _ell_laws(g, tg, 2.0, 0.5, 1100), n)[0] >= 1e-3


def _law_graph(edges, weighted):
    """The undirected graph of `edges` ((src, dst, n) from `pq_laws`), with
    seeded arc weights when `weighted`."""
    import dataclasses

    src, dst, n = edges
    g = Graph.from_edge_arrays(src, dst, n_nodes=n, directed=False)
    if weighted:
        g = dataclasses.replace(g, weights=arc_weights(g.number_of_directed_edges))
    return g


@pytest.mark.parametrize("weighted", [False, True])
def test_ell_walks_kernel_rows_of_32_and_33_slots(dev, weighted):
    """K9 against the exact law where rows end exactly at, and one slot
    past, its first round of loads (and where a row's 33 candidates take
    two rounds of weights at 8 lanes a walker); half the walkers start at
    the two long rows."""
    g = _law_graph(rows_of_32_and_33(), weighted)
    tg = g.device(dev, ell_cap=40)
    assert tg.ell_cap == 33
    n = g.number_of_nodes
    starts = (torch.arange(200000, device=dev) % n).int()
    starts[::2] = (torch.arange(100000, device=dev) % 2).int()
    before = _build.launch_counts()["ell_walks"]
    w = ell_walks(tg, starts, 8, 2.0, 0.5, 40, torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    assert _build.launch_counts()["ell_walks"] == before + 1
    assert walks_chi2_p(w.cpu().numpy(), _ell_laws(g, tg, 2.0, 0.5, 40), n)[0] >= 1e-3


@pytest.mark.parametrize("weighted", [False, True])
def test_ell_walks_kernel_over_cap_prev_rows(dev, weighted):
    """Half the walkers start at a hub whose ELL row is an unsorted
    subsample, so their second move tests membership in an unsorted prev
    row: every move against the exact law."""
    g = _law_graph(two_hubs(), weighted)
    tg = g.device(dev, ell_cap=100, ell_seed=2)
    cols = tg.ell_cols.cpu().numpy()
    assert tg.ell_cap == 100 and (np.diff(cols[0]) < 0).any() and (np.diff(cols[1]) < 0).any()
    n = g.number_of_nodes
    starts = (torch.arange(200000, device=dev) % n).int()
    starts[::2] = (torch.arange(100000, device=dev) % 2).int()
    w = ell_walks(tg, starts, 6, 2.0, 0.5, 100, torch.Generator().manual_seed(4))
    assert walks_chi2_p(w.cpu().numpy(), _ell_laws(g, tg, 2.0, 0.5, 100), n)[0] >= 1e-3


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rw, ew", [(2.0, 0.5), (0.25, 4.0)])
def test_rejection_walks_kernel_matches_its_law(dev, weighted, rw, ew):
    """K10's whole walks, every move against the rejection step's exact law
    (8 tries at ratio 4, 16 at ratio 16)."""
    g = erdos_renyi(200, 800, seed=7, weighted=weighted)
    tg = g.device(dev, with_alias=weighted)
    starts = (torch.arange(40000, device=dev) % 200).int()
    t = n_tries_for(rw, ew)
    before = _build.launch_counts()["rejection_walks"]
    w = rejection_walks(tg, starts, 16, rw, ew, t, torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    assert _build.launch_counts()["rejection_walks"] == before + 1
    laws = Laws(g.row_ptr, g.col_idx, g.weights, rw, ew, n_tries=t)
    assert walks_chi2_p(w.cpu().numpy(), laws, 200)[0] >= 1e-3


TYPED_FACTORS = [(4.0, 1.0), (1.0, 0.2), (3.0, 0.5)]   # the reference's (node, edge)


def _typed_laws(g, tg, rw, ew, node_w, edge_w, cap, ell):
    return Laws(g.row_ptr, g.col_idx, g.weights, rw, ew,
                ell=None if not ell else (
                    tg.ell_cols.cpu().numpy(),
                    None if tg.ell_w is None else tg.ell_w.cpu().numpy(), min(cap, tg.ell_cap)),
                node_types=g.get_single_label_node_type_ids(), edge_types=g.edge_types,
                node_w=node_w, edge_w=edge_w, window=None if ell else cap)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rw, ew", [(1.0, 1.0), (2.0, 0.5)])
@pytest.mark.parametrize("node_w, edge_w", TYPED_FACTORS)
@pytest.mark.parametrize("cap", [100, 8])
def test_typed_ell_walks_kernel_matches_its_law(dev, weighted, rw, ew, node_w, edge_w, cap):
    """Typed K9 (its typed instantiation, counted apart), every move and
    the first ones against the typed law, over whole rows and over rows
    subsampled at cap 8."""
    g = erdos_renyi(200, 800, seed=7, weighted=weighted, n_edge_types=3, n_node_types=4)
    tg = g.device(dev, ell_cap=cap, ell_seed=1, with_walk_types=True)
    starts = (torch.arange(200000, device=dev) % 200).int()
    before = _build.launch_counts()
    w = ell_walks(tg, starts, 12, rw, ew, cap, torch.Generator().manual_seed(0), node_w, edge_w)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["ell_walks_typed"] == before["ell_walks_typed"] + 1
    assert after["ell_walks"] == before["ell_walks"]
    assert torch.equal(w[:, 0], starts)
    laws = _typed_laws(g, tg, rw, ew, node_w, edge_w, cap, ell=True)
    assert walks_chi2_p(w.cpu().numpy(), laws, 200)[0] >= 1e-3


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rw, ew, node_w, edge_w", [
    (2.0, 0.5, 1.0, 1.0), (0.05, 1.0, 1.0, 1.0), (1.0, 1.0, 4.0, 1.0), (2.0, 0.5, 1.0, 0.2),
    (2.0, 0.5, 3.0, 0.5),
])
@pytest.mark.parametrize("cap", [100, 12])
def test_exact_walks_kernel_matches_its_law(dev, weighted, rw, ew, node_w, edge_w, cap):
    """K19, untyped (first-order first step, alias draws on the weighted
    graph) and typed (an exact first step with the node factor), every move
    against its law: whole rows at cap 100, rotated windows of 12 on the
    longer rows."""
    g = erdos_renyi(80, 500, seed=11, weighted=weighted, n_edge_types=3, n_node_types=3)
    tg = g.device(dev, with_alias=weighted, with_walk_types=True)
    if cap == 12:
        assert int(g.degrees.max()) > 12
    starts = (torch.arange(100000, device=dev) % 80).int()
    before = _build.launch_counts()["exact_walks"]
    w = exact_walks(tg, starts, 10, rw, ew, cap, torch.Generator().manual_seed(1), node_w,
                    edge_w)
    torch.cuda.synchronize()
    assert _build.launch_counts()["exact_walks"] == before + 1
    assert torch.equal(w[:, 0], starts)
    laws = _typed_laws(g, tg, rw, ew, node_w, edge_w, cap, ell=False)
    assert walks_chi2_p(w.cpu().numpy(), laws, 80)[0] >= 1e-3


@pytest.mark.parametrize("route", ["ell", "exact"])
def test_typed_kernels_carry_the_picked_arcs_type_on_a_multigraph(dev, route):
    """Node 0 has two arcs to node 1, of types 0 and 2 (node types 0, 1, 0,
    1; node weight 2, edge weight 0.25; walks from node 3, whose one arc
    has type 2). From 0 the four arcs weigh 0.5, 2, 0.25 and 2; from 1 the
    next move depends on the type carried: after the type-0 arc, 1 -> 0
    (type 0) weighs 2 and 1 -> 2 (type 2) 0.5, after the type-2 arc the
    other way round, so 1 -> 0 has probability 0.2 * 0.8 + 0.8 * 0.2 =
    0.32, where a lookup of the pair (0, 1) would give one type's 0.8 or
    0.2."""
    from scipy.stats import chi2 as chi2_dist

    g = Graph(row_ptr=np.array([0, 4, 6, 7, 8]),
              col_idx=np.array([1, 1, 2, 3, 0, 2, 0, 0], np.int32),
              edge_types=np.array([0, 2, 1, 2, 0, 2, 1, 2], np.int32),
              node_type_ptr=np.arange(5), node_type_ids=np.array([0, 1, 0, 1], np.int32))
    tg = g.device(dev, ell_cap=8 if route == "ell" else None, with_walk_types=True)
    starts = torch.full((400000,), 3, dtype=torch.int32, device=dev)
    run = ell_walks if route == "ell" else exact_walks
    w = run(tg, starts, 4, 1.0, 1.0, 8, torch.Generator().manual_seed(5), 2.0, 0.25)
    w = w.cpu().numpy()
    assert (w[:, 1] == 0).all()

    def p_value(observed, law):
        e = observed.sum() * law
        return chi2_dist.sf(((observed - e) ** 2 / e).sum(), len(law) - 1)

    assert p_value(np.bincount(w[:, 2], minlength=4)[1:], np.array([2.5, 0.25, 2.0]) / 4.75) >= 1e-3
    at_1 = w[w[:, 2] == 1, 3]
    assert np.isin(at_1, [0, 2]).all()
    assert p_value(np.array([(at_1 == 0).sum(), (at_1 == 2).sum()]), np.array([0.32, 0.68])) >= 1e-3


def _cbow_against_plain(dev, x, n, d, window):
    """K11's sums and counts against its plain version's (autograd
    gradients added with index_add_), then K4's combine on CBOW's tables."""
    args = (*x["tables"], x["walks"], x["negs"], window, 6.0)
    sums, want_sums = SkipGramSums.zeros(n, d, dev), SkipGramSums.zeros(n, d, dev)
    before = _build.launch_counts()["cbow_update"]
    loss = cbow_update(*args, sums, x["center_w"])
    want_loss = cbow_update_plain(*args, want_sums, x["center_w"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["cbow_update"] == before + 1
    # Sums in another order than autograd's, and atomics in no fixed order.
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sums.counts_w, want_sums.counts_w, rtol=0, atol=0)
    torch.testing.assert_close(sums.counts_c, want_sums.counts_c, rtol=0, atol=0)
    for field in ("sums_w", "sums_c", "sums_b"):
        torch.testing.assert_close(getattr(sums, field), getattr(want_sums, field),
                                   rtol=1e-4, atol=1e-5)
    got_t = [t.clone() for t in x["tables"]]
    want_t = [t.clone() for t in x["tables"]]
    skipgram_mean_combine(*got_t, sums, 0.05)
    skipgram_mean_combine_plain(*want_t, want_sums, 0.05)
    for a, w in zip(got_t, want_t):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("n, d, length, window, k", [
    (300, 48, 20, 4, 7), (300, 30, 12, 3, 5), (60, 16, 12, 1, 5)])
def test_cbow_kernel_matches_plain(dev, with_center_w, n, d, length, window, k):
    """K11 against its plain version; n 60 makes the atomics collide."""
    x = _skipgram_inputs(dev, n, d, 64, length, k, with_center_w, seed=d)
    _cbow_against_plain(dev, x, n, d, window)


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("b", [5, 1000, 3001])
def test_cbow_kernel_batches_around_the_persistent_grid(dev, with_center_w, b):
    """Fewer walks than the persistent grid's blocks (at this shape, 8 a SM
    fit), and more walks than blocks, not a multiple of them."""
    x = _skipgram_inputs(dev, 300, 48, b, 20, 7, with_center_w, seed=b)
    _cbow_against_plain(dev, x, 300, 48, 4)


@pytest.mark.parametrize("with_center_w", [False, True])
def test_cbow_kernel_walks_of_one_repeated_node(dev, with_center_w):
    """Every walk repeats one node id at every position, so all of a walk's
    input, output and input-gradient rows add into one row of the sums."""
    x = _skipgram_inputs(dev, 300, 48, 64, 20, 7, with_center_w, seed=9)
    x["walks"] = (torch.arange(64, device=dev, dtype=torch.int32) % 7)[:, None].expand(
        64, 20).contiguous()
    _cbow_against_plain(dev, x, 300, 48, 4)


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("d, length, window, k", [
    (32, 12, 1, 5), (30, 7, 3, 5), (32, 12, 3, 1), (30, 3, 1, 1)])
def test_cbow_kernel_edge_shapes(dev, with_center_w, d, length, window, k):
    """Window 1; one centre a walk (L = 2w + 1); one negative; and all three."""
    x = _skipgram_inputs(dev, 300, d, 64, length, k, with_center_w, seed=length + k)
    _cbow_against_plain(dev, x, 300, d, window)


@pytest.mark.parametrize("pq", [True, False])
def test_cbow_step_launches_its_kernels(dev, pq):
    g = erdos_renyi(500, 3000, seed=3)
    kw = dict(return_weight=2.0, explore_weight=0.5) if pq else {}
    model = CBOW(device=dev, embedding_size=16, walk_length=12, window_size=3,
                 batch_size=64, random_state=0, **kw)
    tg = model._device_graph(g)
    model._run_batch_size = model._resolve_batch(g)
    params = model._init_params(g, torch.Generator().manual_seed(0))
    sums = model._new_sums(params)
    before = _build.launch_counts()
    with torch.no_grad():
        loss = model._step(tg, params, torch.Generator().manual_seed(1), 0.05, sums=sums)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert np.isfinite(float(loss))
    got = {k: after[k] - before[k] for k in (
        "ell_walks", "first_order_walks", "first_order_batch", "nce_negatives", "cbow_update",
        "skipgram_mean_combine", "skipgram_nce_update")}
    assert got == {"ell_walks": int(pq), "first_order_walks": 0,
                   "first_order_batch": int(not pq), "nce_negatives": 2 * int(pq),
                   "cbow_update": 1, "skipgram_mean_combine": 1, "skipgram_nce_update": 0}
    assert all(not bool(t.any()) for t in sums.buffers())


@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("typed", [True, False])
def test_siamese_batch_kernel_matches_its_law(dev, scale_free, typed):
    """K14's siamese batch: positives uniform over arcs, the corrupted nodes
    and the coin against their exact laws, the types those of the arcs."""
    import dataclasses

    g = erdos_renyi(200, 800, seed=7)
    if typed:
        g = dataclasses.replace(g, edge_types=(np.arange(g.number_of_directed_edges) % 5)
                                .astype(np.int32))
    tg = g.device(dev, with_sources=True)
    before = _build.launch_counts()["siamese_mini_batch"]
    batch = siamese_mini_batch(tg, torch.Generator().manual_seed(1), 100_000, scale_free, True)
    torch.cuda.synchronize()
    assert _build.launch_counts()["siamese_mini_batch"] == before + 1
    ids = arc_ids(tg, batch[0], batch[1])
    assert exact_p(torch.bincount(ids, minlength=tg.n_arcs).cpu().numpy(),
                   np.full(tg.n_arcs, 100_000 / tg.n_arcs)) >= 1e-3
    for name, (observed, expected) in siamese_counts(tg, batch, scale_free).items():
        assert exact_p(observed, expected) >= 1e-3, name
    want = tg.edge_types[ids] if typed else torch.zeros_like(batch[4])
    assert torch.equal(batch[4], want)


@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("avoid", [False, True])
@pytest.mark.parametrize("with_sources", [True, False])
def test_line_batch_kernel_matches_its_law(dev, scale_free, avoid, with_sources):
    """K14's LINE batch on a dense 60-node graph: every (source, negative)
    cell against P(v | s); with avoid_false_negatives, a first draw that is
    not an arc of its source is kept as it was drawn."""
    g = erdos_renyi(60, 1100, seed=7)
    tg = g.device(dev, with_sources=with_sources)
    b, k = 60_000, 5
    before = _build.launch_counts()["line_mini_batch"]
    src, dst, neg = line_mini_batch(tg, torch.Generator().manual_seed(4), b, k, scale_free,
                                    avoid)
    torch.cuda.synchronize()
    assert _build.launch_counts()["line_mini_batch"] == before + 1
    arc_ids(tg, src, dst)
    cells = torch.zeros((60, 60), dtype=torch.float64, device=dev)
    cells.index_put_((src.long()[:, None].expand(-1, k).reshape(-1), neg.long().reshape(-1)),
                     torch.ones(neg.numel(), dtype=torch.float64, device=dev), accumulate=True)
    m = torch.bincount(src.long(), minlength=60).double()
    law = line_negative_law_by_source(tg, scale_free, avoid)
    assert rows_p(cells.cpu().numpy(), (k * m[:, None] * law).cpu().numpy()) >= 1e-3
    if avoid:
        _, _, first = line_mini_batch(tg, torch.Generator().manual_seed(4), b, k, scale_free,
                                      False)
        clean = ~torch.from_numpy(g.has_edges(src.cpu().numpy().repeat(k),
                                              first.cpu().numpy().reshape(-1))).to(dev)
        assert torch.equal(neg.reshape(-1)[clean], first.reshape(-1)[clean])


@pytest.mark.parametrize("sampler", ["line", "siamese"])
@pytest.mark.parametrize("with_workspace", [False, True])
def test_k14_batches_lie_in_one_block(dev, sampler, with_workspace):
    """K14's outputs: LINE's src, dst and neg [B, K] are views of one int32
    block, in that order; the siamese rows are one [5, B] block (src, dst,
    csrc, cdst, types). On a workspace (`BatchDraws`) that block is the
    workspace's, each call draws a new batch under one key at the next
    counter offset, the same seed repeats the batches, and the batches keep
    their laws (here the LINE negatives' cells by source, and the siamese
    corrupted nodes and sides)."""
    import dataclasses

    g = erdos_renyi(60, 1100, seed=7)
    g = dataclasses.replace(g, edge_types=(np.arange(g.number_of_directed_edges) % 5)
                            .astype(np.int32))
    tg = g.device(dev, with_sources=True)
    b, k = 60_000, 5

    def batches(seed):
        gen = torch.Generator().manual_seed(seed)
        ws = ((BatchDraws.line(b, k, dev) if sampler == "line"
               else BatchDraws.siamese(b, True, dev)) if with_workspace else None)
        out = []
        for _ in range(3):
            if sampler == "line":
                src, dst, neg = line_mini_batch(tg, gen, b, k, True, False, workspace=ws)
                assert src.data_ptr() + 4 * b == dst.data_ptr()
                assert dst.data_ptr() + 4 * b == neg.data_ptr() and neg.shape == (b, k)
                block = src
                out.append(torch.cat([src, dst, neg.reshape(-1)]))
            else:
                block = siamese_mini_batch(tg, gen, b, True, True, workspace=ws)
                assert block.shape == (5, b) and block.dtype == torch.int32
                out.append(block.clone())
            if ws is not None:
                assert block.data_ptr() == ws.block.data_ptr()
        if ws is not None:
            assert ws.offset == 3 and ws.key is not None
        return out

    first, again = batches(11), batches(11)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first[0], first[1]) and not torch.equal(first[1], first[2])
    if sampler == "line":
        src, neg = first[2][:b], first[2][2 * b:].view(b, k)
        cells = torch.zeros((60, 60), dtype=torch.float64, device=dev)
        cells.index_put_((src.long()[:, None].expand(-1, k).reshape(-1), neg.long().reshape(-1)),
                         torch.ones(neg.numel(), dtype=torch.float64, device=dev),
                         accumulate=True)
        m = torch.bincount(src.long(), minlength=60).double()
        law = line_negative_law_by_source(tg, True, False)
        assert rows_p(cells.cpu().numpy(), (k * m[:, None] * law).cpu().numpy()) >= 1e-3
    else:
        for name, (observed, expected) in siamese_counts(tg, first[2], True).items():
            assert exact_p(observed, expected) >= 1e-3, name
        assert torch.equal(first[2][4], tg.edge_types[arc_ids(tg, first[2][0], first[2][1])])


def _minibatch_batch(rng, name, n, b=256, k=5):
    if name.endswith("LINE"):
        return (rng.integers(0, n, b, dtype=np.int32), rng.integers(0, n, b, dtype=np.int32),
                rng.integers(0, n, (b, k), dtype=np.int32))
    typed = name not in ("Unstructured",)
    return tuple(rng.integers(0, n, b, dtype=np.int32) for _ in range(4)) + (
        (rng.integers(0, 3, b, dtype=np.int32),) if typed else ())


@pytest.mark.parametrize("name", ["First-order LINE", "Second-order LINE", "Unstructured",
                                  "TransE", "TransH", "Structured Embedding"])
def test_minibatch_steps_match_the_cpu(dev, name):
    """Three steps on injected batches, on the card and on the CPU from the
    same tables; the step launches K4 standalone (LINE) and nothing else of
    the port's."""
    import dataclasses

    from embiggen_tpu_torch.models import get_model_from_library

    g = erdos_renyi(300, 1500, seed=5)
    g = dataclasses.replace(g, edge_types=(np.arange(g.number_of_directed_edges) % 3)
                            .astype(np.int32))
    cls = get_model_from_library(name)
    models = {d: cls(device=d, embedding_size=16, random_state=0) for d in (dev, "cpu")}
    init = models["cpu"]._init_params(g, torch.Generator().manual_seed(0))
    params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
    graphs = {d: m._prepare_data(g) for d, m in models.items()}
    rng = np.random.default_rng(6)
    before = _build.launch_counts()
    with torch.no_grad():
        for lr in (0.05, 0.04, 0.03):
            sl = _minibatch_batch(rng, name, 300)
            # LINE takes (src, dst, neg); the siamese models K14's block of rows.
            sliceable = (sl if name.endswith("LINE") else (np.stack(sl),))
            for d, m in models.items():
                m._run_batch_size = 256
                batch = tuple(torch.from_numpy(x).to(d) for x in sliceable)
                m._step(graphs[d], params[d], torch.Generator(), lr,
                        batch=(batch if name.endswith("LINE") else batch[0], ()))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.launch_counts().items() if v > before[k]}
    assert set(launched) == ({"mean_scatter", "mean_combine"} if name.endswith("LINE")
                             else set())
    for key in init:
        torch.testing.assert_close(params[dev][key].cpu(), params["cpu"][key], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["Second-order LINE", "TransE"])
def test_minibatch_fit_launches_k14(dev, name):
    import dataclasses

    from embiggen_tpu_torch.models import get_model_from_library

    g = erdos_renyi(500, 3000, seed=3)
    g = dataclasses.replace(g, edge_types=(np.arange(g.number_of_directed_edges) % 4)
                            .astype(np.int32))
    before = _build.launch_counts()
    model = get_model_from_library(name)(device=dev, embedding_size=16, epochs=2,
                                         batch_size=256, random_state=0)
    emb = model.fit_transform(g).node_embeddings[0]
    after = _build.launch_counts()
    sampler = "line_mini_batch" if "LINE" in name else "siamese_mini_batch"
    steps = 2 * (g.number_of_directed_edges // 256)
    assert after[sampler] - before[sampler] == steps
    for counter in ("mean_scatter", "mean_combine"):
        assert (after[counter] - before[counter] > 0) == ("LINE" in name)
    assert emb.shape == (500, 16) and np.isfinite(emb).all()


# ------------------------------------------------------- K12, K13 (S7)
def _walklets_inputs(dev, n, power, sub, b, length, k, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t((0.3 * rng.normal(size=(power, n, sub))).astype(np.float32)),
            t((0.3 * rng.normal(size=(power, n, sub))).astype(np.float32)),
            t(rng.normal(size=(power, n)).astype(np.float32)),
            t(rng.integers(0, n, (b, length)).astype(np.int32)),
            t(rng.integers(0, n, (b, k)).astype(np.int32)))


def _walklets_against_plain(dev, x, power, mode):
    tables, walks, negs = x[:3], x[3], x[4]
    p, n, sub = tables[0].shape
    sums, want = SkipGramSums.zeros(p * n, sub, dev), SkipGramSums.zeros(p * n, sub, dev)
    before = _build.launch_counts()["walklets_update"]
    loss = walklets_update(*tables, walks, negs, power, sums, mode)
    want_loss = walklets_update_plain(*tables, walks, negs, power, want, mode)
    torch.cuda.synchronize()
    assert _build.launch_counts()["walklets_update"] == before + 1
    # Sums in another order than autograd's and the atomics'; counts add
    # 1.0s (or 2.0s), exact in any order.
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sums.counts_w, want.counts_w, rtol=0, atol=0)
    torch.testing.assert_close(sums.counts_c, want.counts_c, rtol=0, atol=0)
    for field in ("sums_w", "sums_c", "sums_b"):
        torch.testing.assert_close(getattr(sums, field), getattr(want, field),
                                   rtol=1e-4, atol=1e-5)
    flat = lambda ts: (ts[0].view(p * n, sub), ts[1].view(p * n, sub), ts[2].view(p * n))  # noqa: E731
    got_t, want_t = [t.clone() for t in tables], [t.clone() for t in tables]
    skipgram_mean_combine(*flat(got_t), sums, 0.05)
    skipgram_mean_combine_plain(*flat(want_t), want, 0.05)
    for a, w in zip(got_t, want_t):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["skipgram", "cbow"])
@pytest.mark.parametrize("n, b, power, sub, length, k", [
    (60, 48, 4, 32, 16, 10), (60, 48, 4, 3, 12, 5), (60, 48, 1, 8, 9, 3),
    (60, 48, 3, 40, 10, 4), (60, 48, 3, 5, 4, 1), (60, 48, 4, 25, 16, 10),
    (2000, 1001, 4, 32, 16, 6)])
def test_walklets_kernel_matches_plain(dev, mode, n, b, power, sub, length, k):
    """K12 against its plain version: the bench's sub 32, a sub not a
    multiple of 4, P 1 and 3, a sub over one 32-column chunk, walks of
    power + 1 nodes (one pair at the top power), the default embedding's
    sub 25; n 60 makes the atomics collide. The last case has 4004 (walk,
    power) items, more than the persistent grid holds (a few blocks an SM)
    and no multiple of it, so blocks take unequal numbers of items."""
    x = _walklets_inputs(dev, n, power, sub, b, length, k, seed=power * 7 + sub)
    _walklets_against_plain(dev, x, power, mode)


@pytest.mark.parametrize("mode", ["skipgram", "cbow"])
def test_walklets_kernel_walks_of_one_repeated_node(dev, mode):
    x = list(_walklets_inputs(dev, 60, 4, 8, 40, 12, 5, seed=3))
    x[3] = (torch.arange(40, device=dev, dtype=torch.int32) % 5)[:, None].expand(
        40, 12).contiguous()
    _walklets_against_plain(dev, x, 4, mode)


def _cooc_against_plain(walks, n, strides):
    """K13a against its plain version: keys exactly, in ascending (center,
    context) order, sums rtol 1e-6; its six launches (count, scan, scatter,
    sort, scan, write)."""
    before = _build.launch_counts()["cooccurrences"]
    got = cooccurrences(walks, n, strides)
    want = cooccurrences_plain(walks, n, strides)
    torch.cuda.synchronize()
    if walks.shape[0] * sum(max(walks.shape[1] - d, 0) for d, _ in strides):
        assert _build.launch_counts()["cooccurrences"] == before + 6
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    keys = got[0].long() * n + got[1].long()
    assert bool((keys[1:] > keys[:-1]).all())
    # float64 sums in another order (the hub route's atomics in none);
    # compared after the cast.
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    return got


@pytest.mark.parametrize("strides", [glove_strides(2), glove_strides(5), ((3, 1.0),),
                                     ((16, 1.0), (1, 0.5))])
def test_cooccurrences_kernel_matches_plain(dev, strides):
    """K13a against its plain version: GloVe's 1/d windows, one Walklets
    stride, a stride at the walks' length (no pair) beside one that pairs;
    walks that revisit nodes (the diagonal dropped)."""
    rng = np.random.default_rng(len(strides))
    walks = rng.integers(0, 500, (3000, 16)).astype(np.int32)
    walks[:50, ::2] = 7
    walks[50] = 11
    _cooc_against_plain(torch.from_numpy(walks).to(dev), 500, strides)


@pytest.mark.parametrize("sweep_bytes", [1, 4096])
def test_cooccurrences_kernel_in_sweeps(dev, monkeypatch, sweep_bytes):
    """K13a's scatter split into many sweeps over ranges of segments (255,
    its most, and 170)."""
    from embiggen_tpu_torch.ops import glove

    monkeypatch.setattr(glove, "SWEEP_BYTES", sweep_bytes)
    rng = np.random.default_rng(9)
    walks = rng.integers(0, 500, (3000, 16)).astype(np.int32)
    _cooc_against_plain(torch.from_numpy(walks).to(dev), 500, glove_strides(2))


def test_cooccurrences_kernel_on_weighted_walks(dev):
    g = erdos_renyi(2000, 8000, seed=3, weighted=True)
    walks = first_order_walks(g.device(dev, with_alias=True),
                              torch.arange(2000, device=dev, dtype=torch.int32), 12,
                              torch.Generator().manual_seed(0))
    _cooc_against_plain(walks, 2000, glove_strides(3))


def test_cooccurrences_kernel_without_pairs(dev):
    walks = torch.zeros((10, 4), dtype=torch.int32, device=dev)
    got = cooccurrences(walks, 10, [(4, 1.0)])
    assert all(t.shape == (0,) for t in got)


def _star_walks(rng, leaves, walks, length):
    """Walks on a star: the hub (node 0) at every other position, random
    leaves between."""
    w = rng.integers(1, leaves + 1, (walks, length)).astype(np.int32)
    w[: walks // 2, ::2] = 0
    w[walks // 2:, 1::2] = 0
    return w


@pytest.mark.parametrize("case", ["star", "two stars", "planted hubs", "wide windows",
                                  "wide ids", "one repeated node", "no walks"])
def test_cooccurrences_kernel_edge_builds(dev, case):
    """K13a at its edges: a star's hub, whose segment is longer than a
    block's shared memory and whose contexts span several windows (and two
    hubs at once); ten hubs of several chunks each beside two hubs that
    alternate (one context repeated 12,800 times in a hub's window); a hub
    on a graph of over 2^25 nodes, whose windows are wider than a block's
    shared memory; node ids where a N + b exceeds 2^32; walks whose pairs
    are all on the diagonal (no entries); no walks."""
    rng = np.random.default_rng(8)
    strides = glove_strides(2)
    if case == "star":
        n, walks = 40_001, _star_walks(rng, 40_000, 4000, 16)
    elif case == "two stars":
        n = 30_002
        walks = _star_walks(rng, 30_001, 3000, 16)
        walks[1500:][walks[1500:] == 0] = 30_001
    elif case == "planted hubs":
        n = 60_000
        walks = rng.integers(0, n, (6000, 16)).astype(np.int32)
        walks[:3000, ::2] = (np.arange(3000) % 10)[:, None]
        walks[3000:3800, ::2] = 20
        walks[3000:3800, 1::2] = 21
    elif case == "wide windows":
        n, walks = 2**25 + 5, _star_walks(rng, 2**25 + 4, 4000, 16)
    elif case == "wide ids":
        n = 70_000
        walks = rng.integers(0, n, (3000, 16)).astype(np.int32)
        walks[:, -1] = n - 1
        assert (n - 1) * n + n - 2 > 2**32
    elif case == "one repeated node":
        n, walks = 50, np.full((40, 16), 9, dtype=np.int32)
    else:
        n, walks = 50, np.zeros((0, 16), dtype=np.int32)
    got = _cooc_against_plain(torch.from_numpy(walks).to(dev), n, strides)
    if case.endswith("star") or case in ("planted hubs", "wide windows"):
        assert int((got[0] == 0).sum()) > 8192 // 4
    if case in ("one repeated node", "no walks"):
        assert all(t.shape == (0,) for t in got)


GLOVE_COUNTERS = ("glove_gradients", "glove_node_update", "glove_context_update")


def _glove_entries(rng, dev, n, e):
    counts = rng.uniform(0.5, 300.0, e).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return Entries(t(rng.integers(0, n, e).astype(np.int32)),
                   t(rng.integers(0, n, e).astype(np.int32)),
                   t(np.minimum(1.0, (counts / 100.0) ** 0.75).astype(np.float32)),
                   t(np.log(counts)))


def _glove_step_held_to_exact(entries, ids, got, want, lr, workspace=None):
    """One step of K13b on `got` and of its plain version on `want` (copies
    of the same tables, or tables that earlier steps of each left apart by
    rounding), each held to the float64 step from its own tables: the
    tables' changes within `glove_checks`' bound, the losses within its
    loss tolerance; and the check refuses K13b's tables before the step, or
    with a side left out or the signs flipped. Returns K13b's loss."""
    exact = [glove_checks.step_exact(entries, ids, t, lr) for t in (got, want)]
    tables_before = [t.clone() for t in got]
    before = _build.launch_counts()
    loss = glove_step(entries, ids, *got, lr, workspace)
    want_loss = glove_step_plain(entries, ids, *want, lr)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in GLOVE_COUNTERS} == dict.fromkeys(GLOVE_COUNTERS, 1)
    for tables, value, (rows, (loss_exact, loss_tol)) in zip((got, want), (loss, want_loss),
                                                            exact):
        assert glove_checks.worst_share(tables, rows) <= 1.0
        assert abs(float(value) - loss_exact) <= loss_tol
    for name, wrong in glove_checks.controls(tables_before, got).items():
        assert glove_checks.worst_share(wrong, exact[0][0]) > 1.0, name
    return loss


@pytest.mark.parametrize("d", [128, 30, 5])
@pytest.mark.parametrize("case", ["uniform", "one entry", "walklets slice", "odd offset"])
def test_glove_step_kernel_matches_plain(dev, d, case):
    """K13b's three launches and its plain version (`index_add_` on the
    card) on copies of the same tables, both held to the float64 step
    (`tests/glove_checks.py`: float32's error bound for the step's sums, in
    any order): ids uniform over 5000 entries; one entry B times, so its
    rows take 4096 terms; power 1's slices of Walklets' stacked tables; and
    tables at an odd storage offset."""
    rng = np.random.default_rng(d)
    n, b = 300, 4096
    entries = _glove_entries(rng, dev, n, 5000)
    values = [(0.3 * rng.normal(size=s)).astype(np.float32) for s in ((n, d), (n, d), (n,), (n,))]
    ids = rng.integers(0, 5000, b).astype(np.int32)
    if case == "one entry":
        ids[:] = 7
    ids = torch.from_numpy(ids).to(dev)
    layout = case if case in ("walklets slice", "odd offset") else ""
    got, want = (glove_checks.table_copies(values, layout, dev) for _ in range(2))
    _glove_step_held_to_exact(entries, ids, got, want, 0.5)


@pytest.mark.parametrize("d", [128, 5])
def test_glove_step_kernel_on_a_workspace_over_steps(dev, d):
    """Three steps on one workspace, each held to the float64 step from the
    tables it found (B 1000, not a multiple of the gradient launch's 256
    entries a block); the loss returned is the workspace's scalar."""
    rng = np.random.default_rng(3 + d)
    n, b = 200, 1000
    entries = _glove_entries(rng, dev, n, 3000)
    values = [(0.3 * rng.normal(size=s)).astype(np.float32) for s in ((n, d), (n, d), (n,), (n,))]
    got, want = (glove_checks.table_copies(values, "", dev) for _ in range(2))
    ws = GloVeStepWorkspace.empty(b, d, dev)
    for lr in (0.5, 0.4, 0.3):
        ids = torch.from_numpy(rng.integers(0, 3000, b).astype(np.int32)).to(dev)
        loss = _glove_step_held_to_exact(entries, ids, got, want, lr, ws)
        assert loss.data_ptr() == ws.loss.data_ptr()
    with pytest.raises(ValueError, match="workspace.rows"):
        glove_step(entries, ids, *got, 0.1, GloVeStepWorkspace.empty(b, d + 1, dev))


# ------------------------------------------------------------------- S8
def _sketch_graph(kind):
    """An undirected weighted graph, one with two components and isolated
    nodes, or a directed one."""
    rng = np.random.default_rng(21)
    if kind == "er":
        return erdos_renyi(3000, 20000, seed=8, weighted=True)
    if kind == "components":
        a, b = rng.integers(0, 1000, (2, 4000)), rng.integers(1000, 2500, (2, 6000))
        return Graph.from_edge_arrays(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]),
                                      n_nodes=2600, weights=rng.uniform(0.1, 3, 10000))
    src, dst = rng.integers(0, 2000, (2, 12000))
    return Graph.from_edge_arrays(src, dst, n_nodes=2000, directed=True,
                                  weights=rng.uniform(0.1, 3, 12000))


@pytest.mark.parametrize("kind", ["er", "components", "directed"])
@pytest.mark.parametrize("d", [1, 30, 100, 130, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_min_plus_kernel_matches_plain(dev, kind, d, weighted):
    """K15a's distances and change flags equal its plain version's exactly,
    launch by launch; the early-stopped `multi_source_distances` equals 32
    plain relaxations after the first unchanged relaxation + 1 launches.
    D 130 (scalar route) and 256 (NodePiece's anchors, float4) take more
    than one column pass a row."""
    g = _sketch_graph(kind)
    n = g.number_of_nodes
    sets = [np.arange(j, n, 997) for j in range(d)]
    init = anchor_init_from_sets(n, sets, dev)
    tg, tg_cpu = g.device(dev), g.device("cpu")
    flag, want_flag = torch.zeros(1, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32)
    before = _build.launch_counts()["min_plus_step"]
    got = min_plus_step(tg, init, weighted, flag)
    want = min_plus_step_plain(tg_cpu, init.cpu(), weighted, want_flag)
    torch.cuda.synchronize()
    assert _build.launch_counts()["min_plus_step"] == before + 1
    assert torch.equal(got.cpu(), want) and int(flag) == int(want_flag) == 1
    want, want_changes = init.cpu(), torch.zeros(32, dtype=torch.int32)
    for i in range(32):
        want = min_plus_step_plain(tg_cpu, want, weighted, want_changes[i:i + 1])
    settle = int(want_changes.sum())
    assert want_changes.tolist() == [1] * settle + [0] * (32 - settle) and settle < 32
    changes = torch.zeros(32, dtype=torch.int32, device=dev)
    before = _build.launch_counts()["min_plus_step"]
    got = multi_source_distances(tg, init, 32, weighted, changes)
    torch.cuda.synchronize()
    assert _build.launch_counts()["min_plus_step"] == before + settle + 1
    assert torch.equal(got.cpu(), want) and torch.equal(changes.cpu(), want_changes)


@pytest.mark.parametrize("kind", ["er", "components", "directed"])
@pytest.mark.parametrize("weighted", [False, True])
def test_min_plus_kernel_flags_exactly_the_relaxations_that_move(dev, kind, weighted):
    """Relaxation by relaxation until one moves nothing, K15a's flag is 1
    exactly when its output differs from its input; and a launch on
    settled distances leaves it 0 and its input as it was."""
    g = _sketch_graph(kind)
    n = g.number_of_nodes
    dist, tg = anchor_init_from_sets(n, [np.arange(j, n, 501) for j in range(12)], dev), g.device(dev)
    for _ in range(64):
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        out = min_plus_step(tg, dist, weighted, flag)
        torch.cuda.synchronize()
        assert int(flag) == int(bool((out != dist).any()))
        if not int(flag):
            assert torch.equal(out, dist)
            break
        dist = out
    else:
        raise AssertionError("the distances did not settle in 64 relaxations")


def test_min_plus_kernel_at_an_odd_storage_offset(dev):
    g = _sketch_graph("er")
    buf = torch.full((3000 * 100 + 1,), 1e9, device=dev)
    dist = buf[1:].view(3000, 100)
    dist[::50, :] = 0.0
    assert dist.data_ptr() % 16 != 0
    got = min_plus_step(g.device(dev), dist, True)
    assert torch.equal(got.cpu(), min_plus_step_plain(g.device("cpu"), dist.cpu(), True))


@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("bits, seed", [(6, 0), (5, 2**40 + 3)])
def test_hll_registers_kernel_matches_plain(dev, precision, bits, seed):
    got = singleton_registers(5000, precision, bits, seed, dev)
    want = singleton_registers_plain(5000, precision, bits, seed)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["er", "components", "directed"])
@pytest.mark.parametrize("precision, hops", [(4, 3), (8, 1), (8, 3), (12, 2)])
def test_khop_sketches_kernel_matches_plain(dev, kind, precision, hops):
    g = _sketch_graph(kind)
    base = singleton_registers(g.number_of_nodes, precision, 6, 3, dev)
    before = _build.launch_counts()["khop_sketches"]
    got = khop_sketches(g.device(dev), base, hops)
    torch.cuda.synchronize()
    assert _build.launch_counts()["khop_sketches"] == before + hops
    assert torch.equal(got.cpu(), khop_sketches_plain(g.device("cpu"), base.cpu(), hops))


def _sketch_hubs_graph():
    """`_sketch_graph("er")` plus a hub joined to 1,000 of its nodes and
    4,000 new leaves (a row longer than M at every precision up to 12) and
    a second hub of 300 random neighbours."""
    g = _sketch_graph("er")
    rng = np.random.default_rng(23)
    n = g.number_of_nodes
    hub_src = np.repeat([n, n + 1], [5000, 300])
    hub_dst = np.concatenate([rng.choice(n, 1000, replace=False), np.arange(n + 2, n + 4002),
                              rng.integers(0, n, 300)])
    one = g.sources < g.col_idx
    return Graph.from_edge_arrays(np.concatenate([g.sources[one], hub_src]),
                                  np.concatenate([g.col_idx[one], hub_dst]), n_nodes=n + 4002)


@pytest.mark.parametrize("kind", ["er", "components", "directed", "hubs"])
@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("route", (None,) + HOP2_ROUTES)
def test_singleton_route_kernel_matches_plain(dev, kind, precision, route):
    """K16a's singleton route (hop 1; hop 2 forced onto each route, or as
    `hop2_route` picks it; hop 3 by the hop launch) equals the dense hops
    over the plain singletons byte for byte, and no singletons launch
    runs."""
    g = _sketch_hubs_graph() if kind == "hubs" else _sketch_graph(kind)
    n = g.number_of_nodes
    cpu = g.device("cpu")
    by_ball = (route or hop2_route(cpu, precision)) != "hop"
    before = _build.launch_counts()
    got = khop_sketches_of_singletons(g.device(dev), 3, precision, 6, 3, route)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in (
        "sketch_hop1", "sketch_hop2", "khop_sketches", "hll_registers")} == {
        "sketch_hop1": 1, "sketch_hop2": int(by_ball), "khop_sketches": 2 - by_ball,
        "hll_registers": 0}
    want = khop_sketches_plain(cpu, singleton_registers_plain(n, precision, 6, 3), 3)
    assert torch.equal(got.cpu(), want)


def test_singleton_route_kernel_takes_the_hop_launch_where_the_rule_picks_it(dev):
    """At precision 8 on a graph of mean degree 27 without long rows,
    `hop2_route` picks the hop launch for hop 2, from the singleton route's
    hop 1."""
    g = erdos_renyi(3000, 40000, seed=1)
    assert hop2_route(g.device("cpu"), 8) == "hop"
    before = _build.launch_counts()
    got = khop_sketches_of_singletons(g.device(dev), 3, 8, 6, 0)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in ("sketch_hop1", "sketch_hop2", "khop_sketches")} \
        == {"sketch_hop1": 1, "sketch_hop2": 0, "khop_sketches": 2}
    want = khop_sketches_plain(g.device("cpu"), singleton_registers_plain(3000, 8, 6, 0), 3)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("hops", [1, 2, 6])
@pytest.mark.parametrize("seed", [0, 5])
def test_singleton_route_kernel_at_other_hops(dev, hops, seed):
    g = _sketch_hubs_graph()
    got = khop_sketches_of_singletons(g.device(dev), hops, 8, 6, seed)
    want = khop_sketches_plain(g.device("cpu"), singleton_registers_plain(
        g.number_of_nodes, 8, 6, seed), hops)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("precision", range(4, 13))
@pytest.mark.parametrize("hops", [1, 2, 3, 6])
def test_edge_sketch_features_kernel_matches_plain(dev, precision, hops):
    """K16b against its plain version within tests/hll_checks.py's
    tolerance, on arcs and uniform pairs, at every precision: H <= 3 on
    the template route, H 6 on the general one."""
    g = _sketch_graph("er")
    sk = khop_sketches(g.device(dev), singleton_registers(3000, precision, 6, 0, dev), hops)
    rng = np.random.default_rng(hops)
    arcs = rng.integers(0, g.number_of_directed_edges, 3000)
    src = np.concatenate([g.sources[arcs], rng.integers(0, 3000, 3000)]).astype(np.int32)
    dst = np.concatenate([g.col_idx[arcs], rng.integers(0, 3000, 3000)]).astype(np.int32)
    got = edge_sketch_features(sk, torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
                               precision)
    want = edge_sketch_features_plain(sk.cpu(), torch.from_numpy(src), torch.from_numpy(dst),
                                      precision)
    worst, ties = feature_errors(sk, src, dst, precision, got.cpu().numpy(), want.numpy())
    assert worst <= 1.0 and ties <= MAX_TIE_SHARE * len(src), (worst, ties)


@pytest.mark.parametrize("precision", [4, 5, 8, 12])
@pytest.mark.parametrize("hops", [1, 3, 6])
@pytest.mark.parametrize("n_pairs", [1, 3, 1001])
def test_edge_sketch_features_kernel_on_few_pairs_and_self_pairs(dev, precision, hops, n_pairs):
    """Pair counts that fill no warp's or block's pairs, every other pair
    with src == dst: the features equal the plain version's within the
    tolerance."""
    g = _sketch_graph("er")
    sk = khop_sketches(g.device(dev), singleton_registers(3000, precision, 6, 0, dev), hops)
    rng = np.random.default_rng(n_pairs)
    src = rng.integers(0, 3000, n_pairs).astype(np.int32)
    dst = np.where(np.arange(n_pairs) % 2 == 0, src,
                   rng.integers(0, 3000, n_pairs)).astype(np.int32)
    got = edge_sketch_features(sk, torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
                               precision)
    want = edge_sketch_features_plain(sk.cpu(), torch.from_numpy(src), torch.from_numpy(dst),
                                      precision)
    worst, ties = feature_errors(sk, src, dst, precision, got.cpu().numpy(), want.numpy())
    assert got.shape == (n_pairs, hops * hops + 2 * hops)
    assert worst <= 1.0 and ties <= MAX_TIE_SHARE * len(src), (worst, ties)
    # A pair with itself: every overlap is the ball's own cardinality, so
    # the differences vanish.
    self_rows = got.cpu()[::2]
    assert float(self_rows[:, hops * hops:].abs().max()) <= 1e-3 * (
        1 + float(self_rows[:, :hops * hops].abs().max()))


@pytest.mark.parametrize("cls, kw", [(DegreeSPINE, dict(embedding_size=30)),
                                     (DegreeWINE, dict(embedding_size=30, window_size=3)),
                                     (WeightedSPINE, dict(embedding_size=30,
                                                          use_reciprocal_weights=True))])
def test_sketch_embedders_on_card_equal_the_cpu(dev, cls, kw):
    g = _sketch_graph("components")
    got = cls(device=dev, **kw).fit_transform(g).node_embeddings[0]
    want = cls(device="cpu", **kw).fit_transform(g).node_embeddings[0]
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)


def test_gcn_with_edge_features_on_card(dev):
    """The GCN with a lazy HyperSketching feature and a static edge-feature
    matrix fits on the card through K16b and K5, and its logits on fixed
    parameters match the CPU's."""
    g = erdos_renyi(500, 3000, seed=3)
    feats = np.random.default_rng(0).normal(size=(500, 16)).astype(np.float32)
    static = np.random.default_rng(1).normal(size=(g.number_of_directed_edges, 3)).astype(
        np.float32)
    kw = dict(units=[16], tower_units=[8], head_units=[8], epochs=2, batch_size=512,
              dropout_rate=0.0, random_state=0)
    before = _build.launch_counts()
    model = GCNEdgePrediction(device=dev, edge_feature_models=[HyperSketching(
        number_of_hops=2, precision=6, device=dev)], **kw)
    model.fit(g, node_features=feats, edge_features=[static])
    after = _build.launch_counts()
    for name in ("edge_sketch_features", "sketch_hop1", "csr_edge_ids"):
        assert after[name] > before[name], name
    # Hop 2 at precision 6 on a graph of mean degree 12 without long rows:
    # the hop launch; never the singletons launch.
    assert hop2_route(g.device("cpu"), 6) == "hop"
    assert after["sketch_hop2"] == before["sketch_hop2"]
    assert after["khop_sketches"] > before["khop_sketches"]
    assert after["hll_registers"] == before["hll_registers"]
    proba = model.predict_proba(g)
    assert proba.shape == (g.number_of_directed_edges,) and np.isfinite(proba).all()
    cpu = GCNEdgePrediction(device="cpu", edge_feature_models=[HyperSketching(
        number_of_hops=2, precision=6, device="cpu")], **kw)
    cpu._n_outputs = 1
    cpu._build_common(g, g, [feats], torch.Generator().manual_seed(0), ([], [static]))
    cpu._params, cpu._n_nodes, cpu._predict_h = _to_cpu(model._params), 500, None
    cpu._fitting_was_executed = True
    np.testing.assert_allclose(cpu.predict_proba(g), proba, rtol=1e-4, atol=1e-5)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def _race_graph(kind):
    """`_sketch_graph`'s graphs, or "hubs": a star of 5,000 leaves (the hub's
    row 5,000 arcs) beside an ER graph of 3,000 nodes, with two more hubs
    of 4,099 and 4,133 arcs, so rows are far longer than a warp's 32 arc
    ids and few degrees are multiples of 32."""
    if kind != "hubs":
        return _sketch_graph(kind)
    rng = np.random.default_rng(23)
    er = erdos_renyi(3000, 20000, seed=8)
    star = np.arange(3000, 8000)
    one = er.sources < er.col_idx
    src = np.concatenate([er.sources[one], np.zeros(5000, np.int64),
                          np.full(4099, 1), np.full(4133, 2)])
    dst = np.concatenate([er.col_idx[one], star, rng.integers(3, 8000, 4099),
                          rng.integers(3, 8000, 4133)])
    return Graph.from_edge_arrays(src, dst, n_nodes=8000, directed=False)


def _race_inputs(g, d, dev, grid=False, seed=0):
    """Races and noise Exp(1) (or on a small grid, for exact ties: "signed"
    adds -0.0, so candidates +0.0 and -0.0 tie too) and the initial sketch
    ids, on `dev`."""
    n = g.number_of_nodes
    rng = np.random.default_rng(seed)
    if grid == "signed":
        race = rng.choice(np.float32([-0.0, 0.0, 0.25, 0.5, 1.0]), (n, d))
        noise = rng.choice(np.float32([-0.0, 0.0, 0.5]), (n, d))
    elif grid:
        race = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), (n, d))
        noise = rng.choice(np.float32([0.0, 0.5]), (n, d))
    else:
        race = rng.exponential(size=(n, d)).astype(np.float32)
        noise = rng.exponential(size=(n, d)).astype(np.float32)
    sketch = np.repeat(np.arange(n, dtype=np.int32)[:, None], d, axis=1)
    return [torch.from_numpy(a).to(dev) for a in (race, sketch, noise)]


@pytest.mark.parametrize("kind", ["er", "components", "directed", "hubs"])
@pytest.mark.parametrize("d", [1, 30, 100, 128, 200])
@pytest.mark.parametrize("decay, grid", [(0.01, False), (0.3, False), (0.5, True),
                                         (0.5, "signed")])
def test_sketch_race_kernel_matches_plain(dev, kind, d, decay, grid):
    """K18's races and sketches equal its plain version's exactly, for one
    round and for ten (fresh noise each round), with exact ties on the grid
    draws (candidates of +0.0, and of -0.0 on the signed grid); a round is
    one candidate launch and one race launch, and the candidates equal
    their plain version's."""
    from embiggen_tpu_torch.ops.nodesketch import (
        inverse_decay, sketch_candidates, sketch_candidates_plain, sketch_race,
        sketch_race_step, sketch_race_step_plain,
    )

    g = _race_graph(kind)
    tg, tg_cpu = g.device(dev), g.device("cpu")
    race, sketch, noise = _race_inputs(g, d, dev, grid)
    inv = inverse_decay(decay)
    assert torch.equal(sketch_candidates(race, noise, inv).cpu(),
                       sketch_candidates_plain(race.cpu(), noise.cpu(), inv))
    before = _build.launch_counts()
    got = sketch_race_step(tg, race, sketch, noise, inv)
    want = sketch_race_step_plain(tg_cpu, race.cpu(), sketch.cpu(), noise.cpu(), inv)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["sketch_race_step"] == before["sketch_race_step"] + 1
    assert after["sketch_candidates"] == before["sketch_candidates"] + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    # The CUDA route of the plain version forms the same fused candidates.
    on_card = sketch_race_step_plain(tg, race, sketch, noise, inv)
    assert torch.equal(on_card[0].cpu(), want[0]) and torch.equal(on_card[1].cpu(), want[1])
    noises = [_race_inputs(g, d, dev, grid, seed=s)[2] for s in range(1, 11)]
    got = sketch_race(tg, race, sketch, noises, inv)
    want = sketch_race(tg_cpu, race.cpu(), sketch.cpu(), [x.cpu() for x in noises], inv)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("which", ["race", "sketch", "noise", "out"])
def test_sketch_race_kernel_at_an_odd_storage_offset(dev, which):
    """Each input, and the outputs, at a storage offset of one element: the
    16-byte routes are refused and the scalar ones give the same round."""
    from embiggen_tpu_torch.ops.nodesketch import sketch_race_step, sketch_race_step_plain

    g = _sketch_graph("er")
    inputs = dict(zip(("race", "sketch", "noise"), _race_inputs(g, 100, dev, seed=3)))
    want = sketch_race_step_plain(g.device("cpu"), *(inputs[k].cpu()
                                                     for k in ("race", "sketch", "noise")), 100.0)

    def odd(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view_as(t)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view
    out = None
    if which == "out":
        out = tuple(odd(torch.zeros_like(inputs[k])) for k in ("race", "sketch"))
    else:
        inputs[which] = odd(inputs[which])
    got = sketch_race_step(g.device(dev), inputs["race"], inputs["sketch"], inputs["noise"],
                           100.0, out)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("name", ["NodeSketch", "RandNE"])
def test_sparse_factorization_rows_on_cuda_match_the_cpu(dev, name):
    """NodeSketch (K18) and RandNE (K7) from the same state on the card and
    on the CPU: NodeSketch exactly, RandNE rtol 1e-5 (sums in another
    order)."""
    from embiggen_tpu_torch.models.embedders import factorization

    g = erdos_renyi(3000, 20000, seed=8)
    model = getattr(factorization, name)(device=dev, random_state=0)
    cpu = getattr(factorization, name)(device="cpu", random_state=0)
    state = model.initial_state(g)
    state = {k: (list(v) if k == "noise" else v) for k, v in state.items()}
    counter = "sketch_race_step" if name == "NodeSketch" else "spmm"
    before = _build.launch_counts()[counter]
    before_candidates = _build.launch_counts()["sketch_candidates"]
    got = model.run(g, dict(state, noise=iter(state.get("noise", []))))
    assert _build.launch_counts()[counter] == before + (10 if name == "NodeSketch" else 2)
    if name == "NodeSketch":
        assert _build.launch_counts()["sketch_candidates"] == before_candidates + 10
    want = cpu.run(g, {k: ([x.cpu() for x in v] if k == "noise" else v.cpu())
                       for k, v in state.items()})
    if name == "NodeSketch":
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["NetMF", "GraRep", "BoostNE", "MNMF", "NMFADMM", "NNSED"])
def test_dense_factorization_rows_on_cuda_match_the_cpu(dev, name):
    """The dense rows from the same state on the card (cuBLAS, cuSOLVER,
    TF32 off) and on the CPU, at their smoke parameters on a 300-node
    graph: the Gram matrix within 1e-4 of its scale for the SVD rows, the
    embedding within 5e-5 of its scale for the others."""
    from embiggen_tpu_torch.models.embedders import factorization

    assert not torch.backends.cuda.matmul.allow_tf32
    g = erdos_renyi(300, 1500, seed=5)
    cls = getattr(factorization, name)
    model = cls.into_smoke_test(device=dev)
    state = model.initial_state(g)
    got = model.run(g, state).cpu().numpy()
    want = cls.into_smoke_test(device="cpu").run(g, {
        k: ([x.cpu() for x in v] if isinstance(v, list) else v.cpu())
        for k, v in state.items()}).numpy()
    if name in ("NetMF", "GraRep"):
        got, want = got @ got.T, want @ want.T
        tol = 1e-4
    else:
        tol = 5e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ------------------------------------------------------ K17 (multi-device)
def _halo_parts(dev):
    """A weighted graph's partition over 4 shards on the card and on the
    CPU, and the graph."""
    from embiggen_tpu_torch.parallel import build_halo_partition

    g = erdos_renyi(3000, 24000, seed=11, weighted=True)
    rows, cols, vals = kernel_coo(g, "Symmetric Normalized Laplacian")
    return (build_halo_partition(rows, cols, vals, 3000, 4, device=dev),
            build_halo_partition(rows, cols, vals, 3000, 4, device="cpu"), g)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("width", [128, 30])
def test_halo_spmm_kernel_matches_plain(dev, combiner, width):
    """K17a forward (one launch over the own rows and the halo buffer) and
    backward (the transposed CSR) on every shard of 4, against the plain
    versions, and the four shards stacked against K7 on the whole graph."""
    from embiggen_tpu_torch.parallel.halo import halo_spmm_local, halo_spmm_local_backward

    part, cpu_part, g = _halo_parts(dev)
    s, h, p = part.shard_size, part.halo_width, part.n_shards
    x = torch.zeros(p * s, width, device=dev)
    x[:3000] = torch.randn(3000, width, device=dev)
    outs = []
    for shard in range(p):
        halo = torch.cat([x[q * s + torch.from_numpy(part.send_idx[q, shard]).to(dev).long()]
                          for q in range(p)])
        x_local = x[shard * s:(shard + 1) * s]
        before = _build.launch_counts()
        y = halo_spmm_local(part, shard, x_local, halo, combiner)
        g_out = torch.randn_like(y)
        back = halo_spmm_local_backward(part, shard, g_out, combiner)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert after["halo_spmm"] == before["halo_spmm"] + 1
        assert after["halo_spmm_backward"] == before["halo_spmm_backward"] + 1
        cpu = halo_spmm_local(cpu_part, shard, x_local.cpu(), halo.cpu(), combiner)
        torch.testing.assert_close(y.cpu(), cpu, rtol=1e-5, atol=1e-5)
        cpu_back = halo_spmm_local_backward(cpu_part, shard, g_out.cpu(), combiner)
        torch.testing.assert_close(back.cpu(), cpu_back, rtol=1e-5, atol=1e-5)
        outs.append(y)
    whole = csr_kernel(*kernel_coo(g, "Symmetric Normalized Laplacian"), 3000, device=dev)
    torch.testing.assert_close(torch.cat(outs)[:3000], spmm(whole, x[:3000], combiner),
                               rtol=1e-5, atol=1e-5)


def test_edge_sharded_spmm_kernel_matches_plain(dev):
    """K17b: K7's kernel on each of 4 edge shards' CSRs, counted apart,
    against the plain version, and the partials' sum against K7 whole."""
    from embiggen_tpu_torch.parallel import edge_shard_kernel

    g = erdos_renyi(3000, 24000, seed=12)
    rows, cols, vals = kernel_coo(g, "Symmetric Normalized Laplacian")
    x = torch.randn(3000, 128, device=dev)
    total = torch.zeros_like(x)
    for shard in range(4):
        k = edge_shard_kernel(rows, cols, vals, 3000, 4, shard, device=dev)
        before = _build.launch_counts()["sharded_spmm"]
        part = csr_spmm(k, x, counter="sharded_spmm")
        torch.cuda.synchronize()
        assert _build.launch_counts()["sharded_spmm"] == before + 1
        cpu_k = edge_shard_kernel(rows, cols, vals, 3000, 4, shard, device="cpu")
        torch.testing.assert_close(part.cpu(), csr_spmm_plain(cpu_k, x.cpu()),
                                   rtol=1e-5, atol=1e-5)
        total += part
    whole = csr_kernel(rows, cols, vals, 3000, device=dev)
    torch.testing.assert_close(total, spmm(whole, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [128, 30, 1])
def test_owned_gather_and_scatter_kernels_match_plain(dev, width):
    """K17d and K17c (count, then the scatter with per-row counts, per-entry
    counts with zeros skipped, and none) on each of 4 row shards."""
    from embiggen_tpu_torch.ops.sharded import (
        owned_count, owned_count_plain, owned_gather, owned_gather_plain, owned_scatter,
        owned_scatter_plain,
    )

    n, m, p = 5001, 20000, 4
    s = -(-n // p)
    shape = (s,) if width == 1 else (s, width)
    idx = torch.randint(0, n, (m,), device=dev, dtype=torch.int32)
    grads = torch.randn((m,) + shape[1:], device=dev)
    entry_den = torch.randint(0, 3, (m,), device=dev).float()
    for rank in range(p):
        lo = rank * s
        shard = torch.randn(shape, device=dev)
        torch.testing.assert_close(owned_gather(shard, lo, idx).cpu(),
                                   owned_gather_plain(shard.cpu(), lo, idx.cpu()), rtol=0, atol=0)
        counts = owned_count(torch.zeros(s, device=dev), lo, idx)
        want_counts = owned_count_plain(torch.zeros(s), lo, idx.cpu())
        torch.testing.assert_close(counts.cpu(), want_counts, rtol=0, atol=0)
        for kw in (dict(row_den=counts), dict(entry_den=entry_den), {}):
            got = owned_scatter(shard.clone(), lo, idx, grads, -0.3, **kw)
            want = owned_scatter_plain(shard.cpu(), lo, idx.cpu(), grads.cpu(), -0.3,
                                       **{k: v.cpu() for k, v in kw.items()})
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- K20
def _sddmm_inputs(dev, n_edges, d, id_dtype=torch.int32, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(700, d)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.integers(0, 700, n_edges)).to(dev, id_dtype)
    cols = torch.from_numpy(rng.integers(0, 500, n_edges)).to(dev, id_dtype)
    return rows, cols, a, b


@pytest.mark.parametrize("d", [1, 3, 8, 12, 30, 64, 127, 128, 200])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_sddmm_kernel_matches_plain(dev, d, id_dtype):
    """K20a at every group width (4-32 lanes an edge), on the float4 and
    scalar routes, with int32 and int64 ids (rtol / atol 1e-5: sums over
    D in another order), one launch counted."""
    from embiggen_tpu_torch.ops.spmm import sddmm, sddmm_plain

    rows, cols, a, b = _sddmm_inputs(dev, 5000, d, id_dtype)
    before = _build.launch_counts()["sddmm"]
    got = sddmm(rows, cols, a, b)
    torch.cuda.synchronize()
    assert _build.launch_counts()["sddmm"] == before + 1
    torch.testing.assert_close(got, sddmm_plain(rows, cols, a, b), rtol=1e-5, atol=1e-5)


def test_sddmm_kernel_at_an_odd_storage_offset(dev):
    """Tables whose rows are not 16-byte aligned (views one float into their
    buffers) take the scalar route and match the plain version."""
    from embiggen_tpu_torch.ops.spmm import sddmm, sddmm_plain

    rows, cols, a, b = _sddmm_inputs(dev, 3000, 128)
    a = torch.cat([torch.zeros(1, device=dev), a.reshape(-1)])[1:].view(a.shape)
    b = torch.cat([torch.zeros(1, device=dev), b.reshape(-1)])[1:].view(b.shape)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0 and b.data_ptr() % 16 != 0
    got = sddmm(rows, cols, a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sddmm_plain(rows, cols, a, b), rtol=1e-5, atol=1e-5)


def test_sddmm_backward_and_no_edges_on_the_card(dev):
    """The gradients through the kernel's forward equal the CPU's; no edges
    launch nothing."""
    from embiggen_tpu_torch.ops.spmm import sddmm

    rows, cols, a, b = _sddmm_inputs(dev, 4000, 20)
    w = torch.randn(4000, device=dev)
    grads = {}
    for d in (dev, torch.device("cpu")):
        xa, xb = a.to(d).requires_grad_(), b.to(d).requires_grad_()
        grads[d.type] = torch.autograd.grad(
            (sddmm(rows.to(d), cols.to(d), xa, xb) * w.to(d)).sum(), (xa, xb))
    for g, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-5, atol=1e-5)
    before = _build.launch_counts()["sddmm"]
    empty = rows[:0]
    assert sddmm(empty, empty, a, b).shape == (0,)
    assert _build.launch_counts()["sddmm"] == before


@pytest.mark.parametrize("with_sources", [False, True])
def test_edge_chunk_kernel_matches_plain(dev, with_sources):
    """K20b exactly: the first, a middle, the last (clamped) and past-the-end
    chunks of a graph with isolated nodes and long rows, ids and mask, each
    a launch; an edgeless graph raises for the ids and masks all False."""
    from embiggen_tpu_torch.ops.negatives import (
        chunk_mask, chunk_mask_plain, edge_chunk, edge_chunk_plain,
    )

    g = barabasi_albert(3000, 3, seed=1)
    tg = g.device(dev, with_sources=with_sources)
    cpu = g.device("cpu", with_sources=with_sources)
    for size in (1, 1000, 4096):
        last = (tg.n_arcs - 1) // size
        for i in sorted({0, last // 2, last, last + 1}):
            counts = _build.launch_counts()
            src, dst = edge_chunk(tg, i, size)
            mask = chunk_mask(tg, i, size)
            torch.cuda.synchronize()
            after = _build.launch_counts()
            assert (after["edge_chunk"], after["chunk_mask"]) == (
                counts["edge_chunk"] + 1, counts["chunk_mask"] + 1)
            want_src, want_dst = edge_chunk_plain(cpu, i, size)
            assert torch.equal(src.cpu(), want_src) and torch.equal(dst.cpu(), want_dst)
            assert torch.equal(mask.cpu(), chunk_mask_plain(cpu, i, size))
    empty = Graph.from_edge_arrays(np.zeros(0, np.int64), np.zeros(0, np.int64), n_nodes=4,
                                   directed=True).device(dev, with_sources=with_sources)
    with pytest.raises(TypeError):
        edge_chunk(empty, 0, 8)
    assert not chunk_mask(empty, 0, 8).any()


def test_kge_steps_on_the_card_match_the_cpu(dev):
    """One injected step of every KGE row (D 12, NodePiece with K15a's
    tokens) on the card against the CPU from the same tables (rtol 1e-4 /
    atol 1e-5: sums in another order, cuFFT and cuDNN)."""
    import dataclasses

    from embiggen_tpu_torch.models.embedders import KGE_MODELS

    base = erdos_renyi(300, 1500, seed=3)
    g = dataclasses.replace(base, edge_types=(
        np.arange(base.number_of_directed_edges) % 3).astype(np.int32))
    rng = np.random.default_rng(2)
    block = np.stack([rng.integers(0, 300, 256) for _ in range(4)]
                     + [rng.integers(0, 3, 256)]).astype(np.int32)
    for cls in KGE_MODELS:
        kw = dict(embedding_size=12, random_state=0)
        if cls.model_name() == "NodePiece":
            kw.update(number_of_anchors=16, tokens_per_node=4)
        models = {d: cls(device=d, **kw) for d in (dev, "cpu")}
        init = models["cpu"]._init_params(g, torch.Generator().manual_seed(0))
        params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
        ctx = {d: m._prepare_data(g) for d, m in models.items()}
        if cls.model_name() == "NodePiece":
            assert torch.equal(ctx[dev]["tokens"].cpu(), ctx["cpu"]["tokens"])
        for d, m in models.items():
            m._run_batch_size = 256
            shared = (ctx[d]["tokens"],) if cls.model_name() == "NodePiece" else ()
            with torch.no_grad():
                m._step(ctx[d], params[d], torch.Generator(), 0.05,
                        batch=(torch.from_numpy(block).to(d), shared))
        for k in init:
            torch.testing.assert_close(params[dev][k].cpu(), params["cpu"][k], rtol=1e-4,
                                       atol=1e-5, msg=f"{cls.model_name()} {k}")


def test_sample_negative_graph_defaults_to_k5(dev):
    """`sample_negative_graph` without a device tests membership with K5 on
    the card, and draws the negatives it draws on the CPU."""
    from embiggen_tpu_torch.graph import sample_negative_graph
    from embiggen_tpu_torch.graph import sampling

    g = erdos_renyi(3000, 15000, seed=21)
    sampling._NEG_CACHE.clear()
    before = _build.launch_counts()["csr_edge_ids"]
    neg = sample_negative_graph(g, 4000, random_state=5)
    assert _build.launch_counts()["csr_edge_ids"] > before
    sampling._NEG_CACHE.clear()
    want = sample_negative_graph(g, 4000, random_state=5, device="cpu")
    np.testing.assert_array_equal(neg.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(neg.col_idx, want.col_idx)


def test_device_memory_stats_reads_the_card(dev):
    from embiggen_tpu_torch.utils import profiling

    x = torch.empty(1 << 20, dtype=torch.float32, device=dev)
    stats = profiling.device_memory_stats(dev)
    assert stats["allocated_bytes.all.current"] >= x.numel() * x.element_size()


# ------------------------------------------------------------- label tasks
def _typed_graph():
    return erdos_renyi(600, 5000, seed=4, n_edge_types=3, n_node_types=4)


def test_node_label_steps_on_card_match_the_cpu(dev):
    """Three epochs of the node-label GCN (one full-graph Adam step each,
    K7 forward and backward on the card) from the same parameters, dropout
    0: the card's losses and probabilities are the CPU's."""
    from embiggen_tpu_torch.models.gcn import KipfGCNNodeLabelPrediction

    g = _typed_graph()
    feats = np.random.default_rng(0).normal(size=(600, 16)).astype(np.float32)
    kw = dict(units=[32, 16], head_units=[8], epochs=3, dropout_rate=0.0, random_state=0,
              early_stopping_patience=10**6)
    fitted = {}
    for device in (dev, torch.device("cpu")):
        before = _build.launch_counts()["spmm"]
        fitted[device.type] = KipfGCNNodeLabelPrediction(device=device, **kw).fit(
            g, node_features=feats)
        if device.type == "cuda":
            torch.cuda.synchronize()
            # Two layers forward and the second's transposed backward (the
            # static features take no gradient), three epochs.
            assert _build.launch_counts()["spmm"] - before == 3 * 3
    np.testing.assert_allclose(fitted["cuda"]._history, fitted["cpu"]._history, rtol=1e-5)
    np.testing.assert_allclose(fitted["cuda"].predict_proba(g), fitted["cpu"].predict_proba(g),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_edge_metrics", [False, True])
def test_edge_label_steps_on_card_match_the_cpu(dev, use_edge_metrics):
    """Three edge-label Adam steps on injected batches of known arcs from
    the same parameters, card against CPU; with `use_edge_metrics` the card
    launches K8 once a step."""
    from embiggen_tpu_torch.models.gcn import GCNEdgeLabelPrediction

    g = _typed_graph()
    feats = [np.random.default_rng(0).normal(size=(600, 16)).astype(np.float32)]
    rng = np.random.default_rng(1)
    picks = [rng.integers(0, g.number_of_directed_edges, 512) for _ in range(3)]
    kw = dict(units=[32], tower_units=[16], head_units=[8], dropout_rate=0.0, random_state=0,
              use_edge_metrics=use_edge_metrics)
    params, histories = {}, {}
    for device in (dev, torch.device("cpu")):
        model = GCNEdgeLabelPrediction(device=device, **kw)
        model._n_outputs, model._n_nodes = 3, 600
        p, kernels = model._build_common(g, g, feats, torch.Generator().manual_seed(0))
        batches = iter([tuple(torch.from_numpy(a[pick].astype(np.int32)).to(device)
                              for a in (g.sources, g.col_idx, g.edge_types)) for pick in picks])
        before = _build.launch_counts()["edge_metrics"]
        loop = TrainLoop(epochs=3, learning_rate=0.01, early_stopping_patience=10**6)
        _, histories[device.type] = loop.run(
            p, lambda q: model._loss(q, kernels, None, next(batches), None, None))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert _build.launch_counts()["edge_metrics"] - before == (3 if use_edge_metrics
                                                                       else 0)
        params[device.type] = p
    np.testing.assert_allclose(histories["cuda"], histories["cpu"], rtol=1e-5)
    for got, want in zip(param_leaves(params["cuda"]), param_leaves(params["cpu"])):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("width", [128, 30])
def test_graph_convolution_kernel_matches_plain(dev, transpose, width):
    """GraphConvolution's hops on the card (K7 over the kernel's CSR; the
    transposed kernel's rows sorted by `csr_kernel`) against the CPU's plain
    hops, concatenated."""
    from embiggen_tpu_torch.models.feature_preprocessors import GraphConvolution

    g = erdos_renyi(3000, 20000, seed=8)
    x = np.random.default_rng(2).normal(size=(3000, width)).astype(np.float32)
    kw = dict(number_of_convolutions=2, transpose=transpose, concatenate_features=True)
    before = _build.launch_counts()["spmm"]
    got = GraphConvolution(device=dev, **kw).transform(g, x).node_embeddings[0]
    assert _build.launch_counts()["spmm"] - before == 2
    want = GraphConvolution(device="cpu", **kw).transform(g, x).node_embeddings[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _hub_graph_past_the_cap():
    """A sparse random graph plus hubs of 200-3,000 random neighbours (hub
    pairs among them), so rows pass K8's default cap of 128 and its
    register capacity."""
    rng = np.random.default_rng(17)
    n = 6000
    sizes = (3000, 2400, 1500, 600, 200)
    src = np.concatenate([rng.integers(0, n, 30000)] + [np.full(s, h) for h, s in enumerate(sizes)])
    dst = np.concatenate([rng.integers(0, n, 30000)]
                         + [rng.choice(n, s, replace=False) for s in sizes])
    return Graph.from_edge_arrays(src, dst, n_nodes=n, directed=False)


def test_edge_metrics_kernel_at_the_largest_degree(dev):
    """K8 at the sklearn adapters' cap, the largest degree, where it
    truncates no row: against its plain version at that cap and the host
    copy of `graph/metrics.py` (the exact function; sums in another order,
    rtol 1e-5 / atol 1e-6)."""
    from embiggen_tpu_torch.graph.metrics import edge_metrics as host_edge_metrics

    g = _hub_graph_past_the_cap()
    tg = g.device(dev)
    n, cap = g.number_of_nodes, tg.max_degree
    rng = np.random.default_rng(3)
    arcs = rng.integers(0, g.number_of_directed_edges, 3000)
    top = np.argsort(-g.degrees)[:5]
    src = np.concatenate([g.sources[arcs], rng.integers(0, n, 3000), np.repeat(top, 5)])
    dst = np.concatenate([g.col_idx[arcs], rng.integers(0, n, 3000), np.tile(top, 5)])
    assert np.minimum(g.degrees[src], g.degrees[dst]).max() > HELD * 8
    s = torch.from_numpy(src.astype(np.int32)).to(dev)
    d = torch.from_numpy(dst.astype(np.int32)).to(dev)
    before = _build.launch_counts()["edge_metrics"]
    got = edge_metrics(tg, s, d, cap=cap)
    torch.cuda.synchronize()
    assert _build.launch_counts()["edge_metrics"] == before + 1
    _k8_held(got, edge_metrics_plain(tg, s, d, cap=cap), tg.degrees.long(), s.long(), d.long())
    host = torch.from_numpy(host_edge_metrics(g, src, dst)).to(dev)
    torch.testing.assert_close(got[:, 3], host[:, 3], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 1], host[:, 1], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:, [0, 2]], host[:, [0, 2]], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("methods", [["Hadamard", "Concatenate", None], ["CosineSimilarity",
                                     "L2Distance", "L1Norm", "L2Norm", "Min", "Max", "L2"]])
def test_transformers_on_cuda_match_the_cpu(dev, methods):
    """The edge and edge-prediction transformers on the card against the
    CPU's (which equal the reference's): within 1e-6."""
    from embiggen_tpu_torch.transformers import EdgePredictionTransformer, EdgeTransformer

    g, neg = erdos_renyi(300, 2000, seed=3), erdos_renyi(300, 2000, seed=4)
    x = np.random.default_rng(2).standard_normal((300, 33)).astype(np.float32)
    src, dst = g.sources, g.col_idx
    got = EdgeTransformer(methods, device=dev).fit(x).transform(src, dst)
    want = EdgeTransformer(methods, device="cpu").fit(x).transform(src, dst)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got = EdgePredictionTransformer(methods, device=dev).fit(x).transform(g, neg, random_state=5)
    want = EdgePredictionTransformer(methods, device="cpu").fit(x).transform(
        g, neg, random_state=5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


def test_sklearn_adapters_on_cuda_match_the_cpu(dev):
    """The edge-prediction and edge-label adapters with numpy estimators and
    `use_edge_metrics` on the card: K5 for the negatives and K8 at the
    largest degree for the metric columns, each launched, and the scores
    within 1e-4 of the same estimators fitted on the CPU's features."""
    from numpy_estimators import CentroidClassifier, LeastSquaresClassifier
    from embiggen_tpu_torch.models.edge_label_prediction import (
        SklearnEdgeLabelPredictionAdapter,
    )
    from embiggen_tpu_torch.models.edge_prediction import SklearnEdgePredictionAdapter

    g = _hub_graph_past_the_cap()
    x = np.random.default_rng(4).standard_normal((g.number_of_nodes, 16)).astype(np.float32)
    scores = {}
    for device in (dev, "cpu"):
        _build.reset_launch_counts()
        m = SklearnEdgePredictionAdapter(LeastSquaresClassifier(), "Hadamard",
                                         use_edge_metrics=True, random_state=1, device=device)
        scores[str(device)] = [m.fit(g, node_features=x).predict_proba(g)]
        counts = _build.launch_counts()
        assert (counts["edge_metrics"] > 0 and counts["csr_edge_ids"] > 0) == (device == dev)
    np.testing.assert_allclose(*scores.values(), rtol=1e-4, atol=1e-4)
    t = erdos_renyi(2000, 12000, seed=5, n_edge_types=4)
    x = np.random.default_rng(5).standard_normal((2000, 8)).astype(np.float32)
    probs = [SklearnEdgeLabelPredictionAdapter(model, use_edge_metrics=True, device=device)
             .fit(t, node_features=x).predict_proba(t)
             for model in (LeastSquaresClassifier(), CentroidClassifier())
             for device in (dev, "cpu")]
    np.testing.assert_allclose(probs[0], probs[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(probs[2], probs[3], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("weights, counter", [((1.0, 1.0), "first_order_walks"),
                                              ((2.0, 0.5), "rejection_walks")])
def test_graph_node2vec_on_the_card_is_its_op(dev, weights, counter):
    """`Graph.node2vec` on the card: one launch of K1 (p = q = 1) or K10
    (p/q, no ELL table exported), and the op's own pairs when it is
    launched directly under a generator seeded alike."""
    from embiggen_tpu_torch.ops.walks import node2vec_batch

    g = erdos_renyi(3000, 20000, seed=6, n_edge_types=3)
    _build.reset_launch_counts()
    contexts, words = g.node2vec(7, 500, 20, window_size=3, iterations=2,
                                 return_weight=weights[0], explore_weight=weights[1])
    assert _build.launch_counts()[counter] == 1
    tg = g._device_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    starts = torch.randint(0, 3000, (500,), generator=gen, device=dev, dtype=torch.int32)
    want = node2vec_batch(tg, starts, 20, 3, gen, iterations=2, return_weight=weights[0],
                          explore_weight=weights[1], max_neighbours=100)
    np.testing.assert_array_equal(contexts, want[0].cpu().numpy())
    np.testing.assert_array_equal(words, want[1].cpu().numpy())
    assert g.has_edges(contexts[:, 2], words).all() and g.has_edges(words, contexts[:, 3]).all()


def test_graph_batches_on_the_card_are_their_ops(dev):
    """`get_edge_prediction_mini_batch` (K6) and both siamese batches (K14)
    on the card: one launch each, equal to the op launched directly under a
    generator seeded alike; positives are arcs."""
    g = erdos_renyi(3000, 20000, seed=6, n_edge_types=3)
    tg = g._device_graph(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    _build.reset_launch_counts()
    got = g.get_edge_prediction_mini_batch(5, 4096)
    assert _build.launch_counts()["edge_prediction_mini_batch"] == 1
    for a, b in zip(got, edge_prediction_mini_batch(tg, gen(5), 4096)):
        np.testing.assert_array_equal(a, b.cpu().numpy())
    assert g.has_edges(got[0][:2048], got[1][:2048]).all()
    for typed in (False, True):
        _build.reset_launch_counts()
        got = (g.get_siamese_mini_batch_with_edge_types if typed
               else g.get_siamese_mini_batch)(3, 4096)
        assert _build.launch_counts()["siamese_mini_batch"] == 1 and len(got) == 4 + typed
        want = siamese_mini_batch(tg, gen(3), 4096, with_edge_types=typed).cpu().numpy()
        np.testing.assert_array_equal(np.stack(got), want)
        assert g.has_edges(got[0], got[1]).all()


def test_graph_edge_metrics_on_the_card_match_the_host_copy(dev):
    """`get_all_edge_metrics_from_node_ids` on the card is K8 at the largest
    degree, held to the host copy as the adapters' columns are."""
    from embiggen_tpu_torch.graph.metrics import edge_metrics as host_edge_metrics

    g = _hub_graph_past_the_cap()
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, g.number_of_nodes, (2, 5000))
    _build.reset_launch_counts()
    got = g.get_all_edge_metrics_from_node_ids(src, dst)
    assert _build.launch_counts()["edge_metrics"] == 1
    want = host_edge_metrics(g, src, dst)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=0)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.get_adamic_adar_scores(),
                               g.get_adamic_adar_scores(device="cpu"), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ A12 on the card
class _SaveThenKill:
    """`save_pytree` that raises after `n` saves, each completed first."""

    def __init__(self, real, n):
        self.real, self.left = real, n

    def __call__(self, path, tree, **kw):
        self.real(path, tree, **kw)
        self.left -= 1
        if self.left <= 0:
            raise KeyboardInterrupt("simulated kill")


def _first_draw(monkeypatch, owner, attr, index):
    """Wrap the batch draw `owner.attr`: the tensors it returns at call
    `index`, copied into the returned list."""
    real, seen, calls = getattr(owner, attr), [], [0]

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for item in (x if isinstance(x, (list, tuple)) else ()) for t in tensors(item)]

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        if calls[0] == index:
            seen.extend(t.clone() for t in tensors(out))
        calls[0] += 1
        return out

    monkeypatch.setattr(owner, attr, wrapped if not isinstance(owner, type) else (
        lambda self, *a, **k: wrapped(self, *a, **k)))
    return seen


@pytest.mark.parametrize("name", ["SkipGram", "Second-order LINE", "GCN"])
def test_card_fit_resumes_after_a_kill(dev, name, monkeypatch, tmp_path):
    """A fit on the card killed after its second save resumes: its first
    batch equals the uninterrupted fit's at that step exactly (the draws'
    key, offset and generators came back), its result is within
    max(4 x two uninterrupted fits' difference, 1e-5) of the nearer, and the
    checkpoint is gone."""
    import embiggen_tpu_torch.utils.checkpoint as ck
    from embiggen_tpu_torch.models.embedders import SecondOrderLINE
    from embiggen_tpu_torch.models.gcn import edge as gcn_edge

    g = erdos_renyi(5000, 40000, seed=3)
    feats = np.random.default_rng(0).standard_normal((5000, 16), dtype=np.float32)
    if name == "SkipGram":
        steps = 5000 // 512

        def make(d):
            return SkipGram(embedding_size=32, walk_length=20, window_size=3, batch_size=512,
                            epochs=4, random_state=1, early_stopping_patience=100, device=dev,
                            checkpoint_dir=d, checkpoint_interval=1)

        def fit(m):
            return [np.asarray(e) for e in m.fit_transform(g).node_embeddings]
        owner, attr = SkipGram, "_sample_batch"
    elif name == "Second-order LINE":
        steps = g.number_of_directed_edges // 4096

        def make(d):
            return SecondOrderLINE(embedding_size=32, batch_size=4096, epochs=4, random_state=1,
                                   early_stopping_patience=100, device=dev, checkpoint_dir=d,
                                   checkpoint_interval=1)

        def fit(m):
            return [np.asarray(e) for e in m.fit_transform(g).node_embeddings]
        owner, attr = SecondOrderLINE, "_sample_batch"
    else:
        steps = g.number_of_directed_edges // 8192

        def make(d):
            return GCNEdgePrediction(units=[32], tower_units=[16], head_units=[16], epochs=4,
                                     batch_size=8192, random_state=1,
                                     early_stopping_patience=100, device=dev, checkpoint_dir=d,
                                     checkpoint_interval=1)

        def fit(m):
            m.fit(g, node_features=feats)
            return [t.detach().cpu().numpy() for t in param_leaves(m._params)]
        owner, attr = gcn_edge, "edge_prediction_mini_batch"
    full = []
    with monkeypatch.context() as m:
        want = _first_draw(m, owner, attr, 2 * steps)
        full.append(fit(make(None)))
    full.append(fit(make(None)))
    directory = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setattr(ck, "save_pytree", _SaveThenKill(ck.save_pytree, 2))
        with pytest.raises(KeyboardInterrupt):
            fit(make(directory))
    state = np.load(os.path.join(directory, "embed_state.npz" if name != "GCN"
                                 else "train_state.npz"))
    assert "__fingerprint__" in state.files
    with monkeypatch.context() as m:
        got = _first_draw(m, owner, attr, 0)
        resumed = fit(make(directory))
    assert os.listdir(directory) == []
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    between = max(float(np.abs(a - b).max()) for a, b in zip(*full))
    nearer = min(max(float(np.abs(a - b).max()) for a, b in zip(f, resumed)) for f in full)
    assert nearer <= max(4 * between, 1e-5), (nearer, between)


def test_card_model_loads_on_the_cpu(dev, tmp_path):
    """A GCN fitted on the card, dumped and loaded on the CPU, holds CPU
    tensors only and predicts through the CPU route within 1e-5 of the
    card."""
    from embiggen_tpu_torch.utils import dump_model, load_model

    g = erdos_renyi(3000, 20000, seed=4)
    feats = np.random.default_rng(0).standard_normal((3000, 16), dtype=np.float32)
    model = GCNEdgePrediction(units=[32], tower_units=[16], head_units=[16], epochs=3,
                              batch_size=4096, random_state=0, device=dev)
    model.fit(g, node_features=feats)
    src, dst = np.random.default_rng(1).integers(0, 3000, (2, 4096))
    on_card = model.predict_proba_from_edge_node_ids(src, dst)
    path = str(tmp_path / "gcn.pkl.gz")
    dump_model(model, path)
    loaded = load_model(path, device="cpu")
    assert loaded.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in param_leaves(loaded._params))
    np.testing.assert_allclose(loaded.predict_proba_from_edge_node_ids(src, dst), on_card,
                               rtol=0, atol=1e-5)
    back = load_model(path, device=dev)
    assert all(t.device.type == "cuda" for t in param_leaves(back._params))
    np.testing.assert_allclose(back.predict_proba_from_edge_node_ids(src, dst), on_card,
                               rtol=0, atol=1e-6)


def test_cached_calls_launch_nothing(dev, tmp_path, monkeypatch):
    """The second `embed_graph(..., enable_cache=True)` and the second
    `edge_prediction_evaluation(..., enable_cache=True)` launch no kernel
    and return the first call's results."""
    import embiggen_tpu_torch.utils.cache as cache_mod
    from embiggen_tpu_torch.graph import random_geometric
    from embiggen_tpu_torch.pipelines import edge_prediction_evaluation, embed_graph

    monkeypatch.setattr(cache_mod, "DEFAULT_CACHE_DIR", str(tmp_path / "cache"))
    g = erdos_renyi(3000, 20000, seed=4)
    results, counts = [], []
    for _ in range(2):
        _build.reset_launch_counts()
        results.append(embed_graph(g, "Node2Vec SkipGram", device=dev, embedding_size=16,
                                   epochs=1, random_state=0, enable_cache=True))
        counts.append(sum(_build.launch_counts().values()))
    assert counts[0] > 0 and counts[1] == 0
    for a, b in zip(*(r.node_embeddings for r in results)):
        np.testing.assert_array_equal(a, b)
    rows, counts = [], []
    for _ in range(2):
        _build.reset_launch_counts()
        rows.append(edge_prediction_evaluation(
            1, PerceptronEdgePrediction(edge_features=["AdamicAdar"], number_of_epochs=5,
                                        device=dev),
            random_geometric(1000, radius=0.07, seed=42), random_state=3, enable_cache=True,
            cache_dir=str(tmp_path / "cache")))
        counts.append(sum(_build.launch_counts().values()))
    assert counts[0] > 0 and counts[1] == 0 and rows[0] == rows[1]
