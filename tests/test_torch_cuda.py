"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. These need an NVIDIA GPU and nvcc, so they skip on a host
without them; run them there with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from embiggen_tpu_torch.graph import Graph, barabasi_albert, erdos_renyi
from embiggen_tpu_torch.graph.laplacians import kernel_coo
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.models.embedders import CBOW, SkipGram
from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, KipfGCNEdgePrediction
from embiggen_tpu_torch.models.edge_features import HyperSketching
from embiggen_tpu_torch.models.embedders import DegreeSPINE, DegreeWINE, WeightedSPINE
from embiggen_tpu_torch.ops import _build
from embiggen_tpu_torch.ops.bfs import (
    anchor_init_from_sets, min_plus_step, min_plus_step_plain, multi_source_distances,
)
from embiggen_tpu_torch.ops.hll import (
    edge_sketch_features, edge_sketch_features_plain, khop_sketches, khop_sketches_plain,
    singleton_registers, singleton_registers_plain,
)
from embiggen_tpu_torch.ops.cbow import cbow_update, cbow_update_plain
from embiggen_tpu_torch.ops.edge_metrics import edge_metrics, edge_metrics_plain
from embiggen_tpu_torch.ops.gather_probe import (
    table_gather_sums, tile_gather_sums, tile_gather_sums_plain,
)
from embiggen_tpu_torch.ops.glove import (
    Entries, cooccurrences, cooccurrences_plain, glove_step, glove_step_plain, glove_strides,
)
from embiggen_tpu_torch.ops.negatives import (
    edge_prediction_mini_batch, line_mini_batch, nce_negatives, siamese_mini_batch,
)
from embiggen_tpu_torch.ops.scatter import (
    SkipGramSums, mean_scatter, mean_scatter_plain, skipgram_mean_combine,
    skipgram_mean_combine_plain,
)
from embiggen_tpu_torch.ops.skipgram import skipgram_nce_update, skipgram_nce_update_plain
from embiggen_tpu_torch.ops.spmm import csr_kernel, csr_spmm_plain, spmm
from embiggen_tpu_torch.ops.walklets import walklets_update, walklets_update_plain
from embiggen_tpu_torch.ops.walks import (
    csr_edge_ids, csr_edge_ids_plain, ell_walks, first_order_walks, rejection_walks,
)
from batch_laws import (
    arc_ids, exact_p, line_negative_law_by_source, rows_p, siamese_counts,
)
from hll_checks import MAX_TIE_SHARE, feature_errors
from pq_laws import (
    Laws, arc_weights, n_tries_for, rows_of_32_and_33, two_hubs, walks_chi2_p,
)

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


@pytest.mark.parametrize("width", [None, 16, 30])
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
    # A second table updated with the counts of the first call.
    got, _ = mean_scatter(table.clone(), idx, grads, 0.05, counts)
    want, _ = mean_scatter_plain(table.clone(), idx, grads, 0.05, counts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


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
        "ell_walks", "first_order_walks", "cbow_update", "skipgram_mean_combine",
        "skipgram_nce_update")}
    assert got == {"ell_walks": int(pq), "first_order_walks": int(not pq),
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
            for d, m in models.items():
                m._run_batch_size = 256
                m._step(graphs[d], params[d], torch.Generator(), lr,
                        batch=(tuple(torch.from_numpy(x).to(d) for x in sl), ()))
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
@pytest.mark.parametrize("power, sub, length, k", [
    (4, 32, 16, 10), (4, 3, 12, 5), (1, 8, 9, 3), (3, 40, 10, 4), (3, 5, 4, 1)])
def test_walklets_kernel_matches_plain(dev, mode, power, sub, length, k):
    """K12 against its plain version: the bench's sub 32, a sub not a
    multiple of 4, P 1 and 3, a sub over one 32-column chunk, walks of
    power + 1 nodes (one pair at the top power); n 60 makes the atomics
    collide."""
    x = _walklets_inputs(dev, 60, power, sub, 48, length, k, seed=power * 7 + sub)
    _walklets_against_plain(dev, x, power, mode)


@pytest.mark.parametrize("mode", ["skipgram", "cbow"])
def test_walklets_kernel_walks_of_one_repeated_node(dev, mode):
    x = list(_walklets_inputs(dev, 60, 4, 8, 40, 12, 5, seed=3))
    x[3] = (torch.arange(40, device=dev, dtype=torch.int32) % 5)[:, None].expand(
        40, 12).contiguous()
    _walklets_against_plain(dev, x, 4, mode)


def _cooc_against_plain(walks, n, strides):
    before = _build.launch_counts()["cooccurrences"]
    got = cooccurrences(walks, n, strides)
    want = cooccurrences_plain(walks, n, strides)
    torch.cuda.synchronize()
    if sum(max(walks.shape[1] - d, 0) for d, _ in strides):
        assert _build.launch_counts()["cooccurrences"] == before + 2
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    # float64 atomics add in no fixed order; compared after the cast.
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


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


@pytest.mark.parametrize("d", [128, 30])
def test_glove_step_kernel_matches_plain(dev, d):
    rng = np.random.default_rng(d)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    e, n, b = 5000, 300, 4096
    counts = rng.uniform(0.5, 300.0, e).astype(np.float32)
    entries = Entries(t(rng.integers(0, n, e).astype(np.int32)),
                      t(rng.integers(0, n, e).astype(np.int32)),
                      t(np.minimum(1.0, (counts / 100.0) ** 0.75).astype(np.float32)),
                      t(np.log(counts)))
    tables = [t(rng.normal(size=s).astype(np.float32)) for s in ((n, d), (n, d), (n,), (n,))]
    ids = t(rng.integers(0, e, b).astype(np.int32))
    before = _build.launch_counts()["glove_step"]
    got = glove_step(entries, ids, *tables)
    want = glove_step_plain(entries, ids, *tables)
    torch.cuda.synchronize()
    assert _build.launch_counts()["glove_step"] == before + 1
    for a, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # The dot products sum in another order.
    for a, w in zip(got[2:5], want[2:5]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=0)


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
@pytest.mark.parametrize("d", [1, 30, 100])
@pytest.mark.parametrize("weighted", [False, True])
def test_min_plus_kernel_matches_plain(dev, kind, d, weighted):
    """K15a's distances and change flags equal its plain version's exactly,
    launch by launch and after 32 relaxations."""
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
    changes = torch.zeros(32, dtype=torch.int32, device=dev)
    want_changes = torch.zeros(32, dtype=torch.int32)
    got = multi_source_distances(tg, init, 32, weighted, changes)
    want = multi_source_distances(tg_cpu, init.cpu(), 32, weighted, want_changes)
    assert torch.equal(got.cpu(), want) and torch.equal(changes.cpu(), want_changes)


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


@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("hops", [1, 2, 3, 6])
def test_edge_sketch_features_kernel_matches_plain(dev, precision, hops):
    """K16b against its plain version within tests/hll_checks.py's
    tolerance, on arcs and uniform pairs."""
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
    for name in ("edge_sketch_features", "khop_sketches", "hll_registers", "csr_edge_ids"):
        assert after[name] > before[name], name
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
