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
from embiggen_tpu_torch.models.gcn import KipfGCNEdgePrediction
from embiggen_tpu_torch.ops import _build
from embiggen_tpu_torch.ops.cbow import cbow_update, cbow_update_plain
from embiggen_tpu_torch.ops.edge_metrics import edge_metrics, edge_metrics_plain
from embiggen_tpu_torch.ops.gather_probe import (
    table_gather_sums, tile_gather_sums, tile_gather_sums_plain,
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
from embiggen_tpu_torch.ops.walks import (
    csr_edge_ids, csr_edge_ids_plain, ell_walks, first_order_walks, rejection_walks,
)
from batch_laws import (
    arc_ids, exact_p, line_negative_law_by_source, rows_p, siamese_counts,
)
from pq_laws import Laws, n_tries_for, walks_chi2_p

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


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("n, d, length, window, k", [
    (300, 48, 20, 4, 7), (300, 30, 12, 3, 5), (60, 16, 12, 1, 5)])
def test_cbow_kernel_matches_plain(dev, with_center_w, n, d, length, window, k):
    """K11's sums and counts against its plain version's (autograd
    gradients added with index_add_), then K4's combine on CBOW's tables;
    n 60 makes the atomics collide."""
    x = _skipgram_inputs(dev, n, d, 64, length, k, with_center_w, seed=d)
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
