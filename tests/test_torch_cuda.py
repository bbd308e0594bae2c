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
from embiggen_tpu_torch.models.embedders import SkipGram
from embiggen_tpu_torch.models.gcn import KipfGCNEdgePrediction
from embiggen_tpu_torch.ops import _build
from embiggen_tpu_torch.ops.edge_metrics import edge_metrics, edge_metrics_plain
from embiggen_tpu_torch.ops.gather_probe import (
    table_gather_sums, tile_gather_sums, tile_gather_sums_plain,
)
from embiggen_tpu_torch.ops.negatives import edge_prediction_mini_batch, nce_negatives
from embiggen_tpu_torch.ops.scatter import mean_scatter, mean_scatter_plain
from embiggen_tpu_torch.ops.skipgram import skipgram_nce_grads, skipgram_nce_grads_plain
from embiggen_tpu_torch.ops.spmm import csr_kernel, csr_spmm_plain, spmm
from embiggen_tpu_torch.ops.walks import csr_edge_ids, csr_edge_ids_plain, first_order_walks

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("with_center_w", [False, True])
def test_skipgram_kernel_matches_plain(dev, with_center_w):
    rng = np.random.default_rng(0)
    n, d, b, length, k = 300, 48, 40, 20, 7
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ne = t((0.3 * rng.normal(size=(n, d))).astype(np.float32))
    ce = t((0.3 * rng.normal(size=(n, d))).astype(np.float32))
    cb = t((4.0 * rng.normal(size=n)).astype(np.float32))
    walks = t(rng.integers(0, n, (b, length)).astype(np.int32))
    negs = t(rng.integers(0, n, (b, k)).astype(np.int32))
    cw = t(rng.uniform(0, 2, (b, length)).astype(np.float32)) if with_center_w else None
    before = _build.launch_counts()["skipgram_nce_grads"]
    got = skipgram_nce_grads(ne, ce, cb, walks, negs, 4, 6.0, cw)
    want = skipgram_nce_grads_plain(ne, ce, cb, walks, negs, 4, 6.0, cw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["skipgram_nce_grads"] == before + 1
    for a, w in zip((got[0],) + got[1] + got[2], (want[0],) + want[1] + want[2]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("width", [None, 16])
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
    got, counts = mean_scatter(table.clone(), idx, grads, 0.05)
    want, want_counts = mean_scatter_plain(table.clone(), idx, grads, 0.05)
    torch.testing.assert_close(counts, want_counts, rtol=0, atol=0)
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
