"""The first-order walk step's batch (`ops.negatives.first_order_batch`: one
fused launch on the card) on the CPU: its plain version draws exactly what
the three separate calls drew (starts, walks, negatives, from one generator
in that order), so every walk-based, Walklets and GloVe fit keeps its tables
bit for bit; it follows the JAX package's `_sample_batch` in distribution
(chi-square at fixed seeds, failing at p < 1e-3: uniform starts tiled over
the iterations, moves by the exact transitions, negatives by degree or
uniform); and the fit's `BatchDraws` workspace draws its key once."""
import jax
import numpy as np
import pytest
import torch
from scipy.stats import chi2, chi2_contingency

from embiggen_tpu.models.embedders.walk_based import SkipGram as RefSkipGram
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.models.embedders import (
    CBOW, DeepWalkSkipGram, GloVe, SkipGram, WalkletsCBOW, WalkletsSkipGram,
)
from embiggen_tpu_torch.ops import negatives
from embiggen_tpu_torch.ops.negatives import (
    BatchDraws, first_order_batch, negative_nodes_for_nce, sample_nodes_uniform,
)
from embiggen_tpu_torch.ops.walks import random_walks
from walk_batch_laws import batch_p, stream_independence_p

torch.set_num_threads(1)
P_MIN = 1e-3


def _three_calls(tg, generator, batch_size, iterations, walk_length, k, scale_free):
    """The batch as the walk step drew it before the fused route: K2's,
    K1's and K2's wrappers, one after another."""
    starts = sample_nodes_uniform(tg, generator, (batch_size,))
    walks = random_walks(tg, starts.repeat(iterations), walk_length, generator)
    negs = negative_nodes_for_nce(tg, generator, k, scale_free,
                                  per_walk=batch_size * iterations)
    return walks, negs


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("iterations", [1, 3])
def test_plain_batch_draws_as_the_three_calls(weighted, scale_free, iterations):
    tg = erdos_renyi(200, 800, seed=7, weighted=weighted).device("cpu", with_alias=weighted)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    walks, negs = first_order_batch(tg, gens[0], 50, iterations, 12, 5, scale_free)
    want = _three_calls(tg, gens[1], 50, iterations, 12, 5, scale_free)
    assert walks.shape == (50 * iterations, 12) and negs.shape == (50 * iterations, 5)
    assert walks.dtype == negs.dtype == torch.int32
    assert torch.equal(walks, want[0]) and torch.equal(negs, want[1])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # A workspace is the card's: the CPU draws from the generator all the same.
    ws = BatchDraws.walks(50, iterations, 12, 5, "cpu")
    again = first_order_batch(tg, torch.Generator().manual_seed(11), 50, iterations, 12, 5,
                              scale_free, ws)
    assert torch.equal(again[0], walks) and torch.equal(again[1], negs)
    assert ws.key is None


def _old_sample_batch(model):
    """The walk step's `_sample_batch` before the fused route."""
    def sample(tg, generator, batch_size):
        starts = sample_nodes_uniform(tg, generator, (batch_size,))
        walks = random_walks(tg, starts.repeat(model._iterations), model._walk_length,
                             generator, **model._walk_kwargs())
        negs = negative_nodes_for_nce(tg, generator, model._number_of_negative_samples,
                                      model._use_scale_free_distribution,
                                      per_walk=batch_size * model._iterations)
        return walks, negs
    return sample


def _old_glove_sample_batch(ctx, generator, batch_size):
    return (torch.randint(0, ctx.n_entries, (batch_size,), generator=generator,
                          dtype=torch.int32),), ctx


FITS = [
    (SkipGram, {}), (SkipGram, dict(iterations=2, use_scale_free_distribution=False)),
    (SkipGram, dict(return_weight=2.0, explore_weight=0.5)), (CBOW, {}),
    (DeepWalkSkipGram, {}), (WalkletsSkipGram, {}), (WalkletsCBOW, dict(iterations=2)),
    (GloVe, {}),
]


@pytest.mark.parametrize("cls, kwargs", FITS, ids=lambda x: getattr(x, "__name__", str(x)))
@pytest.mark.parametrize("weighted", [False, True])
def test_cpu_fits_keep_their_tables(cls, kwargs, weighted):
    """A fit on the CPU gives exactly the tables of the same fit with the
    step's draws made as before the fused route."""
    g = erdos_renyi(120, 500, seed=3, weighted=weighted)
    base = dict(embedding_size=8, epochs=2, random_state=5, device="cpu")
    if cls is not GloVe:
        base.update(walk_length=12, window_size=3, batch_size=32)
    new, old = cls(**base, **kwargs), cls(**base, **kwargs)
    old._sample_batch = (_old_glove_sample_batch if cls is GloVe
                         else _old_sample_batch(old))
    got, want = new.fit_transform(g), old.fit_transform(g)
    for a, b in zip(got.node_embeddings, want.node_embeddings):
        np.testing.assert_array_equal(a, b)
    assert new._draws is None if cls is not GloVe else True


def _port_graph(ref):
    return Graph(row_ptr=ref.row_ptr, col_idx=ref.col_idx, directed=ref.directed,
                 name=ref.name, weights=ref.weights)


def _moves(graph, walks):
    """(source of each move, CSR position of its arc); every step is an arc
    or a stay on a zero-degree node."""
    walks = np.asarray(walks, np.int64)
    n = graph.number_of_nodes
    src, dst = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    stays = graph.degrees[src] == 0
    np.testing.assert_array_equal(dst[stays], src[stays])
    src, dst = src[~stays], dst[~stays]
    keys = graph.sources.astype(np.int64) * n + graph.col_idx
    pos = np.minimum(np.searchsorted(keys, src * n + dst), len(keys) - 1)
    assert (keys[pos] == src * n + dst).all(), "a step left the graph"
    return src, pos


def _fit_p(observed, expected):
    keep = expected >= 5
    assert keep.sum() > 20
    stat = ((observed[keep] - expected[keep]) ** 2 / expected[keep]).sum()
    return chi2.sf(stat, keep.sum() - 1)


def _two_sample_p(a, b):
    keep = (a + b) >= 10
    assert keep.sum() > 20
    return chi2_contingency(np.stack([a[keep], b[keep]]))[1]


def _transition_p(graph, src, pos):
    """Pooled chi-square of the moves against the exact transitions."""
    w = (np.ones(graph.number_of_directed_edges) if graph.weights is None
         else graph.weights.astype(np.float64))
    row_sum = np.bincount(graph.sources, weights=w, minlength=graph.number_of_nodes)
    observed = np.bincount(pos, minlength=graph.number_of_directed_edges)
    n_from = np.bincount(src, minlength=graph.number_of_nodes)
    expected = n_from[graph.sources] * w / row_sum[graph.sources]
    ok = np.ones(graph.number_of_nodes, bool)
    np.logical_and.at(ok, graph.sources, expected >= 5)
    cells = ok[graph.sources]
    stat = ((observed - expected) ** 2 / expected)[cells].sum()
    return chi2.sf(stat, cells.sum() - np.unique(graph.sources[cells]).size)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale_free", [True, False])
def test_plain_batch_follows_the_jax_sample_batch(karate, er_graph, weighted, scale_free):
    ref_graph = er_graph if weighted else karate
    port = _port_graph(ref_graph)
    n = port.number_of_nodes
    b, iterations, length, k = 3000, 2, 8, 5
    ref = RefSkipGram(walk_length=length, window_size=2, iterations=iterations,
                      number_of_negative_samples=k, use_scale_free_distribution=scale_free)
    theirs = [np.asarray(x) for x in ref._sample_batch(
        ref_graph.device(with_alias=weighted), jax.random.PRNGKey(0), b)]
    ours = [x.numpy() for x in first_order_batch(
        port.device("cpu", with_alias=weighted), torch.Generator().manual_seed(0), b,
        iterations, length, k, scale_free)]
    p = {}
    counts = {}
    for name, (walks, negs) in (("port", ours), ("jax", theirs)):
        assert walks.shape == (b * iterations, length) and negs.shape == (b * iterations, k)
        # Starts: uniform, the same for walk i and walk i + B.
        np.testing.assert_array_equal(walks[:b, 0], walks[b:, 0])
        starts = np.bincount(walks[:b, 0], minlength=n)
        p[f"{name} starts"] = _fit_p(starts, np.full(n, b / n))
        src, pos = _moves(port, walks)
        p[f"{name} moves"] = _transition_p(port, src, pos)
        drawn = np.bincount(negs.ravel(), minlength=n).astype(np.float64)
        law = port.degrees / port.degrees.sum() if scale_free else np.full(n, 1.0 / n)
        p[f"{name} negatives"] = _fit_p(drawn, negs.size * law)
        counts[name] = (starts.astype(np.float64),
                        np.bincount(pos, minlength=port.number_of_directed_edges)
                        .astype(np.float64), drawn)
    for i, part in enumerate(("starts", "moves", "negatives")):
        p[f"{part} port vs jax"] = _two_sample_p(counts["port"][i], counts["jax"][i])
    failed = {key: v for key, v in p.items() if not v > P_MIN}
    assert not failed, failed


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale_free", [True, False])
def test_plain_batch_meets_the_exact_laws(weighted, scale_free):
    """`tests/walk_batch_laws.py`, which holds the kernel on the card, on
    the plain version: starts, moves and negatives by their exact laws and,
    unweighted, the start, the first step and the negatives independent."""
    tg = erdos_renyi(300, 1500, seed=4, weighted=weighted).device("cpu", with_alias=weighted)
    walks, negs = first_order_batch(tg, torch.Generator().manual_seed(2), 6000, 2, 6, 6,
                                    scale_free)
    p = batch_p(tg, walks, negs, 6000, scale_free)
    if not weighted:
        p.update(stream_independence_p(tg, walks, negs, 6000, scale_free))
    failed = {key: v for key, v in p.items() if not v > P_MIN}
    assert not failed, failed


def test_the_laws_refuse_a_wrong_batch():
    """The checks see a batch whose streams share their draws, or whose
    starts do not tile, or that leaves the graph."""
    tg = erdos_renyi(300, 1500, seed=4).device("cpu")
    walks, negs = first_order_batch(tg, torch.Generator().manual_seed(2), 6000, 2, 6, 6, True)
    # Negative 0 drawn from the same word as the start: start bin = negative bin.
    coupled = negs.clone()
    coupled[:, 0] = walks[:, 0]
    assert stream_independence_p(tg, walks, coupled, 6000, True)["start, negative 0"] < P_MIN
    untiled = walks.clone()
    untiled[6000:, 0] = untiled[:6000, 0].flip(0)
    with pytest.raises(AssertionError, match="tiled"):
        batch_p(tg, untiled, negs, 6000, True)
    off = walks.clone()
    off[:, 1] = (off[:, 1] + 1) % 300
    with pytest.raises(AssertionError, match="arc"):
        batch_p(tg, off, negs, 6000, True)


def test_workspace_views_and_key():
    ws = BatchDraws.walks(6, 3, 5, 4, "cpu")
    walks, negs, starts = ws.views
    assert walks.shape == (18, 5) and negs.shape == (18, 4) and starts.shape == (6,)
    assert ws.block.shape == (18 * 9 + 6,)
    for view in ws.views:
        assert view.untyped_storage().data_ptr() == ws.block.untyped_storage().data_ptr()
    assert starts.data_ptr() == ws.block.data_ptr() + 4 * 18 * 9
    # The key is drawn from the fit's generator at the first batch, once;
    # each batch then takes the next offset.
    gen = torch.Generator().manual_seed(3)
    first = ws.seed(gen)
    state = gen.get_state()
    seeds = [ws.seed(gen) for _ in range(3)]
    assert torch.equal(gen.get_state(), state)
    assert [s[0] for s in seeds] == [first[0]] * 3
    assert [first[1]] + [s[1] for s in seeds] == [0, 1, 2, 3]
    assert first == (BatchDraws(torch.empty(1)).seed(torch.Generator().manual_seed(3))[0], 0)


def test_walk_arc_records_export():
    """`Graph.device(with_walk_arcs=True)`: each arc's (head, head's row
    start, head's degree, 0), which the card's walk kernels read in place
    of row_ptr; not with alias tables, whose weighted steps read rows."""
    g = Graph.from_edge_arrays(np.array([0, 0, 1, 3]), np.array([1, 2, 2, 3]), n_nodes=6)
    tg = g.device("cpu", with_walk_arcs=True)
    heads = tg.col_idx.long()
    want = torch.stack([tg.col_idx, tg.row_ptr[heads], tg.degrees[heads],
                        torch.zeros_like(tg.col_idx)], 1)
    assert tg.walk_arcs.dtype == torch.int32 and torch.equal(tg.walk_arcs, want)
    assert g.device("cpu").walk_arcs is None
    weighted = erdos_renyi(40, 100, seed=1, weighted=True)
    assert weighted.device("cpu", with_alias=True, with_walk_arcs=True).walk_arcs is None
    assert weighted.device("cpu", with_walk_arcs=True).walk_arcs is not None
    # The walk models ask for them on the card only; biased walks never.
    assert SkipGram(device="cpu")._device_graph(g).walk_arcs is None


def test_model_draws_on_the_cpu_need_no_workspace():
    g = erdos_renyi(60, 200, seed=1)
    model = SkipGram(embedding_size=4, walk_length=8, window_size=2, device="cpu")
    tg = g.device("cpu")
    assert model._batch_draws(tg, 16) is None
    walks, negs = model._sample_batch(tg, torch.Generator().manual_seed(0), 16)
    assert walks.shape == (16, 8) and negs.shape == (16, 10)


def test_first_order_batch_refuses_what_it_cannot_draw():
    tg = erdos_renyi(30, 60, seed=1).device("cpu")
    with pytest.raises(ValueError, match="walk_length"):
        first_order_batch(tg, torch.Generator(), 4, 1, 0, 2)
    meta = erdos_renyi(30, 60, seed=1).device("meta")
    with pytest.raises(ValueError, match="meta"):
        first_order_batch(meta, torch.Generator(), 4, 1, 5, 2)
    ws = BatchDraws.walks(4, 1, 5, 2, "cpu")
    with pytest.raises(ValueError, match="workspace"):
        negatives._walk_workspace_views(
            ws, BatchDraws.walk_shapes(4, 2, 5, 2), torch.device("cpu"))
