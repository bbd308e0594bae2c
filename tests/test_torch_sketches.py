"""The port's sketch ops and embedders on the CPU, held to embiggen_tpu on the
same inputs: the multi-source distances of SPINE (kernel K15a's plain
version) and the window counts of WINE (K7 at unit values) exactly, every
SPINE and WINE row's embedding exactly, RUBICONE and RUINE on injected
features within rtol 1e-5 (sums in another order) and their own draws by
their moments, the HLL registers and k-hop sketches (K16a) exactly, and the
sketch features (K16b) and HyperSketching's within 1e-5 of the pair's
scale.

The features' tolerance and the treatment of a near tie at linear
counting's threshold (the pair is held to its float64 features under
either branch; at most 0.3% of the pairs may have one, and none does on
these inputs) are `tests/hll_checks.py`'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models import edge_features as ref_edge_features
from embiggen_tpu.models.embedders import spine as ref_spine
from embiggen_tpu.ops import bfs as ref_bfs
from embiggen_tpu.ops import hll as ref_hll
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.models.edge_features import HyperSketching
from embiggen_tpu_torch.models.embedders import spine
from embiggen_tpu_torch.ops import bfs, hll
from hll_checks import MAX_TIE_SHARE, feature_errors
from hll_checks import RTOL as FEATURE_RTOL

torch.set_num_threads(1)


def _pair(kind):
    """The same graph built by both packages."""
    if kind in ("er", "weighted"):
        kw = dict(n_nodes=200, n_edges=700, seed=2, weighted=kind == "weighted")
        return erdos_renyi(**kw), ref_erdos_renyi(**kw)
    rng = np.random.default_rng(11)
    if kind == "components":   # two components and ten isolated nodes
        a = rng.integers(0, 80, (2, 200))
        b = rng.integers(80, 150, (2, 150))
        src, dst = np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])
        kw = dict(n_nodes=160, directed=False)
    else:                     # directed
        src, dst = rng.integers(0, 150, (2, 400))
        kw = dict(n_nodes=150, directed=True)
    w = rng.uniform(0.1, 3.0, len(src)).astype(np.float32)
    return (Graph.from_edge_arrays(src, dst, weights=w, **kw),
            RefGraph.from_edge_arrays(src, dst, weights=w, **kw))


GRAPHS = ["er", "weighted", "components", "directed"]


@pytest.fixture(scope="module", params=GRAPHS)
def graphs(request):
    g, rg = _pair(request.param)
    assert np.array_equal(g.col_idx, rg.col_idx) and np.array_equal(g.row_ptr, rg.row_ptr)
    return g, rg


ANCHOR_SETS = [np.array([i]) for i in range(6)] + [np.array([3, 50, 100, 120]), np.array([], int)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("depth", [1, 4, 32])
def test_multi_source_distances_match_reference(graphs, weighted, depth):
    g, rg = graphs
    n = g.number_of_nodes
    if weighted and g.weights is None:   # both packages refuse
        for fn, dg, init in ((bfs.multi_source_distances, g.device("cpu"),
                              bfs.anchor_init_from_sets(n, ANCHOR_SETS, "cpu")),
                             (ref_bfs.multi_source_distances, rg.device(),
                              ref_bfs.anchor_init_from_sets(n, ANCHOR_SETS))):
            with pytest.raises(ValueError, match="require edge weights"):
                fn(dg, init, max_depth=depth, weighted=True)
        return
    changes = torch.zeros(depth, dtype=torch.int32)
    got = bfs.multi_source_distances(g.device("cpu"), bfs.anchor_init_from_sets(n, ANCHOR_SETS, "cpu"),
                                     max_depth=depth, weighted=weighted, changes=changes)
    want = ref_bfs.multi_source_distances(
        rg.device(with_weights=weighted), ref_bfs.anchor_init_from_sets(n, ANCHOR_SETS),
        max_depth=depth, weighted=weighted)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # An iteration is flagged exactly when it moved a distance.
    prev = bfs.anchor_init_from_sets(n, ANCHOR_SETS, "cpu")
    for i in range(depth):
        nxt = bfs.min_plus_step_plain(g.device("cpu"), prev, weighted)
        assert int(changes[i]) == int(bool((nxt != prev).any()))
        prev = nxt


def _counted_relaxations(monkeypatch):
    """A list that gains one entry per relaxation `multi_source_distances`
    runs (a call of the K15a wrapper)."""
    calls, step = [], bfs.min_plus_step

    def counted(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)
    monkeypatch.setattr(bfs, "min_plus_step", counted)
    return calls


def _settling(g, init, weighted):
    """Index of the first relaxation that moves no distance."""
    dist, i = init, 0
    while True:
        nxt = bfs.min_plus_step_plain(g.device("cpu"), dist, weighted)
        if torch.equal(nxt, dist):
            return i
        dist, i = nxt, i + 1


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_source_distances_stop_at_the_first_unchanged_relaxation(
        graphs, weighted, monkeypatch):
    """The early-stopped distances equal the reference's full scan of 32
    bodies exactly, after the first unchanged relaxation + 1 relaxations,
    with the flags of the relaxations after the stop left 0."""
    g, rg = graphs
    if weighted and g.weights is None:
        g, rg = _pair("weighted")
    n = g.number_of_nodes
    init = bfs.anchor_init_from_sets(n, ANCHOR_SETS, "cpu")
    settle = _settling(g, init, weighted)
    assert settle < 32
    calls = _counted_relaxations(monkeypatch)
    changes = torch.zeros(32, dtype=torch.int32)
    got = bfs.multi_source_distances(g.device("cpu"), init, 32, weighted, changes)
    want = ref_bfs.multi_source_distances(
        rg.device(with_weights=weighted), ref_bfs.anchor_init_from_sets(n, ANCHOR_SETS),
        max_depth=32, weighted=weighted)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(calls) == settle + 1
    assert changes.tolist() == [1] * settle + [0] * (32 - settle)


def test_multi_source_distances_below_the_settling_depth(monkeypatch):
    """A path of 12 nodes at depth 2 runs exactly 2 relaxations and matches
    the reference's truncated scan; SPINE maps what 2 did not reach to
    depth + 1, as the reference does."""
    src, dst = np.arange(11), np.arange(1, 12)
    g = Graph.from_edge_arrays(src, dst, n_nodes=12)
    rg = RefGraph.from_edge_arrays(src, dst, n_nodes=12)
    sets = [np.array([0]), np.array([5]), np.array([11])]
    calls = _counted_relaxations(monkeypatch)
    got = bfs.multi_source_distances(g.device("cpu"), bfs.anchor_init_from_sets(12, sets, "cpu"), 2)
    want = ref_bfs.multi_source_distances(
        rg.device(with_weights=False), ref_bfs.anchor_init_from_sets(12, sets), max_depth=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(calls) == 2 and bool((got == bfs.UNREACHED).any())
    port = spine.DegreeSPINE(device="cpu", embedding_size=3, maximum_depth=2, dtype=None)
    ref = ref_spine.DegreeSPINE(embedding_size=3, maximum_depth=2, dtype=None)
    emb = port.fit_transform(g).node_embeddings[0]
    np.testing.assert_array_equal(emb, np.asarray(ref.fit_transform(rg).node_embeddings[0]))
    assert (emb == 3.0).any() and emb.max() == 3.0


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_source_distances_keep_a_disconnected_graphs_unreached_entries(
        weighted, monkeypatch):
    """Anchors in one component of a graph with another component and
    isolated nodes: the early stop leaves every entry outside it UNREACHED,
    as the reference's full scan does."""
    g, rg = _pair("components")
    n = g.number_of_nodes
    sets = [np.array([3]), np.array([10, 40]), np.array([], int)]
    init = bfs.anchor_init_from_sets(n, sets, "cpu")
    calls = _counted_relaxations(monkeypatch)
    got = bfs.multi_source_distances(g.device("cpu"), init, 32, weighted)
    want = ref_bfs.multi_source_distances(
        rg.device(with_weights=weighted), ref_bfs.anchor_init_from_sets(n, sets),
        max_depth=32, weighted=weighted)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(calls) == _settling(g, init, weighted) + 1 < 32
    assert bool((got[80:] == bfs.UNREACHED).all()) and bool((got[:, 2] == bfs.UNREACHED).all())


@pytest.mark.parametrize("window", [1, 2, 3])
def test_window_cooccurrence_counts_match_reference(graphs, window):
    g, rg = graphs
    membership = (bfs.anchor_init_from_sets(g.number_of_nodes, ANCHOR_SETS, "cpu") == 0).float()
    got = bfs.window_cooccurrence_counts(g.device("cpu"), membership, window)
    want = ref_bfs.window_cooccurrence_counts(
        rg.device(with_weights=False), jnp.asarray(membership.numpy()), window_size=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scores(n):
    return np.random.default_rng(5).random(n)


ROWS = [
    ("DegreeSPINE", dict(embedding_size=12)),
    ("DegreeSPINE", dict(embedding_size=12, maximum_depth=3, dtype="u16")),
    ("DegreeSPINE", dict(embedding_size=300, maximum_depth=2, dtype=None)),
    ("DegreeWINE", dict(embedding_size=12)),
    ("DegreeWINE", dict(embedding_size=12, window_size=4, dtype="u16")),
    ("DegreeWINE", dict(embedding_size=12, window_size=3, dtype="f32")),
    ("ScoreSPINE", dict(embedding_size=12, maximum_depth=5)),
    ("ScoreWINE", dict(embedding_size=12, window_size=3)),
    ("WeightedSPINE", dict(embedding_size=12)),
    ("WeightedSPINE", dict(embedding_size=12, dtype=None)),
    ("WeightedSPINE", dict(embedding_size=12, use_reciprocal_weights=True)),
    ("WeightedSPINE", dict(embedding_size=12, use_reciprocal_weights=True, dtype=None,
                           maximum_depth=6)),
]


@pytest.mark.parametrize("cls, kwargs", ROWS)
def test_spine_and_wine_rows_match_reference(graphs, cls, kwargs):
    g, rg = graphs
    if cls == "WeightedSPINE" and g.weights is None:
        g, rg = _pair("weighted")
    if cls.startswith("Score"):
        kwargs = dict(kwargs, scores=_scores(g.number_of_nodes))
    port = getattr(spine, cls)(device="cpu", **kwargs)
    ref = getattr(ref_spine, cls)(**kwargs)
    got = port.fit_transform(g)
    want = ref.fit_transform(rg)
    assert got.embedding_method_name == want.embedding_method_name
    assert got.node_embeddings[0].dtype == want.node_embeddings[0].dtype
    np.testing.assert_array_equal(got.node_embeddings[0], np.asarray(want.node_embeddings[0]))
    np.testing.assert_array_equal(got._node_names, want._node_names)
    params = {k: v for k, v in port.parameters().items() if k != "scores"}
    assert params == {k: v for k, v in ref.parameters().items() if k != "scores"}


@pytest.mark.parametrize("cls", ["NodeLabelSPINE", "NodeLabelWINE"])
def test_node_label_rows_raise_the_references_error(cls):
    g, rg = _pair("er")
    with pytest.raises(ValueError) as want:
        getattr(ref_spine, cls)().fit_transform(rg)
    with pytest.raises(ValueError, match="requires node types") as got:
        getattr(spine, cls)(device="cpu").fit_transform(g)
    assert str(got.value) == str(want.value)


def test_weighted_spine_requires_weights():
    g, rg = _pair("er")
    with pytest.raises(ValueError) as want:
        ref_spine.WeightedSPINE().fit_transform(rg)
    with pytest.raises(ValueError, match="requires edge weights") as got:
        spine.WeightedSPINE(device="cpu").fit_transform(g)
    assert str(got.value) == str(want.value)


def test_score_rows_need_matching_scores():
    g, _ = _pair("er")
    with pytest.raises(ValueError, match="requires a `scores` array"):
        spine.ScoreSPINE(device="cpu").fit_transform(g)
    with pytest.raises(ValueError, match="scores has 3 entries"):
        spine.ScoreWINE(device="cpu", scores=np.ones(3)).fit_transform(g)


@pytest.mark.parametrize("cls", ["RUBICONE", "RUINE"])
@pytest.mark.parametrize("convolutions", [1, 2])
def test_random_convolutions_match_reference_on_injected_features(graphs, monkeypatch, cls,
                                                                  convolutions):
    g, rg = graphs
    x = np.random.default_rng(3).random((g.number_of_nodes, 16)).astype(np.float32)
    monkeypatch.setattr(getattr(ref_spine, cls), "_random_features",
                        lambda self, key, shape: jnp.asarray(x))
    monkeypatch.setattr(getattr(spine, cls), "_random_features",
                        lambda self, generator, shape: torch.from_numpy(x))
    kw = dict(embedding_size=16, number_of_convolutions=convolutions, random_state=4)
    got = getattr(spine, cls)(device="cpu", **kw).fit_transform(g).node_embeddings[0]
    want = getattr(ref_spine, cls)(**kw).fit_transform(rg).node_embeddings[0]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cls", ["RUBICONE", "RUINE"])
def test_random_convolutions_draw_like_the_reference(cls):
    """The port's own draws (torch) against the reference's (jax.random) by
    their moments, with no convolution; then two convolutions of the
    row-normalized Laplacian keep the mean of connected rows."""
    g, rg = _pair("er")
    kw = dict(embedding_size=64, number_of_convolutions=0, random_state=9)
    got = getattr(spine, cls)(device="cpu", **kw).fit_transform(g).node_embeddings[0]
    want = np.asarray(getattr(ref_spine, cls)(**kw).fit_transform(rg).node_embeddings[0])
    var = 0.25 if cls == "RUBICONE" else 1.0 / 12.0
    for x in (got, want):
        assert x.shape == (200, 64) and x.min() >= 0.0 and x.max() <= 1.0
        assert abs(x.mean() - 0.5) < 0.01 and abs(x.var() - var) < 0.01
    if cls == "RUBICONE":
        assert set(np.unique(got)) == {0.0, 1.0}
    again = getattr(spine, cls)(device="cpu", **kw).fit_transform(g).node_embeddings[0]
    other = getattr(spine, cls)(device="cpu", **dict(kw, random_state=10)).fit_transform(
        g).node_embeddings[0]
    assert np.array_equal(got, again) and not np.array_equal(got, other)
    smooth = getattr(spine, cls)(device="cpu", **dict(kw, number_of_convolutions=2)
                                 ).fit_transform(g).node_embeddings[0]
    assert abs(smooth[g.degrees > 0].mean() - 0.5) < 0.01


@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("bits, seed", [(6, 0), (5, 7), (8, 2**40 + 3)])
def test_singleton_registers_match_reference(precision, bits, seed):
    got = hll.singleton_registers(3000, precision, bits, seed=seed, device="cpu")
    want = ref_hll.singleton_registers(3000, precision, bits, seed=seed)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sketches(g, rg, precision, hops, seed=1):
    base = hll.singleton_registers(g.number_of_nodes, precision, 6, seed=seed, device="cpu")
    got = hll.khop_sketches(g.device("cpu"), base, hops)
    want = ref_hll.khop_sketches(rg.device(), jnp.asarray(base.numpy()), hops)
    return got, np.transpose(np.asarray(want), (1, 0, 2))


@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("hops", [1, 3])
def test_khop_sketches_match_reference(graphs, precision, hops):
    g, rg = graphs
    got, want = _sketches(g, rg, precision, hops)
    assert got.shape == (g.number_of_nodes, hops, 1 << precision)
    np.testing.assert_array_equal(got.numpy(), want)


def _hub_pair():
    """The same graph in both packages: erdos_renyi(300, 900) plus three
    hubs of 250, 120 and 60 random neighbours, rows well past a split of 8."""
    rng = np.random.default_rng(13)
    g = erdos_renyi(300, 900, seed=1)
    one = g.sources < g.col_idx
    hubs = np.repeat([300, 301, 302], [250, 120, 60])
    src = np.concatenate([g.sources[one], hubs])
    dst = np.concatenate([g.col_idx[one], rng.integers(0, 303, len(hubs))])
    kw = dict(n_nodes=303, directed=False)
    return Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)


@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("split", [8, 64])
def test_split_hop_plain_matches_plain_and_reference(precision, split):
    """The hop launch's split route (chunk maxima of `split` arcs, then each
    long row merged with its chunks) equals the unsplit plain hops and the
    JAX package's khop_sketches byte for byte: a max is exact in any order."""
    g, rg = _hub_pair()
    tg = g.device("cpu")
    assert tg.row_plan(split).n_rows >= 2
    base = hll.singleton_registers(g.number_of_nodes, precision, 6, seed=42, device="cpu")
    got = hll.khop_sketches_split_plain(tg, base, 3, split)
    want = ref_hll.khop_sketches(rg.device(), jnp.asarray(base.numpy()), 3)
    np.testing.assert_array_equal(got.numpy(), np.transpose(np.asarray(want), (1, 0, 2)))
    assert torch.equal(got, hll.khop_sketches_plain(tg, base, 3))


def test_hop_slots_follow_the_lanes_a_row():
    """A group of HOP_LANES lanes a row where its M / 16 pieces are fewer
    and divide a warp (the slots, a power of two), else a lane a piece."""
    assert [hll.hop_slots(1 << p) for p in range(4, 13)] == [
        max(1, hll.HOP_LANES // (1 << p >> 4)) for p in range(4, 13)]
    assert [hll.hop_slots(16 * u) for u in (1, 2, 3, 4, 5, 8)] == [8, 4, 1, 2, 1, 1]


def _compare_features(sk, src, dst, precision, got, want):
    """Hold `got` to `want` at the stated tolerance (pairs with a near tie
    to their features under either branch); return how many had one."""
    worst, ties = feature_errors(sk, src, dst, precision, got, want)
    assert worst <= 1.0, worst
    return ties


def _features_against_reference(sk, src, dst, precision):
    """K16b's features (the plain version here) of the pairs against the
    reference's, at the stated tolerance."""
    hops = sk.shape[1]
    got = hll.edge_sketch_features(sk, torch.from_numpy(src).int(), torch.from_numpy(dst).int(),
                                   precision).numpy()
    skn = sk.numpy()
    want = np.asarray(ref_hll.edge_sketch_features(jnp.asarray(skn[src]), jnp.asarray(skn[dst]),
                                                   precision))
    assert got.shape == (len(src), hops * hops + 2 * hops) and got.dtype == np.float32
    assert _compare_features(sk, src, dst, precision, got, want) <= MAX_TIE_SHARE * len(src)
    return got


def _feature_pairs(g, seed):
    rng = np.random.default_rng(seed)
    arcs = rng.integers(0, g.number_of_directed_edges, 300)
    src = np.concatenate([g.sources[arcs], rng.integers(0, g.number_of_nodes, 300)])
    dst = np.concatenate([g.col_idx[arcs], rng.integers(0, g.number_of_nodes, 300)])
    return src, dst


@pytest.mark.parametrize("precision", [4, 8, 12])
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_edge_sketch_features_match_reference(graphs, precision, hops):
    g, rg = graphs
    sk, _ = _sketches(g, rg, precision, hops)
    _features_against_reference(sk, *_feature_pairs(g, precision + hops), precision)


@pytest.mark.parametrize("precision", [5, 6, 10])
@pytest.mark.parametrize("hops", [1, 3])
def test_edge_sketch_features_match_reference_at_other_precisions(graphs, precision, hops):
    """Precisions 5 and 6 take `_alpha_mm`'s own constants (4 does too), 10
    the general one; K16b's lanes a pair differ at each (1, 2 and 32)."""
    g, rg = graphs
    sk, _ = _sketches(g, rg, precision, hops)
    _features_against_reference(sk, *_feature_pairs(g, precision + 10 * hops), precision)


@pytest.mark.parametrize("precision", [4, 8, 12])
def test_edge_sketch_features_of_self_pairs_match_reference(graphs, precision):
    """Pairs with src == dst: each union is the larger ball itself (the
    hops nest), so the overlaps are the smaller ball's cardinality and the
    differences vanish, in both packages."""
    g, rg = graphs
    hops = 3
    sk, _ = _sketches(g, rg, precision, hops)
    nodes = np.random.default_rng(precision).integers(0, g.number_of_nodes, 200)
    got = _features_against_reference(sk, nodes, nodes, precision)
    card = hll.hll_cardinality(sk[nodes], precision).numpy()
    small = np.minimum(np.arange(hops)[:, None], np.arange(hops)[None, :]).reshape(-1)
    scale = 1e-5 * (1 + card.max())
    np.testing.assert_allclose(got[:, :hops * hops], card[:, small], rtol=0, atol=scale)
    assert np.abs(got[:, hops * hops:]).max() <= scale


def test_hll_cardinality_matches_reference():
    regs = np.random.default_rng(0).integers(0, 9, (50, 3, 256)).astype(np.uint8)
    regs[:10] = 0
    regs[10:20, :, :200] = 0
    got = hll.hll_cardinality(torch.from_numpy(regs), 8).numpy()
    want = np.asarray(ref_hll.hll_cardinality(jnp.asarray(regs), 8))
    np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL)


@pytest.mark.parametrize("normalize, zero_out", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_hyper_sketching_matches_reference(normalize, zero_out):
    """Features of the graph's arcs (whose balls overlap, so a normalized
    row divides by a cardinality, not by rounding noise): with
    `normalize` every entry is a share of its row's largest, so the
    tolerance is twice 1e-5 of the scale over that largest entry."""
    g, rg = _pair("er")
    kw = dict(number_of_hops=2, precision=6, normalize=normalize,
              zero_out_differences_cardinalities=zero_out, random_state=3)
    port = HyperSketching(device="cpu", **kw).fit(g)
    ref = ref_edge_features.HyperSketching(**kw).fit(rg)
    assert port.parameters() == ref.parameters()
    assert port.get_feature_dictionary_shapes() == ref.get_feature_dictionary_shapes()
    src, dst = g.sources, g.col_idx
    got = port.get_edge_feature_from_edge_node_ids(src, dst)["edge_features"]
    if zero_out:
        # The reference writes into the read-only host view of a JAX array
        # here (edge_features.py:146-147) and raises; its lines 146-151 are
        # applied to its features without the two options instead.
        with pytest.raises(ValueError, match="read-only"):
            ref.get_edge_feature_from_edge_node_ids(src, dst)
        plain = ref_edge_features.HyperSketching(**dict(kw, normalize=False,
                                                        zero_out_differences_cardinalities=False))
        want = np.array(plain.fit(rg).get_edge_feature_from_edge_node_ids(src, dst)[
            "edge_features"])
        want[:, 4:] = 0.0
        if normalize:
            want = want / np.maximum(want.max(axis=1, keepdims=True), 1e-9)
    else:
        want = np.asarray(ref.get_edge_feature_from_edge_node_ids(src, dst)["edge_features"])
    raw = port.device_feature_fn()(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    assert got.shape == want.shape == (g.number_of_directed_edges, 8)
    if zero_out:
        assert not got[:, 4:].any()
    sk = port._sketches
    if normalize:
        largest = raw[:, :4 if zero_out else 8].max(1, keepdims=True)
        assert (largest > 1.0).all()
        union = np.maximum(sk.numpy()[src][:, -1], sk.numpy()[dst][:, -1])
        scale = 1.0 + hll.hll_cardinality(torch.from_numpy(union), 6).numpy()[:, None]
        assert (np.abs(got - want) <= 2 * FEATURE_RTOL * scale / largest).all()
    else:
        assert _compare_features(sk, src, dst, 6, got, want) == 0
    emb = port.fit_transform(g)
    assert emb.edge_embeddings[0].shape == (g.number_of_directed_edges, 8)
    np.testing.assert_array_equal(emb.edge_embeddings[0], got)


def test_hyper_sketching_needs_a_fit_and_a_precision():
    with pytest.raises(ValueError, match="fitted first"):
        HyperSketching(device="cpu").device_feature_fn()
    with pytest.raises(ValueError, match="precision"):
        HyperSketching(precision=3, device="cpu")


NAMES = ["Degree-based SPINE", "Degree-based WINE", "Score-based SPINE", "Score-based WINE",
         "WeightedSPINE", "RUBICONE", "RUINE", "HyperSketching"]


@pytest.mark.parametrize("name", NAMES)
def test_embed_graph_smoke(name):
    g = erdos_renyi(60, 240, seed=1, weighted=name == "WeightedSPINE")
    kw = {"scores": _scores(60)} if name.startswith("Score") else {}
    if name in ("RUBICONE", "RUINE", "HyperSketching"):
        kw["random_state"] = 0
    result = embed_graph(g, name, device="cpu", smoke_test=True, **kw)
    assert result.embedding_method_name == name
    if name == "HyperSketching":
        assert result.edge_embeddings[0].shape == (g.number_of_directed_edges, 8)
    else:
        assert result.node_embeddings[0].shape == (60, 5)
        assert np.isfinite(result.node_embeddings[0].astype(np.float32)).all()
