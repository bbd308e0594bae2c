"""The port's p/q (second-order) walks on the CPU: the ELL export equals the
JAX package's byte for byte; the plain versions of K9 (the ELL step) and K10
(the rejection step), the exact oracle, and the JAX package's own three
samplers each match the exact transition probabilities computed in numpy
from the graph (total variation < 0.03, and chi-square p >= 1e-3 against
each sampler's own law: the p/q probabilities, or for the rejection samplers
those probabilities with the law of their all-reject residual, which is
computed exactly too); whole walks follow arcs and visit nodes as the JAX
walks do; and `random_walks` routes as the JAX version does. Inputs come from
fixed seeds, so each test's outcome is fixed."""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pq_laws
import pytest
import torch
from scipy.stats import chi2

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.ops import walks as ref_walks
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.ops import walks
from pq_laws import Laws, n_tries_for, walks_chi2_p

torch.set_num_threads(1)
P_MIN = 1e-3
TV_MAX = 0.03
N_DRAWS = 30_000
PQ = [(2.0, 0.5), (0.25, 4.0), (1.0, 0.25)]


def _port(ref):
    return Graph(row_ptr=ref.row_ptr, col_idx=ref.col_idx, directed=ref.directed,
                 name=ref.name, weights=ref.weights)


def _weighted(ref):
    rng = np.random.default_rng(0)
    return dataclasses.replace(
        ref, weights=(0.25 + rng.random(ref.number_of_directed_edges)).astype(np.float32))


def _hub_graph():
    """A small graph with two hubs of 150 and 120 neighbours (sharing 60)
    over a sparse ring, so rows exceed a cap of 100."""
    rng = np.random.default_rng(5)
    n = 400
    ring = np.arange(n)
    a = rng.choice(np.arange(2, n), 150, replace=False)
    b = np.concatenate([a[:60], rng.choice(np.setdiff1d(np.arange(2, n), a), 60,
                                           replace=False)])
    src = np.concatenate([ring, np.zeros(150, int), np.ones(120, int), [0]])
    dst = np.concatenate([(ring + 1) % n, a, b, [1]])
    return RefGraph.from_edge_arrays(src, dst, n_nodes=n, directed=False)


# ------------------------------------------------------------- ELL export
@pytest.mark.parametrize("which", ["karate", "weighted er", "hubs"])
@pytest.mark.parametrize("cap, seed", [(4, 0), (8, 3), (100, 0), (1000, 7)])
def test_ell_export_matches_reference(karate, er_graph, which, cap, seed):
    ref = {"karate": karate, "weighted er": er_graph, "hubs": _hub_graph()}[which]
    want = ref.device(ell_cap=cap, ell_seed=seed)
    tg = _port(ref).device("cpu", ell_cap=cap, ell_seed=seed)
    assert tg.ell_cap == want.ell_cap == min(cap, int(ref.degrees.max()))
    got_cols = tg.ell_cols.numpy()
    assert got_cols.dtype == np.int32
    np.testing.assert_array_equal(got_cols, np.asarray(want.ell_cols))
    if ref.weights is None:
        assert tg.ell_w is None and want.ell_w is None
    else:
        assert tg.ell_w.numpy().tobytes() == np.asarray(want.ell_w).tobytes()


def test_no_ell_without_cap(karate):
    tg = _port(karate).device("cpu")
    assert tg.ell_cols is None and tg.ell_w is None and tg.ell_cap == 0


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("which", ["karate", "weighted er", "hubs"])
@pytest.mark.parametrize("cap", [4, 8, 100])
def test_ell_rows_keep_the_order_k9_searches(karate, er_graph, package, which, cap):
    """The ELL order K9 relies on, in both packages' exports: a row of
    degree up to the cap holds its neighbours ascending, then -1 padding
    only (K9 searches it, and reads a row only up to its first padding
    slot); an over-cap row holds cap distinct neighbours and no padding."""
    ref = {"karate": karate, "weighted er": er_graph, "hubs": _hub_graph()}[which]
    if package == "port":
        cols = _port(ref).device("cpu", ell_cap=cap, ell_seed=1).ell_cols.numpy()
    else:
        cols = np.asarray(ref.device(ell_cap=cap, ell_seed=1).ell_cols)
    width = cols.shape[1]
    assert width == min(cap, int(ref.degrees.max()))
    saw_over = False
    for node in range(ref.number_of_nodes):
        row = cols[node]
        nbrs = ref.col_idx[ref.row_ptr[node]:ref.row_ptr[node + 1]]
        if len(nbrs) <= width:
            np.testing.assert_array_equal(row[:len(nbrs)], np.sort(nbrs))
            assert (row[len(nbrs):] == -1).all()
        else:
            saw_over = True
            assert (row >= 0).all() and len(np.unique(row)) == width
            assert np.isin(row, nbrs).all()
    assert saw_over == (int(ref.degrees.max()) > cap)


# --------------------------------------------------- one step, in distribution
def _dense(g, cands, probs):
    p = np.zeros(g.number_of_nodes)
    np.add.at(p, cands, probs)
    return p


def _full_expected(g, prev, curr, rw, ew):
    """The p/q transition probabilities from curr, after prev, over curr's
    whole CSR row."""
    return _dense(g, *Laws(g.row_ptr, g.col_idx, g.weights, rw, ew).step(prev, curr))


def _rejection_law(g, prev, curr, rw, ew, n_tries):
    return _dense(g, *Laws(g.row_ptr, g.col_idx, g.weights, rw, ew,
                           n_tries=n_tries).step(prev, curr))


def _check(draws, law, target=None, tv_bins=None):
    """Chi-square of the draws against their sampler's law, and total
    variation against the p/q target (the law itself by default), over the
    nodes or, where `tv_bins` maps each node to a bin, over the bins."""
    target = law if target is None else target
    n = len(draws)
    observed = np.bincount(draws, minlength=len(law))
    assert observed[law == 0].sum() == 0, "a draw outside the support"
    cells = law > 0
    e = n * law[cells]
    assert e.min() >= 5
    p = chi2.sf(((observed[cells] - e) ** 2 / e).sum(), cells.sum() - 1)
    if tv_bins is not None:
        observed, target = (np.bincount(tv_bins, weights=x) for x in (observed, target))
    tv = 0.5 * np.abs(observed / n - target).sum()
    assert p >= P_MIN and tv < TV_MAX, (p, tv)


def _step_draws(sampler, ref, prev_node, curr_node, rw, ew, cap, n_draws=N_DRAWS):
    """`n_draws` next nodes from curr after prev, by one sampler."""
    n = n_draws
    if sampler.startswith("jax"):
        dg = ref.device(with_alias=ref.weights is not None, ell_cap=cap)
        prev = jnp.full((n,), prev_node, jnp.int32)
        curr = jnp.full((n,), curr_node, jnp.int32)
        key = jax.random.PRNGKey(1)
        if sampler == "jax ell":
            prev_row = jnp.broadcast_to(dg.ell_cols[prev_node], (n, dg.ell_cap))
            out = jax.jit(ref_walks._second_order_step_ell, static_argnums=(6, 7, 8))(
                dg, key, prev, prev_row, curr, None, rw, ew, cap)[0]
        elif sampler == "jax rejection":
            out = jax.jit(functools.partial(ref_walks._second_order_step_rejection,
                                            n_tries=n_tries_for(rw, ew)),
                          static_argnums=(4, 5, 6))(dg, key, prev, curr, rw, ew, cap)
        else:
            out = jax.jit(ref_walks._second_order_step_exact, static_argnums=(4, 5, 6))(
                dg, key, prev, curr, rw, ew, cap)[0]
        return np.asarray(out)
    tg = _port(ref).device("cpu", with_alias=ref.weights is not None, ell_cap=cap)
    prev = torch.full((n,), prev_node, dtype=torch.int32)
    curr = torch.full((n,), curr_node, dtype=torch.int32)
    gen = torch.Generator().manual_seed(2)
    if sampler == "ell":
        out, row, _ = walks._second_order_step_ell(
            tg, prev, tg.ell_cols[prev.long()], curr, None, rw, ew, cap, 1.0, 1.0, gen)
        assert torch.equal(row[0], tg.ell_cols[curr_node])
    elif sampler == "rejection":
        out = walks._second_order_step_rejection(tg, prev, curr, rw, ew,
                                                 n_tries_for(rw, ew), gen)
    else:
        out, _ = walks._second_order_step_exact(tg, prev, curr, None, rw, ew, cap, 1.0, 1.0,
                                                gen)
    return out.numpy()


@pytest.mark.parametrize("sampler", ["ell", "rejection", "exact",
                                     "jax ell", "jax rejection", "jax exact"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rw, ew", PQ)
def test_step_matches_exact_probabilities(karate, sampler, weighted, rw, ew):
    """A (prev, curr) pair on karate at cap 34 (the whole rows): every
    sampler against the probabilities computed from the graph."""
    ref = _weighted(karate) if weighted else karate
    curr = int(np.argmax(ref.degrees))
    prev = int(ref.col_idx[ref.row_ptr[curr]])
    draws = _step_draws(sampler, ref, prev, curr, rw, ew, 34)
    target = _full_expected(ref, prev, curr, rw, ew)
    if sampler.endswith("rejection"):
        law = _rejection_law(ref, prev, curr, rw, ew, n_tries_for(rw, ew))
        assert abs(law.sum() - 1) < 1e-12
        _check(draws, law, target)
    else:
        _check(draws, target)


@pytest.mark.parametrize("sampler", ["ell", "jax ell"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rw, ew", PQ)
def test_over_cap_step_matches_the_subsample(sampler, weighted, rw, ew):
    """Hub rows over a cap of 100: the candidates are curr's ELL subsample,
    and a neighbour of prev outside prev's subsample weighs explore_weight.
    Both ELL samplers against the probabilities computed from the ELL
    arrays."""
    ref = _hub_graph()
    if weighted:
        ref = _weighted(ref)
    curr, prev = 0, 1
    assert ref.degrees[curr] > 100 and ref.degrees[prev] > 100
    ecols, ew_table, cap = _port(ref).ell_arrays(100)
    expected = _dense(ref, *Laws(None, None, None, rw, ew,
                                 ell=(ecols, ew_table, cap)).step(prev, curr))
    # The subsample differs from the whole neighbourhood here.
    assert np.abs(expected - _full_expected(ref, prev, curr, rw, ew)).sum() > 0.05
    _check(_step_draws(sampler, ref, prev, curr, rw, ew, 100), expected)


def test_ell_step_wide_cap():
    """A cap of 1,100 on a small graph with a 1,100-neighbour hub: the
    plain ELL step still matches the exact probabilities (the total
    variation over the return / common / explore classes, as 1,100 cells
    are too many for it at this number of draws)."""
    n = 1500
    src = np.concatenate([np.zeros(1100, int), np.arange(1, n - 1)])
    dst = np.concatenate([np.arange(1, 1101), np.arange(2, n)])
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=n, directed=False)
    curr, prev = 0, 5
    draws = _step_draws("ell", ref, prev, curr, 2.0, 0.5, 1100, n_draws=12_000)
    classes = np.full(n, 2)
    classes[ref.col_idx[ref.row_ptr[prev]:ref.row_ptr[prev + 1]]] = 1
    classes[prev] = 0
    _check(draws, _full_expected(ref, prev, curr, 2.0, 0.5), tv_bins=classes)


# --------------------------------------------------------------- whole walks
def _visits(w, n):
    return np.bincount(np.asarray(w).ravel(), minlength=n) / np.asarray(w).size


def _follow_arcs(g, w):
    w = np.asarray(w, np.int64)
    src, dst = w[:, :-1].ravel(), w[:, 1:].ravel()
    stay = g.degrees[src] == 0
    assert (dst[stay] == src[stay]).all()
    assert g.has_edges(src[~stay], dst[~stay]).all()


@pytest.mark.parametrize("ell", [True, False])
def test_walks_follow_arcs_and_match_jax(karate, ell):
    """p/q walks through the ELL sampler (cap 40) and through rejection:
    valid walks whose visits match the JAX random_walks' within TV 0.05."""
    starts = np.tile(np.arange(34, dtype=np.int32), 100)
    cap = 40 if ell else None
    port = _port(karate)
    tg = port.device("cpu", ell_cap=cap)
    ours = walks.random_walks(tg, torch.from_numpy(starts), 12,
                              torch.Generator().manual_seed(7), return_weight=2.0,
                              explore_weight=0.5, max_neighbours=34)
    assert ours.dtype == torch.int32 and ours.shape == (3400, 12)
    np.testing.assert_array_equal(ours[:, 0].numpy(), starts)
    _follow_arcs(port, ours.numpy())
    theirs = ref_walks.random_walks(karate.device(ell_cap=cap), jnp.asarray(starts), 12,
                                    jax.random.PRNGKey(7), return_weight=2.0,
                                    explore_weight=0.5, max_neighbours=34)
    tv = 0.5 * np.abs(_visits(ours, 34) - _visits(theirs, 34)).sum()
    assert tv < 0.05, tv


@pytest.mark.parametrize("sampler", ["ell", "ell over cap", "rejection"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_walks_match_their_laws(karate, sampler, weighted):
    """Whole walks of the plain K9 and K10 versions: every move against its
    step law given the walk so far (pooled chi-square)."""
    ref = _weighted(karate) if weighted else karate
    g = _port(ref)
    rw, ew = (0.25, 4.0) if sampler == "rejection" else (2.0, 0.5)
    cap = 8 if sampler == "ell over cap" else 100
    tg = g.device("cpu", with_alias=weighted, ell_cap=None if sampler == "rejection" else cap)
    starts = torch.arange(34 * 300, dtype=torch.int32) % 34
    w = walks.random_walks(tg, starts, 10, torch.Generator().manual_seed(3),
                           return_weight=rw, explore_weight=ew, max_neighbours=cap)
    ell = None if tg.ell_cols is None else (
        tg.ell_cols.numpy(), None if tg.ell_w is None else tg.ell_w.numpy(),
        min(cap, tg.ell_cap))
    laws = Laws(g.row_ptr, g.col_idx, g.weights, rw, ew, ell=ell,
                n_tries=n_tries_for(rw, ew) if sampler == "rejection" else None)
    assert walks_chi2_p(w.numpy(), laws, 34)[0] >= P_MIN


def test_chip_smoke_pq_statistics():
    """The statistics `chip_smoke.py` holds K9 and K10 to against their
    plain versions on the card, run here on plain walks: the script finds
    `pq_laws` as the tests do; the returns per position count every walker
    and tell p/q walks from walks with p and q swapped; the picked slots
    count every move that left its node, and under the cap a move's ELL
    slot is its offset in the CSR row."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.laws_module("pq_laws") is pq_laws
    g = erdos_renyi(200, 800, seed=7)
    tg_ell, tg_csr = g.device("cpu", ell_cap=100), g.device("cpu")
    starts = torch.arange(6000, dtype=torch.int32) % 200
    w, w_again, w_swapped = (
        walks.ell_walks_plain(tg_ell, starts, 16, rw, ew, 100, torch.Generator().manual_seed(s))
        for rw, ew, s in ((2.0, 0.5, 0), (2.0, 0.5, 1), (0.5, 2.0, 2)))
    np.testing.assert_array_equal(chip_smoke.return_counts(w),
                                  (w[:, 2:] == w[:, :-2]).sum(0).numpy())
    assert chip_smoke.returns_p(w, w_again) >= P_MIN
    assert chip_smoke.returns_p(w, w_swapped) < P_MIN
    keys = chip_smoke.arc_keys(g, "cpu")
    slots = chip_smoke.slot_counts(tg_ell, keys, w, chunk=1000)
    np.testing.assert_array_equal(slots, chip_smoke.slot_counts(tg_csr, keys, w))
    assert slots.sum() == int((w[:, 2:] != w[:, 1:-1]).sum())
    assert chip_smoke.two_sample_p(slots, chip_smoke.slot_counts(tg_ell, keys, w_again)) >= P_MIN


def test_pq_walks_trap_zero_degree_nodes():
    g = Graph.from_edge_arrays(np.array([0, 1, 1]), np.array([1, 2, 3]), n_nodes=6)
    starts = torch.arange(60, dtype=torch.int32) % 6
    for tg in (g.device("cpu", ell_cap=100), g.device("cpu")):
        w = walks.random_walks(tg, starts, 7, torch.Generator().manual_seed(1),
                               return_weight=2.0, explore_weight=0.5).numpy()
        for trap in (4, 5):
            assert (w[w[:, 0] == trap] == trap).all()
        _follow_arcs(g, w)


@pytest.mark.parametrize("length", [1, 2, 5])
def test_short_walks(karate, length):
    tg = _port(karate).device("cpu", ell_cap=100)
    starts = torch.arange(34, dtype=torch.int32)
    for kw in (dict(), dict(exact_pq=True)):
        w = walks.random_walks(tg, starts, length, torch.Generator().manual_seed(0),
                               return_weight=2.0, explore_weight=0.5, **kw)
        assert w.shape == (34, length)
        np.testing.assert_array_equal(w[:, 0].numpy(), starts.numpy())


# ------------------------------------------------------------------ routing
def _typed_karate(karate):
    """The port's karate club with its communities as node types and three
    edge types."""
    return dataclasses.replace(
        _port(karate), node_type_ptr=karate.node_type_ptr, node_type_ids=karate.node_type_ids,
        edge_types=(np.arange(karate.number_of_directed_edges) % 3).astype(np.int32))


@pytest.mark.parametrize("rw, ew, ell_cap, exact_pq, typed, route", [
    (1.0, 1.0, 100, False, {}, "first_order"),
    (2.0, 0.5, 100, False, {}, "ell 100"),
    (2.0, 0.5, 8, False, {}, "rejection 8"),      # the table does not cover the cap
    (2.0, 0.5, None, False, {}, "rejection 8"),
    (0.25, 4.0, None, False, {}, "rejection 16"),
    (0.05, 1.0, None, False, {}, "exact 1.0 1.0"),        # weight ratio 20
    (0.05, 1.0, 100, False, {}, "ell 100"),
    (2.0, 0.5, 100, True, {}, "exact 1.0 1.0"),
    # Typed walks: K9 with the type tables, else K19, never K10 or K1.
    (1.0, 1.0, 100, False, dict(change_node_type_weight=2.0), "ell 100 2.0 1.0"),
    (2.0, 0.5, 100, False, dict(change_edge_type_weight=0.5), "ell 100 1.0 0.5"),
    (2.0, 0.5, None, False, dict(change_node_type_weight=2.0), "exact 2.0 1.0"),
    (1.0, 1.0, None, False, dict(change_edge_type_weight=0.5), "exact 1.0 0.5"),
    (1.0, 1.0, 8, False, dict(change_node_type_weight=2.0), "exact 2.0 1.0"),
    (2.0, 0.5, 100, True, dict(change_node_type_weight=2.0,
                               change_edge_type_weight=0.5), "exact 2.0 0.5"),
])
def test_random_walks_routes_as_the_reference(monkeypatch, karate, rw, ew, ell_cap,
                                              exact_pq, typed, route):
    taken = []
    monkeypatch.setattr(walks, "first_order_walks",
                        lambda *a: taken.append("first_order"))
    monkeypatch.setattr(walks, "ell_walks",
                        lambda tg, s, L, rw, ew, cap, g, nw, et: taken.append(
                            f"ell {cap}" + (f" {nw} {et}" if (nw, et) != (1.0, 1.0) else "")))
    monkeypatch.setattr(walks, "rejection_walks",
                        lambda tg, s, L, rw, ew, t, g: taken.append(f"rejection {t}"))
    monkeypatch.setattr(walks, "exact_walks_plain",
                        lambda tg, s, L, rw, ew, m, g, nw, et: taken.append(f"exact {nw} {et}"))
    tg = _typed_karate(karate).device("cpu", ell_cap=ell_cap, with_walk_types=True)
    walks.random_walks(tg, torch.zeros(3, dtype=torch.int32), 5, torch.Generator(),
                       return_weight=rw, explore_weight=ew, exact_pq=exact_pq, **typed)
    assert taken == [route]


def test_exact_sampler_refuses_cuda_graphs(monkeypatch, karate):
    """On a CUDA graph the exact route launches kernel K19 (typed or not),
    and does not run its plain version: the CPU dispatch is by the tensors'
    device alone."""
    tg = _typed_karate(karate).device("cpu", with_walk_types=True)
    launched = []
    monkeypatch.setattr(walks._build, "is_cuda", lambda t: True)
    monkeypatch.setattr(walks._build, "check", lambda *a: None)
    monkeypatch.setattr(walks._build, "launch",
                        lambda counter, fn, dev, *args: launched.append((counter, fn, args)))
    monkeypatch.setattr(walks, "_second_order_step_exact",
                        lambda *a: pytest.fail("the plain version ran"))
    for kw in (dict(return_weight=2.0, explore_weight=0.5, exact_pq=True),
               dict(change_node_type_weight=2.0, change_edge_type_weight=0.5)):
        walks.random_walks(tg, torch.zeros(3, dtype=torch.int32), 5, torch.Generator(), **kw)
    assert [(c, f) for c, f, _ in launched] == [("exact_walks", "ebt_exact_walks")] * 2
    # The untyped launch passes no type tables; the typed one both, and the
    # factors.
    untyped, typed = (args for _, _, args in launched)
    assert untyped[5] is None and untyped[6] is None and untyped[14:16] == (1.0, 1.0)
    assert typed[5] == tg.edge_types.data_ptr() and typed[6] == tg.node_type_of.data_ptr()
    assert typed[14:16] == (2.0, 0.5)


@pytest.mark.parametrize("kw", [dict(change_node_type_weight=2.0),
                                dict(change_edge_type_weight=0.5)])
def test_typed_walks_raise(karate, kw):
    """Typed walks need the type tables of the factor they use: a graph
    exported with node and edge types and an ELL table, but without
    `with_walk_types`, routes its node factor away (no `node_type_of`: the
    factor is inert) and its edge factor to K19 (the arcs' edge types are
    there, the ELL slot table is not); asking K9 for a factor without its
    table raises."""
    g = _typed_karate(karate)
    tg = g.device("cpu", ell_cap=100)
    got = walks.random_walks(tg, torch.zeros(3, dtype=torch.int32), 5,
                             torch.Generator().manual_seed(0), return_weight=2.0, **kw)
    assert got.shape == (3, 5)
    with pytest.raises(ValueError, match="with_walk_types"):
        walks.ell_walks(tg, torch.zeros(3, dtype=torch.int32), 5, 2.0, 1.0, 100,
                        torch.Generator(), kw.get("change_node_type_weight", 1.0),
                        kw.get("change_edge_type_weight", 1.0))


def test_skipgram_pairs_and_node2vec_batch_match_reference(karate):
    w = np.random.default_rng(0).integers(0, 34, (7, 11)).astype(np.int32)
    got = walks.skipgram_pairs(torch.from_numpy(w), 3)
    want = ref_walks.skipgram_pairs(jnp.asarray(w), 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tg = _port(karate).device("cpu", ell_cap=100)
    ctx, words = walks.node2vec_batch(tg, torch.arange(5, dtype=torch.int32), 10, 2,
                                      torch.Generator().manual_seed(0), iterations=3,
                                      return_weight=2.0, explore_weight=0.5)
    assert ctx.shape == (15 * 6, 4) and words.shape == (15 * 6,)
