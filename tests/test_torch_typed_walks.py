"""Typed walks on the CPU: the plain typed ELL step (K9's plain version)
and the plain exact step (K19's) follow the exact typed law computed in
numpy from the graph (chi-square p >= 1e-3 and total variation < 0.03 with
fixed seeds), as the JAX package's own two samplers do (mirroring its
tests/test_walks.py typed-walk tests); K19's rotated windows follow the law
averaged over the rotations; both routes' first steps and whole walks
follow their laws (`tests/pq_laws.py`); the edge type carried is the picked
arc's, on a multigraph too; and visits and type-change rates match the JAX
package's `random_walks` on the same graph by two-sample tests."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.ops import walks as ref_walks
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.ops import walks
from pq_laws import Laws, window_law, walks_chi2_p

torch.set_num_threads(1)
P_MIN = 1e-3
TV_MAX = 0.03
N_DRAWS = 60_000
FACTORS = [(4.0, 1.0), (1.0, 0.2), (3.0, 0.5)]   # the reference's (node, edge) weights
PQ = [(1.0, 1.0), (2.0, 0.5)]
TYPED = dict(weighted=True, n_edge_types=3, n_node_types=4)


@pytest.fixture(scope="module")
def typed_pair():
    """The reference's typed fixture, in both packages."""
    return erdos_renyi(60, 400, seed=3, **TYPED), ref_erdos_renyi(60, 400, seed=3, **TYPED)


def _typed_expected(g, prev, curr, prev_et, rw, ew, cnt_w, cet_w, window=None):
    """The exact typed step from curr after prev over curr's CSR row (over
    K19's rotated windows when `window` is shorter than the row), as dense
    node probabilities, from first principles."""
    ntypes = g.get_single_label_node_type_ids()
    s, e = g.row_ptr[curr], g.row_ptr[curr + 1]
    cands = g.col_idx[s:e]
    prev_nbrs = set(g.col_idx[g.row_ptr[prev]:g.row_ptr[prev + 1]].tolist())
    w = np.ones(len(cands))
    for i, c in enumerate(cands):
        w[i] = rw if c == prev else (1.0 if int(c) in prev_nbrs else ew)
        if ntypes[c] != ntypes[curr]:
            w[i] *= cnt_w
        if prev_et >= 0 and g.edge_types[s + i] != prev_et:
            w[i] *= cet_w
        if g.weights is not None:
            w[i] *= g.weights[s + i]
    p = np.zeros(g.number_of_nodes)
    np.add.at(p, cands, window_law(w, window))
    return p


def _check(draws, law):
    n = len(draws)
    observed = np.bincount(draws, minlength=len(law))
    assert observed[law == 0].sum() == 0, "a draw outside the support"
    cells = law > 0
    e = n * law[cells]
    stat = ((observed[cells] - e) ** 2 / e).sum()
    p = chi2.sf(stat, cells.sum() - 1)
    tv = 0.5 * np.abs(observed / n - law).sum()
    assert p >= P_MIN and tv < TV_MAX, (p, tv)


def _step(sampler, port, ref, prev_node, curr_node, prev_et, rw, ew, cnt_w, cet_w, cap):
    """N_DRAWS next nodes (and the edge types carried) of one typed step."""
    n = N_DRAWS
    if sampler.startswith("jax"):
        dg = ref.device(ell_cap=cap if sampler == "jax ell" else None, with_walk_types=True)
        prev = jnp.full((n,), prev_node, jnp.int32)
        curr = jnp.full((n,), curr_node, jnp.int32)
        pet = jnp.full((n,), prev_et, jnp.int32)
        kw = dict(return_weight=rw, explore_weight=ew, change_node_type_weight=cnt_w,
                  change_edge_type_weight=cet_w)
        if sampler == "jax ell":
            prev_row = jnp.broadcast_to(dg.ell_cols[prev_node], (n, dg.ell_cap))
            out, _, net = jax.jit(ref_walks._second_order_step_ell, static_argnames=(
                "return_weight", "explore_weight", "cap", "change_node_type_weight",
                "change_edge_type_weight"))(dg, jax.random.PRNGKey(1), prev, prev_row, curr,
                                            pet, cap=cap, **kw)
        else:
            out, net = jax.jit(ref_walks._second_order_step_exact, static_argnames=(
                "return_weight", "explore_weight", "max_neighbours", "change_node_type_weight",
                "change_edge_type_weight", "with_edge_type"))(
                dg, jax.random.PRNGKey(1), prev, curr, prev_et=pet, max_neighbours=cap,
                with_edge_type=True, **kw)
        return np.asarray(out), None if net is None else np.asarray(net)
    tg = port.device("cpu", ell_cap=cap if sampler == "ell" else None, with_walk_types=True)
    prev = torch.full((n,), prev_node, dtype=torch.int32)
    curr = torch.full((n,), curr_node, dtype=torch.int32)
    pet = torch.full((n,), prev_et, dtype=torch.long)
    gen = torch.Generator().manual_seed(2)
    if sampler == "ell":
        out, row, net = walks._second_order_step_ell(tg, prev, tg.ell_cols[prev.long()], curr,
                                                     pet, rw, ew, cap, cnt_w, cet_w, gen)
        assert torch.equal(row[0], tg.ell_cols[curr_node])
    else:
        out, net = walks._second_order_step_exact(tg, prev, curr, pet, rw, ew, cap, cnt_w,
                                                  cet_w, gen, with_edge_type=True)
    return out.numpy(), net.numpy()


def _assert_carried_types(g, curr_node, out, net):
    """Each carried type is a type of an arc curr -> next."""
    s, e = g.row_ptr[curr_node], g.row_ptr[curr_node + 1]
    for node in np.unique(out):
        arc_types = g.edge_types[s:e][g.col_idx[s:e] == node]
        assert np.isin(net[out == node], arc_types).all()


@pytest.mark.parametrize("sampler", ["ell", "exact", "jax ell", "jax exact"])
@pytest.mark.parametrize("rw, ew", PQ)
@pytest.mark.parametrize("cnt_w, cet_w", FACTORS)
def test_typed_step_matches_exact_law(typed_pair, sampler, rw, ew, cnt_w, cet_w):
    """The top-degree node after its first neighbour, at a cap covering
    every row: both packages' typed ELL and exact steps against the typed
    law; the edge type returned is the taken arc's."""
    port, ref = typed_pair
    curr = int(np.argmax(port.degrees))
    prev = int(port.col_idx[port.row_ptr[curr]])
    prev_et = int(port.edge_types[port.row_ptr[prev]
                                  + np.searchsorted(port.col_idx[port.row_ptr[prev]:
                                                                 port.row_ptr[prev + 1]], curr)])
    cap = int(port.degrees.max())
    out, net = _step(sampler, port, ref, prev, curr, prev_et, rw, ew, cnt_w, cet_w, cap)
    _check(out, _typed_expected(port, prev, curr, prev_et, rw, ew, cnt_w, cet_w))
    if net is not None and (cet_w != 1.0 or sampler.endswith("exact")):
        _assert_carried_types(port, curr, out, net)


@pytest.mark.parametrize("sampler", ["exact", "jax exact"])
@pytest.mark.parametrize("cnt_w, cet_w", FACTORS)
def test_rotated_window_step_matches_the_window_law(sampler, cnt_w, cet_w):
    """K19's plain version and the JAX exact step at cap 34 on a row of 60:
    the law averaged over the 60 rotations of the window."""
    kw = dict(weighted=True, n_edge_types=3, n_node_types=4)
    port, ref = erdos_renyi(120, 2400, seed=9, **kw), ref_erdos_renyi(120, 2400, seed=9, **kw)
    curr = int(np.argmax(port.degrees))
    assert port.degrees[curr] > 34
    prev = int(port.col_idx[port.row_ptr[curr] + 3])
    prev_et = 1
    out, net = _step(sampler, port, ref, prev, curr, prev_et, 2.0, 0.5, cnt_w, cet_w, 34)
    _check(out, _typed_expected(port, prev, curr, prev_et, 2.0, 0.5, cnt_w, cet_w, window=34))
    _assert_carried_types(port, curr, out, net)


def _multigraph():
    """A directed multigraph (the CSR built by hand): node 0 has two arcs to
    node 1 (types 0 and 2), one to 2 (type 1) and one to 3 (type 2); nodes
    1-3 lead back to 0; node types 0, 1, 0, 1."""
    return Graph(row_ptr=np.array([0, 4, 5, 6, 7]), col_idx=np.array([1, 1, 2, 3, 0, 0, 0],
                                                                      np.int32),
                 edge_types=np.array([0, 2, 1, 2, 0, 1, 2], np.int32),
                 node_type_ptr=np.arange(5), node_type_ids=np.array([0, 1, 0, 1], np.int32))


@pytest.mark.parametrize("route", ["ell", "exact"])
def test_carried_type_is_the_picked_arcs_on_a_multigraph(route):
    """The pair (0, 1) carries two types: each arc is picked by its own law
    (p = q = 1, node weight 2, edge weight 0.25 against a previous type 2),
    and carries its own type, not a lookup of the pair."""
    g = _multigraph()
    tg = g.device("cpu", ell_cap=8 if route == "ell" else None, with_walk_types=True)
    n = N_DRAWS
    prev, curr = torch.full((n,), 3, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    pet = torch.full((n,), 2, dtype=torch.long)
    gen = torch.Generator().manual_seed(5)
    if route == "ell":
        out, _, net = walks._second_order_step_ell(tg, prev, tg.ell_cols[prev.long()], curr,
                                                   pet, 1.0, 1.0, 8, 2.0, 0.25, gen)
    else:
        out, net = walks._second_order_step_exact(tg, prev, curr, pet, 1.0, 1.0, 8, 2.0, 0.25,
                                                  gen, with_edge_type=True)
    # Arcs 0 -> 1 (type 0), 0 -> 1 (type 2), 0 -> 2 (type 1), 0 -> 3 (type 2):
    # node factor 2 for 1 and 3, edge factor 0.25 for types other than 2.
    w = np.array([2 * 0.25, 2.0, 0.25, 2.0])
    arc = np.select([(out == 1) & (net == 0), (out == 1) & (net == 2), out == 2, out == 3],
                    [0, 1, 2, 3], -1)
    assert (arc >= 0).all()
    _check(arc, w / w.sum())


def _typed_laws(g, tg, rw, ew, cnt_w, cet_w, cap, route):
    ell = None if route == "exact" else (
        tg.ell_cols.numpy(), None if tg.ell_w is None else tg.ell_w.numpy(), min(cap, tg.ell_cap))
    return Laws(g.row_ptr, g.col_idx, g.weights, rw, ew, ell=ell,
                node_types=g.get_single_label_node_type_ids(), edge_types=g.edge_types,
                node_w=cnt_w, edge_w=cet_w, window=cap if route == "exact" else None)


@pytest.mark.parametrize("route, cap", [("ell", 100), ("ell", 8), ("exact", 100), ("exact", 12)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rw, ew, cnt_w, cet_w", [(1.0, 1.0, 3.0, 0.5), (2.0, 0.5, 4.0, 1.0),
                                                  (2.0, 0.5, 1.0, 0.2)])
def test_plain_typed_walks_match_their_laws(route, cap, weighted, rw, ew, cnt_w, cet_w):
    """Whole walks of K9's plain version (whole rows at cap 100, subsampled
    rows at cap 8) and K19's (whole rows; rotated windows of 12 on longer
    rows): every move, the first ones too, against its law given the walk
    so far (pooled chi-square)."""
    g = erdos_renyi(80, 500, seed=11, weighted=weighted, n_edge_types=3, n_node_types=3)
    tg = g.device("cpu", with_alias=weighted, ell_cap=cap if route == "ell" else None,
                  with_walk_types=True)
    if route == "exact" and cap == 12:
        assert int(g.degrees.max()) > 12
    starts = torch.arange(80 * 300, dtype=torch.int32) % 80
    w = walks.random_walks(tg, starts, 8, torch.Generator().manual_seed(3), return_weight=rw,
                           explore_weight=ew, max_neighbours=cap,
                           change_node_type_weight=cnt_w, change_edge_type_weight=cet_w)
    assert walks_chi2_p(w.numpy(), _typed_laws(g, tg, rw, ew, cnt_w, cet_w, cap, route),
                        80)[0] >= P_MIN


def _change_rate(walks_np, ntypes):
    t = ntypes[walks_np]
    return (t[:, 1:] != t[:, :-1]).mean()


def _two_sample_p(a, b):
    """Chi-square p-value that two histograms come from one law."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    keep = (a + b) > 0
    a, b = a[keep], b[keep]
    na, nb = a.sum(), b.sum()
    stat = ((a * np.sqrt(nb / na) - b * np.sqrt(na / nb)) ** 2 / (a + b)).sum()
    return float(chi2.sf(stat, keep.sum() - 1))


@pytest.mark.parametrize("ell", [True, False])
@pytest.mark.parametrize("rw, ew", PQ)
def test_visits_and_type_changes_match_jax(typed_pair, ell, rw, ew):
    """Typed walks (node weight 3, edge weight 0.5) of the port and of the
    JAX package from the same starts, through K9's route (cap 64) and K19's
    (no ELL table): the visits per node and, per position, the type
    changes, by two-sample chi-square tests."""
    port, ref = typed_pair
    starts = np.tile(np.arange(60, dtype=np.int32), 200)
    kw = dict(return_weight=rw, explore_weight=ew, change_node_type_weight=3.0,
              change_edge_type_weight=0.5)
    cap = 64 if ell else None
    ours = walks.random_walks(port.device("cpu", ell_cap=cap, with_walk_types=True),
                              torch.from_numpy(starts), 10, torch.Generator().manual_seed(7),
                              **kw).numpy()
    theirs = np.asarray(ref_walks.random_walks(ref.device(ell_cap=cap, with_walk_types=True),
                                               jnp.asarray(starts), 10, jax.random.PRNGKey(7),
                                               **kw))
    np.testing.assert_array_equal(ours[:, 0], starts)
    assert _two_sample_p(np.bincount(ours[:, 1:].ravel(), minlength=60),
                         np.bincount(theirs[:, 1:].ravel(), minlength=60)) >= P_MIN
    ntypes = port.get_single_label_node_type_ids()
    changes = [(ntypes[w][:, 1:] != ntypes[w][:, :-1]).sum(0) for w in (ours, theirs)]
    n = len(starts)
    for pos in range(9):
        table = [[changes[0][pos], n - changes[0][pos]], [changes[1][pos], n - changes[1][pos]]]
        assert _two_sample_p(*table) >= P_MIN


def test_typed_walks_end_to_end(typed_pair):
    """The reference's test on the port: a high node weight makes walks
    change node type more often than a low one, through both routes; with
    p/q on top the walks follow arcs; an untyped export leaves the factors
    inert (the same walks as the untyped call)."""
    port, _ = typed_pair
    ntypes = port.get_single_label_node_type_ids()
    starts = torch.arange(60, dtype=torch.int32).repeat(30)

    def change_rate(tg, cnt_w, **kw):
        w = walks.random_walks(tg, starts, 10, torch.Generator().manual_seed(2),
                               change_node_type_weight=cnt_w, **kw).numpy()
        return _change_rate(w, ntypes)

    for tg in (port.device("cpu", ell_cap=64, with_walk_types=True),
               port.device("cpu", with_walk_types=True)):
        assert change_rate(tg, 5.0) > change_rate(tg, 0.1) + 0.1
    w = walks.random_walks(port.device("cpu", ell_cap=64, with_walk_types=True), starts[:200],
                           8, torch.Generator().manual_seed(3), return_weight=2.0,
                           explore_weight=0.5, change_node_type_weight=2.0,
                           change_edge_type_weight=0.5).numpy()
    assert port.has_edges(w[:, :-1].ravel(), w[:, 1:].ravel()).all()
    untyped = port.device("cpu")
    a = walks.random_walks(untyped, starts[:100], 6, torch.Generator().manual_seed(4),
                           change_node_type_weight=9.0)
    b = walks.random_walks(untyped, starts[:100], 6, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)


def test_chip_smoke_typed_statistics():
    """The statistics `chip_smoke.py` holds K19 and typed K9 to against
    their plain versions on the card, run here on plain walks: the type
    changes per position count every walker and tell a node weight of 4
    from 0.25; the carried-type check accepts the walks' own arcs."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    g = erdos_renyi(300, 1500, seed=7, n_edge_types=4, n_node_types=4)
    tg = g.device("cpu", with_walk_types=True)
    starts = torch.arange(6000, dtype=torch.int32) % 300
    w, w_again, w_low = (
        walks.exact_walks_plain(tg, starts, 12, 2.0, 0.5, 100, torch.Generator().manual_seed(s),
                                nw, 0.5) for nw, s in ((4.0, 0), (4.0, 1), (0.25, 2)))
    nt = tg.node_type_of
    np.testing.assert_array_equal(chip_smoke.type_change_counts(w, nt),
                                  (nt[w[:, 1:].long()] != nt[w[:, :-1].long()]).sum(0).numpy())
    assert chip_smoke.type_changes_p(w, w_again, nt) >= P_MIN
    assert chip_smoke.type_changes_p(w, w_low, nt) < P_MIN
