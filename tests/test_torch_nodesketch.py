"""NodeSketch's min-hash race (kernel K18's plain version) and the whole
NodeSketch row on the CPU, held to embiggen_tpu exactly.

The reference draws its initial races from `jax.random.exponential` under
PRNGKey(random_state) and each round's noise under the keys of
split(PRNGKey(1), iterations); the tests make the same draws and inject them
into the port (`factorization_state_from_jax`), so the sketches must be
equal, bit for bit: the candidate is the same fused multiply-add, and a
minimum and a minimum over tied ids do not depend on their order. The
graphs: an Erdos-Renyi graph, one of two components with isolated nodes, a
directed one. Exact ties are made by replacing `jax.random.exponential` for
the test (pytest's monkeypatch) with races on a grid of a few values and
noise on a grid or zero, so that many candidates tie and many equal the
row's current race; nothing in embiggen_tpu changes.

The port's own draws (races and noise Exp(1)) are held by their moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.embedders import factorization as ref_factorization
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.models.embedders import NodeSketch
from embiggen_tpu_torch.ops.nodesketch import (
    candidate_pitch, inverse_decay, sketch_candidates, sketch_race, sketch_race_step,
    sketch_race_step_plain,
)
from embiggen_tpu_torch.utils.convert import factorization_state_from_jax

torch.set_num_threads(1)

GRAPHS = ["er", "components", "directed"]


def _pair(kind):
    """The same graph built by both packages."""
    if kind == "er":
        kw = dict(n_nodes=300, n_edges=1200, seed=4)
        return erdos_renyi(**kw), ref_erdos_renyi(**kw)
    rng = np.random.default_rng(12)
    if kind == "components":   # two components and twenty isolated nodes
        a = rng.integers(0, 100, (2, 300))
        b = rng.integers(100, 180, (2, 200))
        src, dst = np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])
        kw = dict(n_nodes=200, directed=False)
    else:                      # directed
        src, dst = rng.integers(0, 160, (2, 500))
        kw = dict(n_nodes=160, directed=True)
    return Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)


@pytest.fixture(scope="module", params=GRAPHS)
def graphs(request):
    g, rg = _pair(request.param)
    assert np.array_equal(g.col_idx, rg.col_idx) and np.array_equal(g.row_ptr, rg.row_ptr)
    return g, rg


def _reference_draws(n, d, iterations, random_state):
    """The reference fit's draws: race0 under PRNGKey(random_state or 0),
    each round's noise under split(PRNGKey(1), iterations)."""
    key = jax.random.PRNGKey(random_state or 0)
    keys = jax.random.split(jax.random.PRNGKey(1), iterations)
    return {"race0": np.asarray(jax.random.exponential(key, (n, d), jnp.float32)),
            "noise": [np.asarray(jax.random.exponential(k, (n, d))) for k in keys]}


@pytest.mark.filterwarnings("ignore:Graph")
@pytest.mark.parametrize("d, iterations, decay, random_state", [
    (4, 2, 0.01, 42), (16, 1, 0.01, 0), (16, 5, 0.01, 7), (30, 10, 0.3, 3), (7, 3, 0.7, 1),
])
def test_nodesketch_matches_reference_on_its_draws(graphs, d, iterations, decay, random_state):
    g, rg = graphs
    kw = dict(embedding_size=d, iterations=iterations, decay=decay, random_state=random_state)
    want = ref_factorization.NodeSketch(**kw).fit_transform(rg).node_embeddings[0]
    model = NodeSketch(device="cpu", **kw)
    state = factorization_state_from_jax(
        "NodeSketch", _reference_draws(g.number_of_nodes, d, iterations, random_state), "cpu")
    got = model.run(g, state)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _star_pair(kind):
    """A star of 5,000 leaves (node 0 the hub), alone or beside the ER graph
    of `_pair`, built by both packages: one row of 5,000 arcs, far past a
    warp's 32 arc ids."""
    src, dst = np.zeros(5000, np.int64), np.arange(1, 5001)
    n = 5001
    if kind == "star+er":
        er, _ = _pair("er")
        one = er.sources < er.col_idx
        src = np.concatenate([src, er.sources[one] + n])
        dst = np.concatenate([dst, er.col_idx[one] + n])
        n += er.number_of_nodes
    kw = dict(n_nodes=n, directed=False)
    return Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)


@pytest.mark.filterwarnings("ignore:Graph")
@pytest.mark.parametrize("kind", ["star", "star+er"])
@pytest.mark.parametrize("d, iterations", [(200, 1), (200, 3), (7, 2)])
def test_nodesketch_matches_reference_on_a_star(kind, d, iterations):
    """The rounds K18's race launch makes on a hub row of 5,000 arcs, and at
    D 200 (two passes of a warp's 128 columns on the card), equal the
    reference's on its own draws."""
    g, rg = _star_pair(kind)
    kw = dict(embedding_size=d, iterations=iterations, decay=0.01, random_state=5)
    want = ref_factorization.NodeSketch(**kw).fit_transform(rg).node_embeddings[0]
    state = factorization_state_from_jax(
        "NodeSketch", _reference_draws(g.number_of_nodes, d, iterations, 5), "cpu")
    got = NodeSketch(device="cpu", **kw).run(g, state)
    np.testing.assert_array_equal(got.numpy(), want)
    # The hub's sketch changed: its row's minima came from its leaves.
    assert (got[0].numpy() != 0).any()


@pytest.mark.parametrize("d", [1, 8, 100, 200])
def test_sketch_candidates_are_the_fused_candidates(d):
    """K18's candidate pass on the CPU: fma(race, 1/decay, noise) rounded
    once, as the reference's fused candidate; its workspace rows start on
    32-byte sectors."""
    rng = np.random.default_rng(d)
    race = rng.exponential(size=(50, d)).astype(np.float32)
    noise = rng.exponential(size=(50, d)).astype(np.float32)
    inv = inverse_decay(0.01)
    got = sketch_candidates(torch.from_numpy(race), torch.from_numpy(noise), inv).numpy()
    want = (race.astype(np.float64) * np.float64(np.float32(inv)) + noise).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    pitch = candidate_pitch(d)
    assert pitch >= d and pitch % 8 == 0 and pitch - d < 8


def _tie_draws(n, d, iterations, zero_noise):
    """Races on a grid of four values and noise on a grid of two (or zero):
    at decay 0.5 every candidate 2 race + noise is exact, so ties are many."""
    rng = np.random.default_rng(5)
    race0 = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), (n, d))
    noise = [np.zeros((n, d), np.float32) if zero_noise
             else rng.choice(np.float32([0.0, 0.5]), (n, d)) for _ in range(iterations)]
    return {"race0": race0, "noise": noise}


@pytest.mark.filterwarnings("ignore:Graph")
@pytest.mark.parametrize("zero_noise", [True, False])
def test_nodesketch_breaks_exact_ties_as_the_reference(graphs, monkeypatch, zero_noise):
    g, rg = graphs
    n, d, iterations = g.number_of_nodes, 12, 4
    draws = _tie_draws(n, d, iterations, zero_noise)
    race0, noise = jnp.asarray(draws["race0"]), jnp.asarray(np.stack(draws["noise"]))
    round_keys = jax.random.split(jax.random.PRNGKey(1), iterations)
    real = jax.random.exponential

    def constructed(key, shape, dtype=jnp.float32):
        # race0 is drawn outside the jitted rounds, under PRNGKey(0); each
        # round's noise inside them, under its round key.
        if not isinstance(key, jax.core.Tracer):
            return race0
        return noise[jnp.argmax(jnp.all(round_keys == key, axis=1))]

    monkeypatch.setattr(jax.random, "exponential", constructed)
    want = ref_factorization.NodeSketch(embedding_size=d, iterations=iterations, decay=0.5,
                                        random_state=0).fit_transform(rg).node_embeddings[0]
    monkeypatch.setattr(jax.random, "exponential", real)
    got = NodeSketch(embedding_size=d, iterations=iterations, decay=0.5, random_state=0,
                     device="cpu").run(g, factorization_state_from_jax("NodeSketch", draws, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    # The ties are there: in the first round some row's least candidate
    # comes from two arcs, and some row's equals its own race.
    rows = np.repeat(np.arange(n), g.degrees)
    cand = 2 * draws["race0"][g.col_idx] + draws["noise"][0][g.col_idx]
    best = np.full((n, d), np.inf, np.float32)
    np.minimum.at(best, rows, cand)
    winners = np.zeros((n, d), np.int64)
    np.add.at(winners, rows, cand == best[rows])
    assert (winners >= 2).any() and (best == draws["race0"]).any()


def _race_oracle(g, race, sketch, noise, inv):
    """One round row by row in float64 (exact for the grid draws)."""
    race_out, sketch_out = race.copy(), sketch.copy()
    for r in range(g.number_of_nodes):
        cols = g.col_idx[g.row_ptr[r]:g.row_ptr[r + 1]]
        if len(cols) == 0:
            continue
        cand = race[cols].astype(np.float64) * inv + noise[cols]
        best = cand.min(axis=0)
        win = np.where(cand == best, sketch[cols], np.iinfo(np.int32).max).min(axis=0)
        better = best < race[r]
        race_out[r] = np.minimum(race[r], best)
        sketch_out[r] = np.where(better, win, sketch[r])
    return race_out, sketch_out


@pytest.mark.parametrize("d", [1, 5, 8])
def test_sketch_race_step_plain_matches_a_row_by_row_round(graphs, d):
    g, _ = graphs
    n = g.number_of_nodes
    draws = _tie_draws(n, d, 1, False)
    rng = np.random.default_rng(d)
    sketch = rng.integers(0, n, (n, d)).astype(np.int32)
    race, new_sketch = sketch_race_step_plain(
        g.device("cpu"), torch.from_numpy(draws["race0"]), torch.from_numpy(sketch),
        torch.from_numpy(draws["noise"][0]), 2.0)
    want_race, want_sketch = _race_oracle(g, draws["race0"], sketch, draws["noise"][0], 2.0)
    np.testing.assert_array_equal(race.numpy(), want_race)
    np.testing.assert_array_equal(new_sketch.numpy(), want_sketch)


def test_a_row_without_arcs_and_a_tie_with_its_own_race_keep_their_state():
    # 0 -> 1, 0 -> 2 (tied candidates), 3 -> 4 (equal to 3's race), 5 and 4
    # without out-arcs.
    g = Graph.from_edge_arrays(np.array([0, 0, 3]), np.array([1, 2, 4]), n_nodes=6,
                               directed=True)
    race = torch.tensor([[9.0], [1.0], [1.0], [4.0], [2.0], [0.5]])
    sketch = torch.tensor([[10], [11], [7], [13], [14], [15]], dtype=torch.int32)
    noise = torch.zeros_like(race)
    out_race, out_sketch = sketch_race_step_plain(g.device("cpu"), race, sketch, noise, 2.0)
    assert out_race.flatten().tolist() == [2.0, 1.0, 1.0, 4.0, 2.0, 0.5]
    assert out_sketch.flatten().tolist() == [7, 11, 7, 13, 14, 15]


def test_sketch_race_runs_one_round_per_noise_matrix():
    g = erdos_renyi(80, 300, seed=2)
    tg, n, d = g.device("cpu"), g.number_of_nodes, 6
    gen = torch.Generator().manual_seed(0)
    race = torch.empty(n, d).exponential_(generator=gen)
    sketch = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, d)
    noises = [torch.empty(n, d).exponential_(generator=gen) for _ in range(3)]
    want = race, sketch
    for noise in noises:
        want = sketch_race_step(tg, *want, noise, 100.0)
    got = sketch_race(tg, race, sketch, iter(noises), 100.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # Races only fall, and a sketch id names a node.
    assert bool((got[0] <= race).all()) and int(got[1].min()) >= 0 and int(got[1].max()) < n


@pytest.mark.parametrize("decay", [0.01, 0.3, 0.7, 0.123])
def test_inverse_decay_is_the_float32_reciprocal(decay):
    assert inverse_decay(decay) == float(np.float32(1) / np.float32(decay))
    assert np.float32(inverse_decay(decay)) == inverse_decay(decay)


def test_port_draws_are_exponential():
    """The port's own races and round noise: Exp(1) by their moments (mean 1,
    variance 1, P(x > 1) = e^-1; 4 sigma on 80,000 draws each), the noise
    seeded with 1 whatever random_state is, as the reference's."""
    g = erdos_renyi(4000, 12000, seed=1)
    model = NodeSketch(embedding_size=20, iterations=2, random_state=3, device="cpu")
    state = model.initial_state(g)
    noise = list(state["noise"])
    other = list(NodeSketch(embedding_size=20, iterations=2, random_state=9,
                            device="cpu").initial_state(g)["noise"])
    assert torch.equal(noise[0], other[0]) and not torch.equal(noise[0], noise[1])
    for x in (state["race0"], *noise):
        x = x.double().flatten()
        se = 1 / np.sqrt(x.numel())
        assert x.shape == (80_000,) and bool((x >= 0).all())
        assert abs(float(x.mean()) - 1) < 4 * se
        assert abs(float(x.var()) - 1) < 4 * np.sqrt(8) * se
        assert abs(float((x > 1).double().mean()) - np.exp(-1)) < 4 * 0.5 * se


def test_embed_graph_runs_nodesketch():
    g = erdos_renyi(60, 200, seed=1)
    result = embed_graph(g, "NodeSketch", device="cpu", smoke_test=True)
    emb = result.embedding
    assert emb.shape == (60, 4) and emb.dtype == np.float32
    assert np.array_equal(emb, np.round(emb)) and emb.min() >= 0 and emb.max() < 60
