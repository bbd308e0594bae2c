"""The port's factorization rows on the CPU against embiggen_tpu: NetMF,
GraRep, BoostNE, RandNE, MNMF, NMFADMM and NNSED (NodeSketch is
tests/test_torch_nodesketch.py), their randomized SVD against
scikit-learn's, their parameters, errors and limits.

Each model's fit is `run(graph, initial_state(graph))`; the tests make the
reference's own draws with the `jax.random` calls its fit makes and inject
them (`factorization_state_from_jax`), so both packages compute the same
thing from the same numbers. Tolerances, with their reasons:
- RandNE: rtol 1e-5 / atol 1e-7 (K7's plain version sums the hops' arcs in
  another order than segment_sum).
- BoostNE, MNMF, NMFADMM, NNSED: max abs error at most 5e-5 of the
  reference embedding's largest |entry|, at the smoke parameters and at 5-10
  times their iteration counts (float32 products summed in another order;
  the multiplicative updates carry such differences on, and the largest seen
  on these inputs is under 5e-6 of the scale).
- NetMF and GraRep, per SVD block: the column norms (√s) rtol 1e-4, and
  the Gram matrix emb embᵀ of the leading columns up to the last cut
  between singular values at least 1% apart within 1e-4 of its largest
  |entry|, since singular vectors of nearly equal singular values may
  rotate inside their subspace, or across a cut at a near tie, with float32
  rounding on either side (the components graph has such a tie at NetMF's
  4th and 5th values, 0.05% apart); the columns themselves within 1e-4 of
  the scale where the leading singular values are well apart (at least 1%
  between neighbours, which the test checks).
- randomized_svd against sklearn's: U, s, Vt within 1e-5 of the scale in
  float32 and 1e-12 in float64 on well-separated spectra; s rtol 1e-5 and
  the rank-k products U s Vt within 1e-5 of the scale on a random matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.utils.extmath import randomized_svd as sklearn_randomized_svd

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.embedders import factorization as ref_factorization
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.embedders import factorization
from embiggen_tpu_torch.utils.convert import factorization_state_from_jax
from embiggen_tpu_torch.utils.extmath import randomized_svd

torch.set_num_threads(1)

NAMES = ["NetMF", "GraRep", "BoostNE", "RandNE", "NodeSketch", "MNMF", "NMFADMM", "NNSED"]
DENSE = ["NetMF", "GraRep", "BoostNE", "MNMF", "NMFADMM", "NNSED"]
ITERATIVE_RTOL = 5e-5
GRAM_RTOL = 1e-4


def _pair(kind):
    """The same graph built by both packages."""
    if kind in ("er", "weighted"):
        kw = dict(n_nodes=150, n_edges=600, seed=3, weighted=kind == "weighted")
        return erdos_renyi(**kw), ref_erdos_renyi(**kw)
    rng = np.random.default_rng(13)
    if kind == "components":   # two components and ten isolated nodes
        a = rng.integers(0, 70, (2, 250))
        b = rng.integers(70, 130, (2, 180))
        src, dst = np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])
        kw = dict(n_nodes=140, directed=False)
    else:                      # directed, weighted
        src, dst = rng.integers(0, 120, (2, 480))
        kw = dict(n_nodes=120, directed=True, weights=rng.uniform(0.1, 3.0, 480))
    return Graph.from_edge_arrays(src, dst, **kw), RefGraph.from_edge_arrays(src, dst, **kw)


GRAPHS = ["er", "weighted", "components", "directed"]


@pytest.fixture(scope="module", params=GRAPHS)
def graphs(request):
    g, rg = _pair(request.param)
    assert np.array_equal(g.col_idx, rg.col_idx) and np.array_equal(g.row_ptr, rg.row_ptr)
    return g, rg


def reference_draws(name, model, n):
    """The reference fit's random draws, as its `_fit_transform` makes them."""
    key = jax.random.PRNGKey(model.random_state or 0)
    d = model.embedding_size

    def uniform(k, shape):
        return np.asarray(jax.random.uniform(k, shape, jnp.float32, 0.01, 1.0))

    if name == "RandNE":
        return {"base": np.asarray(jax.random.normal(key, (n, d), jnp.float32) / np.sqrt(d))}
    if name == "BoostNE":
        k = d // (model._iterations + 1)
        blocks = [jax.random.split(jax.random.fold_in(key, i))
                  for i in range(model._iterations + 1)]
        return {"w": [uniform(k1, (n, k)) for k1, _ in blocks],
                "h": [uniform(k2, (k, n)) for _, k2 in blocks]}
    if name == "MNMF":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        c = model._clusters
        return {"m": uniform(k1, (n, d)), "u": uniform(k2, (n, d)),
                "h": uniform(k3, (n, c)), "c": uniform(k4, (c, d))}
    if name == "NMFADMM":
        k1, k2 = jax.random.split(key)
        return {"w": uniform(k1, (n, d)), "h": uniform(k2, (d, n))}
    if name == "NNSED":
        return {"w": uniform(key, (n, d))}
    return {}


def _fit_both(graphs, name, **kwargs):
    g, rg = graphs
    ref = getattr(ref_factorization, name)(**kwargs)
    want = ref.fit_transform(rg).node_embeddings[0]
    port = getattr(factorization, name)(device="cpu", **kwargs)
    state = factorization_state_from_jax(name, reference_draws(name, ref, g.number_of_nodes),
                                         "cpu")
    got = port.run(g, state)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


# --------------------------------------------------------- randomized SVD
def _separated(rng, shape, dtype):
    """A matrix with leading singular values 50, 30, 20, 12, 8, 5, 3, 2 and
    a tail below 0.01."""
    k = min(shape)
    u, _ = np.linalg.qr(rng.normal(size=(shape[0], k)))
    v, _ = np.linalg.qr(rng.normal(size=(shape[1], k)))
    s = 0.01 * rng.random(k)
    s[:8] = [50, 30, 20, 12, 8, 5, 3, 2]
    return ((u * s) @ v.T).astype(dtype)


@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(60, 60), (40, 70), (80, 50)])
@pytest.mark.parametrize("k, n_iter", [(3, 10), (6, 10), (5, 4)])
def test_randomized_svd_matches_sklearn_on_separated_spectra(dtype, tol, shape, k, n_iter):
    a = _separated(np.random.default_rng(k + shape[0]), shape, dtype)
    want = sklearn_randomized_svd(a, k, n_iter=n_iter, random_state=3)
    got = randomized_svd(torch.from_numpy(a), k, n_iter, 3)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("shape", [(60, 60), (40, 70), (80, 50)])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_randomized_svd_without_normalizer_matches_sklearn(shape, n_iter):
    """n_iter <= 2 takes no normalizer between the power iterations: in
    float64 U, s and Vt as tightly as above; in float32 the unnormalized
    iterations raise the spectrum to the power 2 n_iter + 1, which magnifies
    either side's rounding in the lower columns, so there s rtol 1e-5 and
    the rank-k products within 1e-4 of the scale."""
    a = _separated(np.random.default_rng(shape[1]), shape, np.float64)
    want = sklearn_randomized_svd(a, 5, n_iter=n_iter, random_state=3)
    got = randomized_svd(torch.from_numpy(a), 5, n_iter, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())
    a = a.astype(np.float32)
    u, s, vt = sklearn_randomized_svd(a, 5, n_iter=n_iter, random_state=3)
    gu, gs, gvt = (x.numpy() for x in randomized_svd(torch.from_numpy(a), 5, n_iter, 3))
    np.testing.assert_allclose(gs, s, rtol=1e-5)
    low, got_low = (u * s) @ vt, (gu * gs) @ gvt
    np.testing.assert_allclose(got_low, low, rtol=0, atol=1e-4 * np.abs(low).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(50, 50), (30, 45)])
def test_randomized_svd_matches_sklearn_on_a_random_matrix(dtype, shape):
    a = np.random.default_rng(1).random(shape).astype(dtype)
    u, s, vt = sklearn_randomized_svd(a, 6, n_iter=10, random_state=0)
    gu, gs, gvt = (x.numpy() for x in randomized_svd(torch.from_numpy(a), 6, 10, 0))
    np.testing.assert_allclose(gs, s, rtol=1e-5)
    low, got_low = (u * s) @ vt, (gu * gs) @ gvt
    np.testing.assert_allclose(got_low, low, rtol=0, atol=1e-5 * np.abs(low).max())


# ----------------------------------------------------------- NetMF, GraRep
def _hold_svd_embedding(got, want, blocks=1):
    """Each block's column norms (√s); and the Gram matrix of its leading
    columns up to its last cut between singular values at least 1% apart,
    where the subspace they span is well defined (past a near tie, float32
    rounding on either side may rotate vectors across the cut)."""
    per_block = want.shape[1] // blocks
    for b in range(blocks):
        g, w = (x[:, b * per_block:(b + 1) * per_block] for x in (got, want))
        np.testing.assert_allclose(np.linalg.norm(g, axis=0), np.linalg.norm(w, axis=0),
                                   rtol=GRAM_RTOL, atol=1e-6)
        s = np.linalg.norm(w, axis=0) ** 2
        cuts = np.flatnonzero(s[:-1] > 1.01 * s[1:])
        if len(cuts):
            c = cuts[-1] + 1
            gram, want_gram = g[:, :c] @ g[:, :c].T, w[:, :c] @ w[:, :c].T
            np.testing.assert_allclose(gram, want_gram, rtol=0,
                                       atol=GRAM_RTOL * np.abs(want_gram).max())


@pytest.mark.parametrize("kwargs", [
    dict(embedding_size=4), dict(embedding_size=16, order=3),
    dict(embedding_size=32, negative_samples=5, random_state=0),
    dict(embedding_size=100),     # more dimensions than the graphs' rank allows: padded
])
def test_netmf_matches_reference(graphs, kwargs):
    got, want = _fit_both(graphs, "NetMF", **kwargs)
    _hold_svd_embedding(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(embedding_size=4, order=2), dict(embedding_size=12, order=3),
    dict(embedding_size=25, random_state=5),
])
def test_grarep_matches_reference(graphs, kwargs):
    got, want = _fit_both(graphs, "GraRep", **kwargs)
    _hold_svd_embedding(got, want, blocks=kwargs.get("order", 5))


@pytest.mark.parametrize("name, kwargs", [
    ("NetMF", dict(embedding_size=4)), ("GraRep", dict(embedding_size=8, order=4)),
])
def test_svd_rows_match_reference_columns_where_the_spectrum_is_separated(name, kwargs):
    graphs = _pair("er")
    got, want = _fit_both(graphs, name, **kwargs)
    # The leading singular values (the squared column norms) stand apart.
    s = np.linalg.norm(want, axis=0) ** 2
    per_block = kwargs["embedding_size"] // kwargs.get("order", 1)
    for block in s.reshape(-1, per_block):
        assert (block[:-1] / block[1:] > 1.01).all(), block
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAM_RTOL * np.abs(want).max())


# ------------------------------------------------------- the iterative rows
@pytest.mark.parametrize("name, kwargs", [
    ("BoostNE", dict(embedding_size=4, iterations=1, order=1)),
    ("BoostNE", dict(embedding_size=12, iterations=3, order=2)),
    ("BoostNE", dict(embedding_size=10, iterations=4, order=3, random_state=0)),
    ("MNMF", dict(embedding_size=4, clusters=2, iterations=10)),
    ("MNMF", dict(embedding_size=8, clusters=3, iterations=60)),
    ("NMFADMM", dict(embedding_size=4, iterations=10)),
    ("NMFADMM", dict(embedding_size=8, iterations=100, rho=0.5)),
    ("NNSED", dict(embedding_size=4, iterations=3)),
    ("NNSED", dict(embedding_size=8, iterations=30)),
])
def test_iterative_rows_match_reference_on_its_inits(graphs, name, kwargs):
    got, want = _fit_both(graphs, name, **kwargs)
    np.testing.assert_allclose(got, want, rtol=0, atol=ITERATIVE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kwargs", [dict(embedding_size=4), dict(embedding_size=16),
                                    dict(embedding_size=8, alphas=(0.2, 0.3, 0.5))])
def test_randne_matches_reference_on_its_base(graphs, kwargs):
    got, want = _fit_both(graphs, "RandNE", **kwargs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_dense_adjacency_keeps_the_last_of_repeated_arcs():
    """A multigraph's CSR with repeated (source, destination) pairs: the last
    arc's weight stands, as in the reference's numpy assignment."""
    row_ptr = np.array([0, 3, 5, 6, 6])
    col_idx = np.array([1, 1, 2, 0, 0, 3], np.int32)
    weights = np.array([0.5, 2.0, 1.5, 3.0, 0.25, 4.0], np.float32)
    want = ref_factorization._dense_adjacency(RefGraph(row_ptr=row_ptr, col_idx=col_idx,
                                                       weights=weights))
    got = factorization._dense_adjacency(Graph(row_ptr=row_ptr, col_idx=col_idx,
                                               weights=weights), torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 1] == 2.0 and got[1, 0] == 0.25
    unweighted = factorization._dense_adjacency(Graph(row_ptr=row_ptr, col_idx=col_idx),
                                                torch.device("cpu"))
    np.testing.assert_array_equal(unweighted.numpy(), ref_factorization._dense_adjacency(
        RefGraph(row_ptr=row_ptr, col_idx=col_idx)))


# --------------------------------------------- parameters, errors, limits
ROW_KWARGS = {
    "NetMF": dict(iteration=5, order=3, negative_samples=2, random_state=1),
    "GraRep": dict(embedding_size=12, iteration=4, order=3),
    "BoostNE": dict(embedding_size=34, iterations=16, order=3, alpha=0.1),
    "RandNE": dict(alphas=(0.1, 0.2, 0.7), random_state=0),
    "NodeSketch": dict(embedding_size=20, iterations=4, decay=0.2),
    "MNMF": dict(clusters=4, lambd=0.1, alpha=0.2, beta=0.3, iterations=7,
                 lower_control=1e-12, eta=2.0),
    "NMFADMM": dict(iterations=9, rho=2.0, random_state=3),
    "NNSED": dict(embedding_size=16, iterations=2, noise=1e-5),
}


@pytest.mark.parametrize("name", NAMES)
def test_parameters_and_smoke_parameters_match_reference(name):
    port, ref = getattr(factorization, name), getattr(ref_factorization, name)
    assert port.smoke_test_parameters() == ref.smoke_test_parameters()
    assert port.model_name() == ref.model_name() == name
    assert port.is_stochastic() == ref.is_stochastic()
    for kwargs in ({}, ROW_KWARGS[name], port.smoke_test_parameters()):
        if name == "BoostNE" and not kwargs:
            continue   # its defaults raise, in both (test below)
        model = port(device="cpu", **kwargs)
        assert model.parameters() == ref(**kwargs).parameters()
        assert model.clone().parameters() == model.parameters()
        assert model.clone().device == torch.device("cpu")
    assert get_model_from_library(name, task_name="Node Embedding") is port


def test_boostne_defaults_raise_the_references_error():
    """embedding_size 100 with iterations 16: 17 blocks do not divide it."""
    for cls in (factorization.BoostNE, ref_factorization.BoostNE):
        with pytest.raises(ValueError, match=r"iterations\+1 = 17 blocks; embedding_size "
                                             r"\(100\) must be divisible by it"):
            cls()
    with pytest.raises(ValueError) as port_err:
        factorization.BoostNE(embedding_size=10, iterations=3, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        ref_factorization.BoostNE(embedding_size=10, iterations=3)
    assert str(port_err.value) == str(ref_err.value)


def test_grarep_raises_the_references_divisibility_error():
    with pytest.raises(ValueError) as port_err:
        factorization.GraRep(embedding_size=12, order=5, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        ref_factorization.GraRep(embedding_size=12, order=5)
    assert str(port_err.value) == str(ref_err.value)
    assert "must be divisible by order (5)" in str(port_err.value)


@pytest.mark.parametrize("name", DENSE)
def test_dense_rows_refuse_graphs_over_the_limit(monkeypatch, name):
    monkeypatch.setattr(factorization, "DENSE_NODE_LIMIT", 100)
    monkeypatch.setattr(ref_factorization, "DENSE_NODE_LIMIT", 100)
    g, rg = _pair("er")
    kwargs = factorization.BoostNE.smoke_test_parameters() if name == "BoostNE" else {}
    with pytest.raises(ValueError) as port_err:
        getattr(factorization, name)(device="cpu", **kwargs).fit_transform(g)
    with pytest.raises(ValueError) as ref_err:
        getattr(ref_factorization, name)(**kwargs).fit_transform(rg)
    assert str(port_err.value) == str(ref_err.value)
    assert "has 150 nodes (limit 100)" in str(port_err.value)
    assert factorization.DENSE_NODE_LIMIT == 100
    assert ref_factorization.DENSE_NODE_LIMIT == 100


def test_dense_limit_matches_reference():
    assert factorization.DENSE_NODE_LIMIT == ref_factorization.DENSE_NODE_LIMIT == 32_768


@pytest.mark.parametrize("name", ["RandNE", "NodeSketch"])
def test_sparse_rows_have_no_dense_limit(monkeypatch, name):
    monkeypatch.setattr(factorization, "DENSE_NODE_LIMIT", 100)
    g, _ = _pair("er")
    emb = getattr(factorization, name).into_smoke_test(device="cpu").fit_transform(g)
    assert emb.embedding.shape == (150, 4)


def test_factorization_state_from_jax_checks_its_input():
    with pytest.raises(ValueError, match="not a factorization model"):
        factorization_state_from_jax("SkipGram", {}, "cpu")
    with pytest.raises(KeyError, match=r"Missing MNMF draws: \['c'\]"):
        factorization_state_from_jax("MNMF", {k: np.ones(2) for k in "muh"}, "cpu")
    state = factorization_state_from_jax("BoostNE", {"w": [np.ones((3, 2))] * 2,
                                                     "h": [np.ones((2, 3))] * 2}, "cpu")
    assert [t.dtype for t in state["w"]] == [torch.float32] * 2
    assert factorization_state_from_jax("NetMF", {}, "cpu") == {}


# ------------------------------------------------------ the port's draws
def _moments_hold(x, mean, var, kurtosis_term):
    """|sample mean - mean| and |sample variance - var| within 4 standard
    errors (the variance's from the fourth central moment)."""
    x = x.double().flatten()
    n = x.numel()
    assert abs(float(x.mean()) - mean) < 4 * np.sqrt(var / n)
    assert abs(float(x.var()) - var) < 4 * np.sqrt((kurtosis_term - var ** 2) / n)


def test_port_draws_have_the_references_laws():
    """RandNE's base N(0, 1/D); the NMF inits U[0.01, 1): inside the range,
    with the uniform's mean and variance."""
    g = erdos_renyi(2000, 6000, seed=1)
    d = 40
    base = factorization.RandNE(embedding_size=d, device="cpu").initial_state(g)["base"]
    assert base.shape == (2000, d)
    _moments_hold(base, 0.0, 1.0 / d, 3.0 / d ** 2)
    width = 0.99
    uniform = dict(mean=0.505, var=width ** 2 / 12, kurtosis_term=width ** 4 / 80)
    states = [factorization.MNMF(embedding_size=d, clusters=5, device="cpu").initial_state(g),
              factorization.NMFADMM(embedding_size=d, device="cpu").initial_state(g),
              factorization.NNSED(embedding_size=d, device="cpu").initial_state(g),
              factorization.BoostNE(embedding_size=d, iterations=3,
                                    device="cpu").initial_state(g)]
    shapes = [{"m": (2000, d), "u": (2000, d), "h": (2000, 5), "c": (5, d)},
              {"w": (2000, d), "h": (d, 2000)}, {"w": (2000, d)},
              {"w": [(2000, 10)] * 4, "h": [(10, 2000)] * 4}]
    for state, want in zip(states, shapes):
        assert {k: (tuple(v.shape) if torch.is_tensor(v) else [tuple(t.shape) for t in v])
                for k, v in state.items()} == want
        x = torch.cat([t.flatten() for v in state.values()
                       for t in (v if isinstance(v, list) else [v])])
        assert float(x.min()) >= 0.01 and float(x.max()) < 1.0
        _moments_hold(x, **uniform)
    seeded = [factorization.NNSED(device="cpu", random_state=s).initial_state(g)["w"]
              for s in (4, 4, 5)]
    assert torch.equal(seeded[0], seeded[1]) and not torch.equal(seeded[0], seeded[2])


# ---------------------------------------------------------------- fits
@pytest.mark.parametrize("name", NAMES)
def test_embed_graph_runs_every_row(name):
    g = erdos_renyi(60, 200, seed=1)
    result = embed_graph(g, name, device="cpu", smoke_test=True)
    assert result.embedding_method_name == name
    emb = result.embedding
    assert emb.shape == (60, 4) and emb.dtype == np.float32 and np.isfinite(emb).all()
    again = embed_graph(g, name, device="cpu", smoke_test=True).embedding
    np.testing.assert_array_equal(emb, again)
