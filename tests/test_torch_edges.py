"""K5 (CSR membership) and K6 (the GCN edge minibatch) on the CPU: K5 held
exactly against embiggen_tpu's `csr_edge_ids` / `csr_has_edges`, K6 in
distribution against the exact probabilities of its draw-and-redraw process,
and its label layout against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import binomtest, chi2

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.ops.negatives import edge_prediction_mini_batch as ref_mini_batch
from embiggen_tpu.ops.walks import csr_edge_ids as ref_csr_edge_ids
from embiggen_tpu.ops.walks import csr_has_edges as ref_csr_has_edges
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.ops.negatives import arc_sources, edge_prediction_mini_batch
from embiggen_tpu_torch.ops.walks import csr_edge_ids, csr_has_edges

torch.set_num_threads(1)
P_MIN = 1e-3


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    # Nodes 60..69 have no arcs; 0 has a long row.
    src = np.concatenate([rng.integers(0, 60, 300), np.zeros(40, np.int64)])
    dst = np.concatenate([rng.integers(0, 60, 300), rng.integers(1, 60, 40)])
    return Graph.from_edge_arrays(src, dst, n_nodes=70)


def _queries(graph, seed):
    rng = np.random.default_rng(seed)
    n = graph.number_of_nodes
    last = graph.number_of_directed_edges - 1
    src = np.concatenate([graph.sources[[0, last]], graph.sources[::3],
                          rng.integers(0, n, 400), [65, 69, 0, 59]])
    dst = np.concatenate([graph.col_idx[[0, last]], graph.col_idx[::3],
                          rng.integers(0, n, 400), [3, 0, 69, 0]])
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("seed", [1, 2])
def test_csr_edge_ids_match_reference(graph, seed):
    src, dst = _queries(graph, seed)
    rp, ci = graph.row_ptr.astype(np.int32), graph.col_idx
    ids, found = csr_edge_ids(torch.from_numpy(rp), torch.from_numpy(ci),
                              torch.from_numpy(src), torch.from_numpy(dst))
    want_ids, want_found = ref_csr_edge_ids(jnp.asarray(rp), jnp.asarray(ci),
                                            jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    assert ids.dtype == torch.int32 and found[:2].all()
    np.testing.assert_array_equal(ids[:2].numpy(), [0, graph.number_of_directed_edges - 1])
    has = csr_has_edges(torch.from_numpy(rp), torch.from_numpy(ci),
                        torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(
        has.numpy(), np.asarray(ref_csr_has_edges(jnp.asarray(rp), jnp.asarray(ci),
                                                  jnp.asarray(src), jnp.asarray(dst))))


def test_csr_edge_ids_on_an_empty_graph():
    g = Graph.from_edge_arrays(np.zeros(0), np.zeros(0), n_nodes=4)
    tg = g.device("cpu")
    ids, found = csr_edge_ids(tg.row_ptr, tg.col_idx, torch.tensor([0, 3], dtype=torch.int32),
                              torch.tensor([1, 2], dtype=torch.int32))
    assert ids.tolist() == [0, 0] and not found.any()


@pytest.mark.parametrize("with_sources", [True, False])
def test_arc_sources(graph, with_sources):
    tg = graph.device("cpu", with_sources=with_sources)
    arc = torch.arange(graph.number_of_directed_edges)
    np.testing.assert_array_equal(arc_sources(tg, arc).numpy(), graph.sources)


@pytest.mark.parametrize("batch, rate", [(1001, 0.5), (1000, 0.25), (7, 1.0), (9, 0.0)])
def test_mini_batch_layout_matches_reference(batch, rate):
    g = erdos_renyi(50, 200, seed=1)
    rg = RefGraph(row_ptr=g.row_ptr, col_idx=g.col_idx, directed=False)
    src, dst, labels = edge_prediction_mini_batch(
        g.device("cpu", with_sources=True), torch.Generator().manual_seed(0),
        batch, negative_samples_rate=rate)
    _, _, want = ref_mini_batch(rg.device(with_sources=True), jax.random.PRNGKey(0),
                                batch, negative_samples_rate=rate)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    n_neg = int(round(batch * rate))
    assert labels.dtype == torch.float32 and int(labels.sum()) == batch - n_neg
    assert src.dtype == dst.dtype == torch.int32 and src.shape == (batch,)


def _exact_negative_marginals(g, scale_free, n_attempts):
    """(P(src = s), P(dst = d), P(final pair is an arc or loop)) of a
    negative slot: a pair is drawn from p ⊗ p, and redrawn while it is bad,
    at most n_attempts times; the last draw is kept unchecked."""
    n = g.number_of_nodes
    p = g.degrees / g.degrees.sum() if scale_free else np.full(n, 1.0 / n)
    bad = np.eye(n, dtype=bool)
    bad[g.sources, g.col_idx] = True
    q = p[:, None] * p[None, :]
    beta = q[bad].sum()
    keep_good = (1 - beta ** n_attempts) / (1 - beta) + beta ** n_attempts
    final = np.where(bad, q * beta ** n_attempts, q * keep_good)
    return final.sum(1), final.sum(0), beta ** (n_attempts + 1)


@pytest.mark.parametrize("scale_free, n_attempts", [(True, 2), (False, 2), (True, 0)])
def test_mini_batch_matches_exact_distribution(scale_free, n_attempts):
    # A dense graph, so that redraws matter: about a third of the pairs are arcs.
    g = erdos_renyi(30, 150, seed=2)
    tg = g.device("cpu", with_sources=True)
    gen = torch.Generator().manual_seed(5)
    batch, n_pos = 40000, 20000
    src, dst, labels = edge_prediction_mini_batch(
        tg, gen, batch, use_scale_free_distribution=scale_free,
        n_attempts=n_attempts)
    keys = g.sources.astype(np.int64) * 30 + g.col_idx
    pos = src[:n_pos].numpy().astype(np.int64) * 30 + dst[:n_pos].numpy()
    arc = np.searchsorted(keys, pos)
    assert (keys[np.minimum(arc, len(keys) - 1)] == pos).all()
    counts = np.bincount(arc, minlength=len(keys))
    stat = ((counts - n_pos / len(keys)) ** 2 / (n_pos / len(keys))).sum()
    assert chi2.sf(stat, len(keys) - 1) > P_MIN
    p_src, p_dst, p_bad = _exact_negative_marginals(g, scale_free, n_attempts)
    s, d = src[n_pos:].numpy(), dst[n_pos:].numpy()
    for got, p in ((s, p_src), (d, p_dst)):
        expected = p * len(got)
        observed = np.bincount(got, minlength=30)
        stat = ((observed - expected) ** 2 / expected)[expected > 0].sum()
        assert chi2.sf(stat, (expected > 0).sum() - 1) > P_MIN
    is_bad = (s == d) | np.isin(s.astype(np.int64) * 30 + d, keys)
    assert binomtest(int(is_bad.sum()), len(s), p_bad).pvalue > P_MIN
