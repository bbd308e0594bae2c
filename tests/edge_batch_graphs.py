"""CSR graphs and queries that reach every route of the guided membership
search (K5 and K6's redraw check, `csrc/csr.cuh`), in numpy, shared by the
CPU tests and the card tests (which import no JAX).

The search reads a 32-byte sector (8 ids) where an even spread of the row's
heads puts dst, interpolates up to three such sectors and bisects what is
left; so the rows here are empty, short, 60-70 ids long (several sectors, at
every alignment), a few hundred, and hubs of 5,000 and 70,000, some with
repeated heads (a multigraph, where the answer is the first of equal arcs),
and rows bunched in a narrow window of ids (far from an even spread).
Also the exact law of K6's negatives against a graph to avoid."""
import numpy as np
from scipy.stats import binomtest, chi2

P_MIN = 1e-3

# (row length, repeated heads, the id window of its heads: None for all
# ids, else (first, stop) as shares of the ids) of the rows after the empty
# and short ones; the windowed rows are far from an even spread, so the
# search's interpolated sectors miss and its bisection settles them.
LONG_ROWS = ((60, False, None), (61, False, None), (62, False, None), (63, False, None),
             (64, False, None), (65, False, None), (66, False, None), (67, False, None),
             (70, True, None), (130, False, None), (400, True, None), (5000, False, None),
             (70_000, True, None), (3000, False, (0.0, 0.05)), (3000, True, (0.95, 1.0)),
             (500, False, (0.4, 0.41)))


def membership_graph(seed: int = 0, n_nodes: int = 80_000):
    """(row_ptr [N + 1] int32, col_idx int32): rows 0-99 empty or short
    (0-40 ids), then one row for each of LONG_ROWS, the rest empty. Heads
    are sorted in each row; a row with repeated heads draws them with
    replacement."""
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(0, 41, 100)) + [n for n, _, _ in LONG_ROWS]
    repeats = [bool(rng.random() < 0.2) for _ in range(100)] + [r for _, r, _ in LONG_ROWS]
    windows = [None] * 100 + [w for _, _, w in LONG_ROWS]
    rows = []
    for n, rep, window in zip(lengths, repeats, windows):
        first, stop = (0, n_nodes) if window is None else (int(window[0] * n_nodes),
                                                           int(window[1] * n_nodes))
        rows.append(first + np.sort(rng.choice(stop - first, n, replace=rep)) if n else
                    np.zeros(0, np.int64))
    counts = np.zeros(n_nodes, np.int64)
    counts[:len(rows)] = lengths
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return row_ptr, np.concatenate(rows).astype(np.int32)


def membership_queries(row_ptr, col_idx, seed: int = 1):
    """(src, dst) int32: every arc of the non-empty rows up to 1,000 a row
    (the first, the last and a spread of the others), each head - 1 and
    + 1, the first and last node, and pairs of uniform nodes."""
    rng = np.random.default_rng(seed)
    n = len(row_ptr) - 1
    deg = np.diff(row_ptr)
    src, dst = [], []
    for s in np.flatnonzero(deg[:200] > 0):
        lo, hi = row_ptr[s], row_ptr[s + 1]
        picks = np.unique(np.concatenate([[lo, hi - 1], rng.integers(lo, hi, 1000)]))
        heads = col_idx[picks].astype(np.int64)
        for d in (heads, heads - 1, heads + 1, np.array([0, n - 1])):
            d = np.clip(d, 0, n - 1)
            src.append(np.full(len(d), s))
            dst.append(d)
    src.append(rng.integers(0, 200, 4000))
    dst.append(rng.integers(0, n, 4000))
    return (np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32))


def negative_law(g, avoid, scale_free, n_attempts):
    """(P(src = s), P(dst = d), P(the kept pair is an arc of `avoid` or a
    loop)) of a negative slot: pairs from p ⊗ p over `g` (degree-
    proportional or uniform), redrawn while an arc of `avoid` or a loop, at
    most n_attempts times; the last draw kept unchecked."""
    n = g.number_of_nodes
    p = g.degrees / g.degrees.sum() if scale_free else np.full(n, 1.0 / n)
    bad = np.eye(n, dtype=bool)
    inside = (avoid.sources < n) & (avoid.col_idx < n)
    bad[avoid.sources[inside], avoid.col_idx[inside]] = True
    q = p[:, None] * p[None, :]
    beta = q[bad].sum()
    keep_good = (1 - beta ** n_attempts) / (1 - beta) + beta ** n_attempts
    final = np.where(bad, q * beta ** n_attempts, q * keep_good)
    return final.sum(1), final.sum(0), beta ** (n_attempts + 1), bad


def held_to_law(s, d, g, avoid, scale_free, n_attempts):
    """Assert that negatives (s, d) (numpy) follow `negative_law`: each
    side's marginal by chi-square, the share of arcs of `avoid` or loops by
    a binomial test, each at p > P_MIN."""
    p_src, p_dst, p_bad, bad = negative_law(g, avoid, scale_free, n_attempts)
    n = g.number_of_nodes
    for got, p in ((s, p_src), (d, p_dst)):
        expected = p * len(got)
        observed = np.bincount(got, minlength=n)
        stat = ((observed - expected) ** 2 / expected)[expected > 0].sum()
        assert chi2.sf(stat, (expected > 0).sum() - 1) > P_MIN
    assert binomtest(int(bad[s, d].sum()), len(s), p_bad).pvalue > P_MIN
