"""Exact laws of the p/q walk samplers, computed in numpy from a graph's own
arrays, and a chi-square test of whole walks against them. Shared by the CPU
tests, the GPU tests and `chip_smoke.py`; imports neither jax nor torch.

A step from curr after prev weighs a candidate c by return_weight when
c == prev, 1 when c is in prev's membership row, else explore_weight, times
its arc weight."""
import math

import numpy as np
from scipy.stats import chi2


def pq_law(cands, weights, prev, members, rw, ew):
    """Per candidate slot: the probability of the exact p/q pick."""
    w = np.where(cands == prev, rw, np.where(np.isin(cands, members), 1.0, ew)) * weights
    return w / w.sum()


def rejection_law(cands, q, prev, members, rw, ew, n_tries):
    """Per candidate slot: the exact law of the rejection step. T proposals
    from q (uniform over the row, or by arc weight), the first accepted
    (with probability a = w / w_max, w the p/q factor), else a pick among
    the T in proportion to w. With r the chance that one proposal is
    rejected, c is the first accepted with probability q a (1 - r^T) /
    (1 - r); all reject with probability r^T, and then the proposals are
    drawn from q' = q (1 - a) / r and c is picked with probability
    T q'(c) w(c) E[1 / (w(c) + S)], S the sum of the other T - 1 weights,
    which take three values: an expectation over a multinomial."""
    q = np.asarray(q, np.float64) / np.sum(q)
    cls = np.where(cands == prev, 0, np.where(np.isin(cands, members), 1, 2))
    v = np.array([rw, 1.0, ew])
    w = v[cls]
    a = w / v.max()
    r = float((q * (1 - a)).sum())
    law = q * a * (1 - r ** n_tries) / (1 - r) if r < 1 else np.zeros_like(q)
    if r > 0:
        q_rej = q * (1 - a) / r
        pi = np.bincount(cls, weights=q_rej, minlength=3)
        # Every split (n_return, n_common, n_explore) of the other T - 1.
        m = n_tries - 1
        splits = np.array([(i, j, m - i - j) for i in range(m + 1) for j in range(m + 1 - i)])
        log_coef = (math.lgamma(m + 1)
                    - np.vectorize(math.lgamma)(splits + 1.0).sum(axis=1))
        log_pi = np.log(np.where(pi > 0, pi, 1.0))
        prob = np.exp(log_coef + splits @ log_pi)
        prob[((splits > 0) & (pi == 0)).any(axis=1)] = 0.0
        inv = (prob[None, :] / (w[:, None] + splits @ v)).sum(axis=1)
        law = law + r ** n_tries * n_tries * q_rej * w * inv
    return law


def rows_of_32_and_33():
    """(src, dst, n) of an undirected graph where node 0 has 32 neighbours
    and node 1 has 33, so at cap 40 (ell_cap 33) node 0's ELL row fills
    K9's first 32-slot round of loads and ends on padding, and node 1's
    takes a second round; a ring and a few random edges join the others."""
    rng = np.random.default_rng(8)
    n = 120
    src = np.concatenate([np.zeros(32, int), np.ones(33, int), np.arange(2, n),
                          rng.integers(35, n, 60)])
    dst = np.concatenate([np.arange(2, 34), np.arange(2, 35), np.r_[np.arange(3, n), 2],
                          rng.integers(35, n, 60)])
    return src, dst, n


def two_hubs():
    """(src, dst, n) of an undirected graph with hubs 0 and 1 of about 150
    and 120 neighbours (60 shared) over a ring of 400, so at cap 100 their
    ELL rows are random subsamples in random order."""
    rng = np.random.default_rng(5)
    n = 400
    a = rng.choice(np.arange(2, n), 150, replace=False)
    b = np.concatenate([a[:60], rng.choice(np.setdiff1d(np.arange(2, n), a), 60,
                                           replace=False)])
    ring = np.arange(n)
    return (np.concatenate([ring, np.zeros(150, int), np.ones(120, int), [0]]),
            np.concatenate([(ring + 1) % n, a, b, [1]]), n)


def arc_weights(n_arcs, seed=0):
    """Seeded positive arc weights in [0.25, 1.25)."""
    return (0.25 + np.random.default_rng(seed).random(n_arcs)).astype(np.float32)


def n_tries_for(rw, ew):
    ratio = max(rw, 1.0, ew) / min(rw, 1.0, ew)
    return 8 if ratio <= 4.0 else 16


class Laws:
    """The step laws of one sampler on one graph (row_ptr, col_idx,
    weights as numpy arrays), as (candidates, probabilities) per step:
    `first(curr)` for the walk's first step, `step(prev, curr)` after it.
    `ell` (ell_cols [N, cap], ell_w or None, cap_eff) takes K9's laws over
    the ELL rows, else the sampler draws over the whole CSR rows: the exact
    p/q law, or with `n_tries` the rejection step's."""

    def __init__(self, row_ptr, col_idx, weights, rw, ew, ell=None, n_tries=None):
        self.row_ptr, self.col_idx, self.weights = row_ptr, col_idx, weights
        self.rw, self.ew, self.ell, self.n_tries = rw, ew, ell, n_tries
        self._steps = {}

    def _row(self, node, width=None):
        if self.ell is not None:
            cols, w, cap_eff = self.ell
            row = cols[node][:width or cols.shape[1]]
            keep = row >= 0
            wts = np.ones(len(row)) if w is None else w[node][:len(row)].astype(np.float64)
            return row[keep], wts[keep]
        s, e = self.row_ptr[node], self.row_ptr[node + 1]
        wts = np.ones(e - s) if self.weights is None else self.weights[s:e].astype(np.float64)
        return self.col_idx[s:e], wts

    def first(self, curr):
        cands, wts = self._row(curr)
        return cands, wts / wts.sum()

    def step(self, prev, curr):
        if (prev, curr) not in self._steps:
            self._steps[prev, curr] = self._step(prev, curr)
        return self._steps[prev, curr]

    def _step(self, prev, curr):
        cands, wts = self._row(curr, None if self.ell is None else self.ell[2])
        members = self._row(prev)[0]
        if self.n_tries is not None:
            return cands, rejection_law(cands, wts, prev, members, self.rw, self.ew,
                                        self.n_tries)
        return cands, pq_law(cands, wts, prev, members, self.rw, self.ew)


def walks_chi2_p(walks, laws, n_nodes, err_rows=200):
    """(p, err): the pooled chi-square p-value of every move of `walks`
    [B, L] against its step law given the walk so far (the first moves by
    `laws.first`, grouped by node; later moves by `laws.step`, grouped by
    (prev, curr) over all positions), over the groups whose every cell
    expects at least 5, df = sum over groups of (cells - 1); and the largest
    |empirical - exact| probability over the groups of at least `err_rows`
    moves. Raises if a walk moves where its law gives no mass, or leaves a
    node without candidates."""
    walks = np.asarray(walks, np.int64)
    stat, df, err = 0.0, 0, 0.0
    firsts = (np.full(len(walks), -1), walks[:, 0], walks[:, 1])
    later = (walks[:, :-2].ravel(), walks[:, 1:-1].ravel(), walks[:, 2:].ravel())
    for prev, curr, nxt in (firsts, later):
        keys = (prev + 1) * (n_nodes + 1) + curr
        order = np.argsort(keys, kind="stable")
        uniq, first, counts = np.unique(keys[order], return_index=True, return_counts=True)
        for key, start, count in zip(uniq, first, counts):
            p_node, c_node = int(key // (n_nodes + 1)) - 1, int(key % (n_nodes + 1))
            cands, probs = (laws.first(c_node) if p_node < 0
                            else laws.step(p_node, c_node))
            seen = nxt[order[start:start + count]]
            if len(cands) == 0 or probs.sum() == 0:
                if not (seen == c_node).all():
                    raise AssertionError(f"a walk left {c_node}, which has no candidates")
                continue
            p = np.zeros(n_nodes)
            np.add.at(p, cands, probs)
            observed = np.bincount(seen, minlength=n_nodes)
            if observed[p == 0].sum():
                raise AssertionError(f"a move from {c_node} after {p_node} has no mass")
            cells = p > 0
            expected = count * p[cells]
            if expected.min() >= 5:
                stat += ((observed[cells] - expected) ** 2 / expected).sum()
                df += int(cells.sum()) - 1
            if count >= err_rows:
                err = max(err, float(np.abs(observed[cells] / count - p[cells]).max()))
    if df < 50:
        raise AssertionError("too few testable cells for the chi-square test")
    return float(chi2.sf(stat, df)), err
