"""The exact laws of the first-order walk step's batch (`ops.negatives.
first_order_batch`: uniform starts tiled over the iterations, first-order
walks, per-walk negatives), as chi-square p-values in torch on any device.
Shared by `tests/test_torch_walk_batch.py`, `tests/test_torch_cuda.py` and
`chip_smoke.py`, which imports it with `tests/` on the path. The graph must
have no duplicate arcs (as `Graph.from_edge_arrays` builds it)."""
import numpy as np
import torch
from scipy.stats import chi2

from batch_laws import draw_law

# Bins of the joint tests: node id mod BINS, a row slot's BINS-quantile.
BINS = 8


def pooled_p(observed, expected, rows, n_rows: int, min_expected: float = 5.0) -> float:
    """Chi-square p-value over the rows (groups of cells) whose every cell
    expects at least `min_expected`; df = sum over those rows of (cells - 1).
    Raises when fewer than 20 cells are testable."""
    observed, expected = (np.asarray(x, np.float64) for x in (observed, expected))
    rows = np.asarray(rows)
    ok = np.ones(n_rows, bool)
    np.logical_and.at(ok, rows, expected >= min_expected)
    cells = ok[rows]
    if cells.sum() < 20:
        raise AssertionError("too few testable cells for the chi-square test")
    stat = (((observed - expected) ** 2) / expected)[cells].sum()
    return float(chi2.sf(stat, cells.sum() - np.unique(rows[cells]).size))


def law_p(observed, expected, min_expected: float = 5.0) -> float:
    """Chi-square p-value of counts over one law's cells; the cells that
    expect fewer than `min_expected` are merged into one. Raises if a cell
    of probability 0 holds a draw."""
    observed, expected = (np.asarray(x, np.float64) for x in (observed, expected))
    if observed[expected == 0].any():
        raise AssertionError("a draw fell where the law puts no mass")
    small = expected < min_expected
    observed = np.append(observed[~small], observed[small].sum())
    expected = np.append(expected[~small], expected[small].sum())
    if expected[-1] < min_expected:
        observed, expected = observed[:-1], expected[:-1]
    if observed.size < 20:
        raise AssertionError("too few testable cells for the chi-square test")
    return float(chi2.sf(((observed - expected) ** 2 / expected).sum(), observed.size - 1))


def arc_probabilities(tg) -> torch.Tensor:
    """[E] float64 probability of each arc given its source: uniform over
    the row, or by its weight."""
    src = torch.repeat_interleave(torch.arange(tg.n_nodes, device=tg.device),
                                  tg.degrees.long())
    w = (torch.ones(tg.n_arcs, dtype=torch.float64, device=tg.device) if tg.weights is None
         else tg.weights.double())
    row_sum = torch.zeros(tg.n_nodes, dtype=torch.float64, device=tg.device).index_add_(
        0, src, w)
    return w / row_sum[src]


def moves(tg, walks):
    """(source, arc id) of every move of `walks`; raises unless each step is
    an arc of the graph or a stay on a zero-degree node."""
    from embiggen_tpu_torch.ops.walks import csr_edge_ids_plain

    src, dst = walks[:, :-1].reshape(-1).long(), walks[:, 1:].reshape(-1).long()
    if int(src.min()) < 0 or int(src.max()) >= tg.n_nodes or int(dst.min()) < 0 \
            or int(dst.max()) >= tg.n_nodes:
        raise AssertionError("a walk holds a node id outside [0, N)")
    moved = tg.degrees.long()[src] > 0
    if not bool((dst[~moved] == src[~moved]).all()):
        raise AssertionError("a walk left a zero-degree node")
    src, dst = src[moved], dst[moved]
    ids, found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst)
    if not bool(found.all()):
        raise AssertionError("a walk step is not an arc of the graph")
    return src, ids.long()


def batch_p(tg, walks, negs, batch_size: int, scale_free: bool) -> dict:
    """{law: p-value} of a batch: starts uniform over the nodes, moves by the
    exact transitions given their source (pooled over sources), negatives
    by `draw_law`. Raises unless walk b starts where walk b mod B does and
    every move is an arc or a zero-degree stay."""
    n = tg.n_nodes
    walks, negs = walks.long(), negs.long()
    starts = walks[:batch_size, 0]
    if not bool((walks[:, 0].view(-1, batch_size) == starts).all()):
        raise AssertionError("the starts are not tiled over the iterations")
    p = {"starts": law_p(torch.bincount(starts, minlength=n).cpu(),
                         np.full(n, batch_size / n))}
    if walks.shape[1] > 1:
        src, arcs = moves(tg, walks)
        sources = torch.repeat_interleave(torch.arange(n, device=tg.device),
                                          tg.degrees.long())
        n_from = torch.bincount(src, minlength=n).double()
        p["moves"] = pooled_p(torch.bincount(arcs, minlength=tg.n_arcs).cpu(),
                              (n_from[sources] * arc_probabilities(tg)).cpu(), sources.cpu(),
                              n)
    if negs.numel():
        p["negatives"] = law_p(torch.bincount(negs.reshape(-1), minlength=n).cpu(),
                               (negs.numel() * draw_law(tg, scale_free)).cpu())
    return p


def batch_counts(tg, walks, negs, batch_size: int) -> dict:
    """{part: numpy counts} of a batch's independent draws: its starts by
    node, the first step of walks 0..B-1 (one a start) by arc id, its
    negatives by node. Later moves follow their walk's path, so their
    counts are not a sample of independent draws."""
    n = tg.n_nodes
    _, arcs = moves(tg, walks[:batch_size, :2])
    return {"starts": torch.bincount(walks[:batch_size, 0].long(), minlength=n).cpu().numpy(),
            "first steps": torch.bincount(arcs, minlength=tg.n_arcs).cpu().numpy(),
            "negatives": torch.bincount(negs.reshape(-1).long(), minlength=n).cpu().numpy()}


def two_sample_p(a: dict, b: dict) -> dict:
    """{part: p-value} that two batches' counts (`batch_counts`, of equal
    sizes) come from one law, over the cells that hold at least 10 draws
    of the two together."""
    from scipy.stats import chi2_contingency

    out = {}
    for part in a:
        keep = (a[part] + b[part]) >= 10
        if keep.sum() < 20:
            raise AssertionError(f"too few testable cells for {part}")
        out[part] = float(chi2_contingency(np.stack([a[part][keep], b[part][keep]]))[1])
    return out


def _joint_p(a_bins, b_bins, b_law) -> float:
    """Independence of two draws per walker: the counts of (a bin, b bin)
    against, for each a bin, the sum over its walkers of each walker's own
    law of b (`b_law` [walkers, BINS])."""
    observed = torch.zeros(BINS, BINS, dtype=torch.float64, device=a_bins.device)
    observed.index_put_((a_bins, b_bins), torch.ones_like(a_bins, dtype=torch.float64),
                        accumulate=True)
    expected = torch.zeros_like(observed).index_add_(0, a_bins, b_law.double())
    rows = np.repeat(np.arange(BINS), BINS)
    return pooled_p(observed.reshape(-1).cpu(), expected.reshape(-1).cpu(), rows, BINS)


def stream_independence_p(tg, walks, negs, batch_size: int, scale_free: bool) -> dict:
    """{pair: p-value} that a walker's start, its first step and its
    negatives are independent draws, on an unweighted graph: the start's
    bin (id mod BINS), the first step's slot bin (BINS * slot // degree,
    whose law given the degree is exact) and the negatives' bins (id mod
    BINS: the first and second negative, two words of one Philox output,
    and the first and fifth, of two), each pair against the second draw's
    own law given the first. Walkers on a zero-degree start are left out
    of the pairs with the first step."""
    if tg.weights is not None:
        raise ValueError("the slot law here is the unweighted graph's")
    dev = tg.device
    walks, negs = walks[:batch_size].long(), negs[:batch_size].long()
    start, first = walks[:, 0], walks[:, 1]
    deg = tg.degrees.long()[start]
    node_bins = torch.arange(tg.n_nodes, device=dev) % BINS
    neg_law = torch.zeros(BINS, dtype=torch.float64, device=dev).index_add_(
        0, node_bins, draw_law(tg, scale_free))
    start_law = torch.bincount(node_bins, minlength=BINS).double() / tg.n_nodes

    def per_walker(law, count):
        return law.expand(count, BINS)

    moved = deg > 0
    from embiggen_tpu_torch.ops.walks import csr_edge_ids_plain

    ids, _ = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, start[moved], first[moved])
    slot = ids.long() - tg.row_ptr.long()[start[moved]]
    d = deg[moved]
    slot_bin = BINS * slot // d
    # P(slot bin k | degree d) = #{s < d : BINS s // d == k} / d
    # = (ceil((k + 1) d / BINS) - ceil(k d / BINS)) / d.
    k = torch.arange(BINS + 1, device=dev)
    ceil = torch.div(k[None, :] * d[:, None] + BINS - 1, BINS, rounding_mode="floor")
    slot_law = (ceil[:, 1:] - ceil[:, :-1]).double() / d[:, None]
    bins = [node_bins[negs[:, j]] for j in range(min(negs.shape[1], 5))]
    p = {
        "start, negative 0": _joint_p(node_bins[start], bins[0],
                                      per_walker(neg_law, batch_size)),
        "start, first step": _joint_p(node_bins[start[moved]], slot_bin, slot_law),
        "first step, negative 0": _joint_p(slot_bin, bins[0][moved],
                                           per_walker(neg_law, int(moved.sum()))),
        "walker b, b + 1 starts": _joint_p(node_bins[start[:-1]], node_bins[start[1:]],
                                           per_walker(start_law, batch_size - 1)),
    }
    if len(bins) > 1:
        p["negatives 0, 1"] = _joint_p(bins[0], bins[1], per_walker(neg_law, batch_size))
    if len(bins) > 4:
        p["negatives 0, 4"] = _joint_p(bins[0], bins[4], per_walker(neg_law, batch_size))
    return p
