"""The exact laws of K14's batches, as expected counts given a batch's
positives, in torch on any device: the siamese batch (uniform arcs, one
side replaced by a drawn node chosen by a fair coin) and LINE's negatives
(drawn nodes, with `avoid_false_negatives` one unchecked redraw of those
that are arcs of the slot's source). Shared by `tests/test_torch_batches.py`
and `chip_smoke.py`, which imports it with `tests/` on the path. The graph
must have no duplicate arcs (as `Graph.from_edge_arrays` builds it)."""
import numpy as np
import torch


def draw_law(tg, scale_free: bool) -> torch.Tensor:
    """[N] float64 probability of each node in one draw: degree-
    proportional (the head of a uniform arc) or uniform."""
    if scale_free:
        return tg.degrees.double() / tg.n_arcs
    return torch.full((tg.n_nodes,), 1.0 / tg.n_nodes, dtype=torch.float64,
                      device=tg.device)


def arc_ids(tg, src, dst) -> torch.Tensor:
    """The arc id of each (src, dst); raises unless every pair is an arc."""
    from embiggen_tpu_torch.ops.walks import csr_edge_ids_plain

    ids, found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst)
    if not bool(found.all()):
        raise AssertionError("a positive of the batch is not an arc")
    return ids.long()


def siamese_counts(tg, batch, scale_free: bool):
    """{name: (observed, expected)} numpy counts of a siamese batch given its
    positives:
    "corrupted nodes", the drawn node of every slot where it differs from
    the side it replaced, per node, with a last cell for the slots where it
    equals it; "sides", the slots whose src was replaced, whose dst was, and
    neither. Raises if a slot changed both sides."""
    src, dst, csrc, cdst = (t.long() for t in batch[:4])
    b, n = src.numel(), tg.n_nodes
    side_src, side_dst = csrc != src, cdst != dst
    if bool((side_src & side_dst).any()):
        raise AssertionError("a siamese slot has both sides replaced")
    q = draw_law(tg, scale_free)
    nodes = torch.cat([csrc[side_src], cdst[side_dst]])
    seen = torch.bincount(nodes, minlength=n).double()
    # The drawn node v shows unless it equals the replaced side's node.
    want = q * (b - 0.5 * torch.bincount(src, minlength=n) - 0.5 * torch.bincount(dst, minlength=n))
    neither = float(b - nodes.numel())
    sides_seen = [float(side_src.sum()), float(side_dst.sum()), neither]
    sides_want = [0.5 * float((1 - q[src]).sum()), 0.5 * float((1 - q[dst]).sum())]
    sides_want.append(b - sum(sides_want))
    return {
        "corrupted nodes": (torch.cat([seen, seen.new_tensor([neither])]).cpu().numpy(),
                            torch.cat([want, want.new_tensor([b - float(want.sum())])])
                            .cpu().numpy()),
        "sides": (np.asarray(sides_seen), np.asarray(sides_want)),
    }


def line_negative_law(tg, src, scale_free: bool, avoid: bool) -> torch.Tensor:
    """[N] expected share of each node among the negatives of slots with
    sources `src` (the sum over slots of P(v | src) over the slot count)."""
    q = draw_law(tg, scale_free)
    if not avoid:
        return q
    n = tg.n_nodes
    sources = tg.sources.long() if tg.sources is not None else torch.repeat_interleave(
        torch.arange(n, device=tg.device), tg.degrees.long())
    m = torch.bincount(src.long(), minlength=n).double()
    # P(v | s) = q(v) (1 - A(s, v)) + c(s) q(v), with c(s) the chance that
    # the first draw is an arc of s (then redrawn once, unchecked).
    c = torch.bincount(sources, weights=q[tg.col_idx.long()], minlength=n)
    adjacent = torch.bincount(tg.col_idx.long(), weights=m[sources], minlength=n)
    return q * (src.numel() + float((m * c).sum()) - adjacent) / src.numel()


def line_negative_law_by_source(tg, scale_free: bool, avoid: bool) -> torch.Tensor:
    """[N, N] P(negative = v | source = s), for a small graph."""
    n = tg.n_nodes
    q = draw_law(tg, scale_free)
    if not avoid:
        return q.expand(n, n)
    adj = torch.zeros((n, n), dtype=torch.float64, device=tg.device)
    sources = torch.repeat_interleave(torch.arange(n, device=tg.device), tg.degrees.long())
    adj[sources, tg.col_idx.long()] = 1.0
    return q[None, :] * (1 - adj) + (adj @ q)[:, None] * q[None, :]


def exact_p(observed, expected, min_expected: float = 5.0) -> float:
    """Chi-square p-value of counts against their expected counts, adjacent
    cells merged until each expects at least `min_expected` (a short tail
    joins the last full cell). Raises if a cell that expects nothing has
    counts."""
    from scipy.stats import chi2

    o = np.asarray(observed, np.float64).ravel()
    e = np.asarray(expected, np.float64).ravel()
    if (o[e <= 0] > 0).any():
        raise AssertionError("counts in a cell that expects none")
    group = np.zeros(len(e), np.int64)
    g, acc = 0, 0.0
    for i, x in enumerate(e):
        group[i] = g
        acc += x
        if acc >= min_expected:
            g, acc = g + 1, 0.0
    if g < 2:
        raise AssertionError("too few draws for a chi-square test")
    group[group == g] = g - 1
    eg, og = np.bincount(group, weights=e), np.bincount(group, weights=o)
    return float(chi2.sf(((og - eg) ** 2 / eg).sum(), len(eg) - 1))


def rows_p(observed, expected) -> float:
    """Chi-square p-value of [rows, cells] counts against their expected
    counts, each row's total fixed (df: cells - 1 per row). Cells that
    expect nothing must have no counts and are left out; every other cell
    must expect at least 5."""
    from scipy.stats import chi2

    o = np.asarray(observed, np.float64)
    e = np.asarray(expected, np.float64)
    if (o[e <= 0] > 0).any():
        raise AssertionError("counts in a cell that expects none")
    cells = e > 0
    if (e[cells] < 5).any():
        raise AssertionError("a cell expects fewer than 5 counts")
    stat = ((o - e) ** 2 / np.where(cells, e, 1.0))[cells].sum()
    return float(chi2.sf(stat, (cells.sum(1) - 1).clip(min=0).sum()))
