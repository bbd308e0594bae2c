"""K13b's float64 reference: each table's change in one GloVe step with every
product and sum taken in float64, and the tolerance that the float32 kernel
and its plain version are held to on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase 18).

The tolerance is float32's error bound for what the step computes, per
element, at twice u (the unit roundoff, 2^-24) a rounding. Each term
carries d + 9 roundings: d + 3 for the prediction's sum (the dot product and
the two biases and log X), 3 for g = 2 f diff / B (with 1 / B's own) and 3
for -lr g x (with lr's own); they are charged to the term's size, the
dot product taken in absolute values. An element that takes k terms then
adds them to its value t0 in whatever order the atomics give, k additions
each rounding a partial sum no larger than |t0| plus the terms' sizes:
2 u (k |t0| + (k + d + 9) sum of sizes). An element no entry touches has k
0 and a tolerance of 0; an entry repeated B times in a batch gives its rows
k = B.

The check holds the change (the table after the step less the table before
it) against the exact change, so a step that moves nothing, flips a sign,
leaves a side out or updates the wrong rows fails wherever the exact change
is many times the tolerance; `signal` says how many times it is.
"""
import torch

U32 = 2.0 ** -24


def table_copies(values, layout: str, device, power: int = 3):
    """K13b's four tables holding `values` (numpy), copied to `device`:
    tensors of their own (layout ""), views of slice 1 of [power, N, D] and
    [power, N] tables ("walklets slice", as Walklets GloVe steps), or views
    at a storage offset of one float ("odd offset": not 16-byte aligned, the
    kernel's scalar route at any D)."""
    out = []
    for v in values:
        t = torch.tensor(v, device=device)
        if layout == "walklets slice":
            stacked = torch.zeros((power,) + t.shape, device=device)
            stacked[1] = t
            t = stacked[1]
        elif layout == "odd offset":
            t = torch.zeros(t.numel() + 1, device=device)[1:].view(t.shape).copy_(t)
        elif layout:
            raise ValueError(f"unknown layout {layout!r}")
        out.append(t)
    return out


def step_exact(entries, ids, tables, lr):
    """([(table before, exact change, tolerance)] in float64 for node,
    context, center bias and context bias, (exact loss sum, its tolerance))
    of one step on `tables` as they are now."""
    ids = ids.long()
    i, j = entries.ci[ids].long(), entries.cj[ids].long()
    f, lx = entries.f_x[ids].double(), entries.log_x[ids].double()
    w, c = tables[0][i].double(), tables[1][j].double()
    bi, bj = tables[2][i].double(), tables[3][j].double()
    d = w.shape[1]
    prod = w * c
    diff = prod.sum(1) + bi + bj - lx
    size = prod.abs().sum(1) + bi.abs() + bj.abs() + lx.abs()
    b = ids.numel()
    g, g_size = 2 * f * diff / b, 2 * f * size / b
    out = []
    for table, rows, x in ((tables[0], i, c), (tables[1], j, w), (tables[2], i, None),
                           (tables[3], j, None)):
        t0 = table.double()
        k = torch.bincount(rows, minlength=table.shape[0]).double()
        if x is None:
            terms, sizes = -lr * g, lr * g_size
        else:
            terms, sizes = -lr * g[:, None] * x, lr * g_size[:, None] * x.abs()
            k = k[:, None]
        change = torch.zeros_like(t0).index_add_(0, rows, terms)
        sizes = torch.zeros_like(t0).index_add_(0, rows, sizes)
        out.append((t0, change, 2 * U32 * (k * t0.abs() + (k + d + 9) * sizes)))
    loss = (f * diff * diff).sum()
    loss_tol = 2 * U32 * float((f * (2 * diff.abs() + size) * size).sum() * (d + 4)
                               + b * loss)
    return out, (float(loss), loss_tol)


def worst_share(tables, exact) -> float:
    """The largest |(table - before) - exact change| as a share of its
    tolerance (at most 1 passes)."""
    return max(float((((t.double() - t0) - change).abs() / tol.clamp(min=1e-300)).max())
               for t, (t0, change, tol) in zip(tables, exact))


def signal(exact) -> float:
    """The median, over the elements a step touches, of |exact change| as a
    share of its tolerance: how far a step that left them unchanged would
    fail the check."""
    return float(torch.cat([(change.abs() / tol)[tol > 0] for _, change, tol in exact])
                 .median())


def controls(before, after):
    """Wrong results a check must refuse, from the tables before and after
    one step: no step, the node side (node rows and both biases) or the
    context side left out, and every change's sign flipped."""
    return {
        "no step": before,
        "node side left out": [before[0], after[1], before[2], before[3]],
        "context side left out": [after[0], before[1], after[2], after[3]],
        "sign flipped": [2 * b - a for b, a in zip(before, after)],
    }
