"""The Walklets update — counterpart of
`embiggen_tpu/models/embedders/walklets.py::WalkletsSkipGram._walklet_updates`
and `WalkletsCBOW._walklet_updates`, as `_WalkletsBase._step` applies them.

For each power p = 1..P the pairs of a walk are its positions exactly p
apart, in both directions: inputs `concat(walks[:, :L-p], walks[:, p:])`,
targets the same two slices in the other order. Each pair scores its input
row (node_embedding[p - 1]) against its target row and the walk's own K
negatives (context_embedding[p - 1], with context_bias[p - 1]): NCE for
"skipgram" (softplus(pos) - pos + sum_k softplus(neg_k)), the sampled softmax
for "cbow" (-log_softmax([pos, neg_1..K])[0]).

Kernel K12 (`csrc/walklets.cu`), `walklets_update`, adds the gradients with
respect to the gathered rows into a `scatter.SkipGramSums` of P * N rows of
width sub (row (p - 1) * N + node; inputs into sums_w, targets and negatives
into sums_c and sums_b, counted per pair and per walk slot) and returns the
loss sum per power. K4's `skipgram_mean_combine` over the flat [P * N, sub]
views of the tables then applies the per-row mean step of every power in one
pass: the reference's mean-mode `Update`s on the stacked tables.

On CPU tensors it is its plain version below, which takes the gradients by
autograd of the reference's loss (so it checks the kernel's closed form
independently) and scatters them with `index_add_`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .scatter import SkipGramSums

MODES = ("skipgram", "cbow")


def stride_pairs(walks: torch.Tensor, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs, targets) [B, 2(L - stride)] of the pairs `stride` apart, in
    the reference's order."""
    m = walks.shape[1] - stride
    a, c = walks[:, :m], walks[:, stride:]
    return torch.cat([a, c], dim=1), torch.cat([c, a], dim=1)


def walklets_update_plain(
    node_embedding: torch.Tensor, context_embedding: torch.Tensor,
    context_bias: torch.Tensor, walks: torch.Tensor, negs: torch.Tensor,
    power: int, sums: SkipGramSums, mode: str,
) -> torch.Tensor:
    """Plain PyTorch version of K12: each power's loss differentiated by
    autograd with respect to the gathered rows, the gradients scattered into
    `sums` at row (p - 1) * N + node in the order `mean_scatter_plain` takes
    for the three tables (pairs, then negatives). Returns the loss sum per
    power [P]."""
    n, sub = node_embedding.shape[1:]
    negs = negs.long()
    one = torch.ones((), dtype=torch.float32, device=walks.device)
    losses = []
    for p in range(power):
        inputs, targets = stride_pairs(walks.long(), p + 1)
        with torch.enable_grad():
            rows = [node_embedding[p][inputs], context_embedding[p][targets],
                    context_bias[p][targets], context_embedding[p][negs],
                    context_bias[p][negs]]
            rows = [r.detach().requires_grad_() for r in rows]
            w_rows, t_rows, t_b, n_rows, n_b = rows
            pos = (w_rows * t_rows).sum(-1) + t_b
            neg = torch.einsum("bmd,bkd->bmk", w_rows, n_rows) + n_b[:, None, :]
            if mode == "skipgram":
                loss = (F.softplus(pos) - pos).sum() + F.softplus(neg).sum()
            else:
                logits = torch.cat([pos[..., None], neg], dim=-1)
                loss = -F.log_softmax(logits, dim=-1)[..., 0].sum()
            g_in, g_t, g_tb, g_n, g_nb = torch.autograd.grad(loss, rows)
        inp, tgt = inputs.reshape(-1) + p * n, targets.reshape(-1) + p * n
        neg_rows = negs.reshape(-1) + p * n
        sums.counts_w.index_add_(0, inp, one.expand(inp.shape[0]))
        for seg in (tgt, neg_rows):
            sums.counts_c.index_add_(0, seg, one.expand(seg.shape[0]))
        sums.sums_w.index_add_(0, inp, g_in.reshape(-1, sub))
        sums.sums_c.index_add_(0, tgt, g_t.reshape(-1, sub))
        sums.sums_c.index_add_(0, neg_rows, g_n.reshape(-1, sub))
        sums.sums_b.index_add_(0, tgt, g_tb.reshape(-1))
        sums.sums_b.index_add_(0, neg_rows, g_nb.reshape(-1))
        losses.append(loss.detach())
    return torch.stack(losses)


def walklets_update(
    node_embedding: torch.Tensor, context_embedding: torch.Tensor,
    context_bias: torch.Tensor, walks: torch.Tensor, negs: torch.Tensor,
    power: int, sums: SkipGramSums, mode: str,
) -> torch.Tensor:
    """Add one Walklets step's gradient rows into `sums` (P * N rows of width
    sub) and its counts; returns the loss sum per power [P]. The tables are
    [P, N, sub] and the bias [P, N]. K12 on CUDA tensors, the plain version
    on CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}.")
    b, length = walks.shape
    if length <= power:
        raise ValueError(f"walk_length ({length}) must exceed power ({power}), so that "
                         "every power has a pair.")
    if not _build.is_cuda(walks):
        return walklets_update_plain(node_embedding, context_embedding, context_bias,
                                     walks, negs, power, sums, mode)
    dev = walks.device
    _, n, sub = node_embedding.shape
    k = negs.shape[1]
    if k < 1:
        raise ValueError("K12 needs at least one negative per walk.")
    for t, name, shape in ((node_embedding, "node_embedding", (power, n, sub)),
                           (context_embedding, "context_embedding", (power, n, sub)),
                           (context_bias, "context_bias", (power, n))):
        _build.check(t, name, torch.float32, shape, dev)
    _build.check(walks, "walks", torch.int32, (b, length), dev)
    _build.check(negs, "negs", torch.int32, (b, k), dev)
    sums.check(power * n, sub, dev)
    loss = torch.empty((b, power), dtype=torch.float32, device=dev)
    # The walk counts the kernel's second pass turns into every power's
    # counts: positions and negative slots per node, end positions per power.
    scratch = torch.zeros((power + 2) * n, dtype=torch.float32, device=dev)
    _build.launch(
        "walklets_update", "ebt_walklets_update", dev,
        node_embedding.data_ptr(), context_embedding.data_ptr(), context_bias.data_ptr(),
        walks.data_ptr(), negs.data_ptr(), loss.data_ptr(),
        *map(_build.ptr, sums.buffers()), scratch.data_ptr(), n, b, length, k, sub, power,
        MODES.index(mode),
    )
    return loss.sum(0)
