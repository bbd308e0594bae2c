"""Banded NCE step of SkipGram — counterpart of
`embiggen_tpu/models/embedders/walk_based.py::SkipGram._gathered_grads`
and, for the update, of the scatter half of `_mean_scatter`.

For every walk, each centre l in [w, L - w) is scored against its contexts
within +-w (positive target 1/(2w)) and against the walk's K negatives,
with context_bias added and a straight-through clip at +-clipping_value.

Kernel K3 (`csrc/skipgram.cu`, closed-form gradients),
`skipgram_nce_update`, adds the gradients with respect to the gathered rows
into persistent per-node sums and counts (`scatter.SkipGramSums`) and
returns the loss sum; K4's `skipgram_mean_combine` then applies the per-row
mean step. This is SkipGram's training step on the card: no [B, L, D]
gradient is written.

On CPU tensors it is its plain version below, which takes the gradients
by autograd of the loss (`skipgram_nce_grads_plain`, which returns them per
walk position and per negative slot exactly as the JAX version does), and
so checks the closed form independently, and scatters them with
`index_add_`, as `scatter.mean_scatter_plain` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .scatter import SkipGramSums

Grads = Tuple[torch.Tensor, Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]

PHASES = ("gather", "scores", "gradients")


def _st_clip(x: torch.Tensor, c: float) -> torch.Tensor:
    """Straight-through clip: the value is clip(x, -c, c), the gradient
    passes through unscaled."""
    return x + (x.clamp(-c, c) - x).detach()


def skipgram_nce_grads_plain(
    node_embedding: torch.Tensor,
    context_embedding: torch.Tensor,
    context_bias: torch.Tensor,
    walks: torch.Tensor,
    negs: torch.Tensor,
    window_size: int,
    clipping_value: float,
    center_w: Optional[torch.Tensor] = None,
) -> Grads:
    """(loss_sum, (g_w [B,L,D], g_c [B,L,D], g_b [B,L]), (g_neg [B,K,D],
    g_nb [B,K])): the reference's loss, differentiated by autograd with
    respect to the gathered rows."""
    w = window_size
    length = walks.shape[1]
    walks, negs = walks.long(), negs.long()
    with torch.enable_grad():
        rows = [
            node_embedding[walks], context_embedding[walks],
            context_bias[walks], context_embedding[negs], context_bias[negs],
        ]
        rows = [r.detach().requires_grad_() for r in rows]
        w_rows, c_rows, b_rows, neg_emb, neg_b = rows
        centre = slice(w, length - w)
        cw = (torch.ones_like(b_rows[:, centre]) if center_w is None
              else center_w[:, centre])
        wc = w_rows[:, centre]                                # [B, C, D]
        loss = torch.zeros((), dtype=node_embedding.dtype,
                           device=node_embedding.device)
        for off in range(-w, w + 1):
            if off == 0:
                continue
            ctx = slice(w + off, length - w + off)
            s = _st_clip(
                torch.einsum("bld,bld->bl", wc, c_rows[:, ctx]) + b_rows[:, ctx],
                clipping_value,
            )
            loss = loss + ((F.softplus(s) - s / (2 * w)) * cw).sum()
        neg_s = _st_clip(
            torch.einsum("bld,bkd->blk", wc, neg_emb) + neg_b[:, None, :],
            clipping_value,
        )
        loss = loss + (F.softplus(neg_s) * cw[:, :, None]).sum()
        g_w, g_c, g_b, g_neg, g_nb = torch.autograd.grad(loss, rows)
    return loss.detach(), (g_w, g_c, g_b), (g_neg, g_nb)


def skipgram_nce_update_plain(
    node_embedding: torch.Tensor,
    context_embedding: torch.Tensor,
    context_bias: torch.Tensor,
    walks: torch.Tensor,
    negs: torch.Tensor,
    window_size: int,
    clipping_value: float,
    sums: SkipGramSums,
    center_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K3: the plain gradients,
    scattered into `sums` in the order `mean_scatter_plain` takes for
    SkipGram's three tables (walk rows, then negatives)."""
    loss, (g_w, g_c, g_b), (g_neg, g_nb) = skipgram_nce_grads_plain(
        node_embedding, context_embedding, context_bias, walks, negs,
        window_size, clipping_value, center_w,
    )
    d = node_embedding.shape[1]
    flat, negs_flat = walks.reshape(-1).long(), negs.reshape(-1).long()
    one = torch.ones((), dtype=torch.float32, device=walks.device)
    sums.counts_w.index_add_(0, flat, one.expand(flat.shape[0]))
    for seg in (flat, negs_flat):
        sums.counts_c.index_add_(0, seg, one.expand(seg.shape[0]))
    sums.sums_w.index_add_(0, flat, g_w.reshape(-1, d))
    sums.sums_c.index_add_(0, flat, g_c.reshape(-1, d))
    sums.sums_c.index_add_(0, negs_flat, g_neg.reshape(-1, d))
    sums.sums_b.index_add_(0, flat, g_b.reshape(-1))
    sums.sums_b.index_add_(0, negs_flat, g_nb.reshape(-1))
    return loss


def _launch(counter, node_embedding, context_embedding, context_bias, walks,
            negs, window_size, clipping_value, center_w, sums: SkipGramSums,
            clocks=None, defines=()):
    """Check the inputs, launch K3 once into `sums`, and return the per-walk
    losses [B]."""
    dev = walks.device
    n, d = node_embedding.shape
    b, length = walks.shape
    k = negs.shape[1]
    if window_size < 1 or length <= 2 * window_size:
        raise ValueError(f"walk_length ({length}) must exceed 2*window_size "
                         f"({2 * window_size}), and window_size be at least 1.")
    if k < 1:
        raise ValueError("K3 needs at least one negative per walk.")
    for t, name, shape in (
        (node_embedding, "node_embedding", (n, d)),
        (context_embedding, "context_embedding", (n, d)),
        (context_bias, "context_bias", (n,)),
        (center_w, "center_w", (b, length)),
    ):
        _build.check(t, name, torch.float32, shape, dev)
    _build.check(walks, "walks", torch.int32, (b, length), dev)
    _build.check(negs, "negs", torch.int32, (b, k), dev)
    sums.check(n, d, dev)
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    _build.launch(
        counter, "ebt_skipgram_nce", dev,
        node_embedding.data_ptr(), context_embedding.data_ptr(),
        context_bias.data_ptr(), walks.data_ptr(), negs.data_ptr(),
        _build.ptr(center_w), loss.data_ptr(), *map(_build.ptr, sums.buffers()),
        _build.ptr(clocks), b, length, k, d, window_size, float(clipping_value),
        defines=defines,
    )
    return loss


def skipgram_nce_update(
    node_embedding: torch.Tensor,
    context_embedding: torch.Tensor,
    context_bias: torch.Tensor,
    walks: torch.Tensor,
    negs: torch.Tensor,
    window_size: int,
    clipping_value: float,
    sums: SkipGramSums,
    center_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Add one step's gradient rows into `sums` (and its counts); returns
    the loss sum. K3 on CUDA tensors, the plain version on CPU tensors."""
    if not _build.is_cuda(walks):
        return skipgram_nce_update_plain(
            node_embedding, context_embedding, context_bias, walks, negs,
            window_size, clipping_value, sums, center_w,
        )
    return _launch("skipgram_nce_update", node_embedding, context_embedding,
                   context_bias, walks, negs, window_size, clipping_value,
                   center_w, sums=sums).sum()


def phase_split(node_embedding, context_embedding, context_bias, walks, negs,
                window_size, clipping_value, sums: SkipGramSums,
                center_w=None) -> Dict[str, float]:
    """Share of K3's block time in each phase (PHASES), from the clock64()
    stamps of the `_build.PHASE_CLOCK` build, summed over the blocks of one
    launch into `sums` on CUDA tensors. The launch is counted nowhere."""
    clocks = torch.zeros((walks.shape[0], 4), dtype=torch.int64, device=walks.device)
    _launch(None, node_embedding, context_embedding, context_bias, walks, negs,
            window_size, clipping_value, center_w, sums, clocks=clocks,
            defines=_build.PHASE_CLOCK)
    return _build.clock_shares(clocks, PHASES)
