"""The CBOW step — counterpart of
`embiggen_tpu/models/embedders/walk_based.py::CBOW._gathered_grads` and, for
the update, of the scatter half of `_mean_scatter`.

For every walk, each centre l in [w, L - w) takes the hidden row h_l, the
mean of node_embedding's rows at the positions m with 0 < |m - l| <= w, and
scores it against its own output_embedding row and the walk's K negatives'
rows, each logit with its output_bias and a straight-through clip at
+-clipping_value; the loss is the sampled softmax's -log p(centre), times
the centre weight.

CBOW's three tables map one to one onto SkipGram's `scatter.SkipGramSums`:
sums_w / counts_w take node_embedding over every walk position, sums_c /
counts_c output_embedding over the walk positions and the negatives, and
sums_b output_bias with the counts it shares with sums_c. So kernel K11
(`csrc/cbow.cu`, closed-form gradients), `cbow_update`, adds the gradients
into those sums and returns the loss sum, and K4's
`scatter.skipgram_mean_combine` applies CBOW's per-row mean step unchanged.

On CPU tensors it is its plain version below, which takes the gradients by
autograd of the loss (`cbow_grads_plain`, per walk position and per negative
slot exactly as the JAX version returns them), and so checks the closed form
independently, and scatters them with `index_add_`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import _build
from .scatter import SkipGramSums
from .skipgram import Grads, _st_clip

# K11's phases, as its PHASE_CLOCK build stamps them (`phase_split`).
PHASES = ("gather", "hidden", "logits_softmax", "out_neg_gradients", "input_gradients")


def cbow_grads_plain(
    node_embedding: torch.Tensor,
    output_embedding: torch.Tensor,
    output_bias: torch.Tensor,
    walks: torch.Tensor,
    negs: torch.Tensor,
    window_size: int,
    clipping_value: float,
    center_w: Optional[torch.Tensor] = None,
) -> Grads:
    """(loss_sum, (g_in [B,L,D], g_out [B,L,D], g_ob [B,L]), (g_neg [B,K,D],
    g_nb [B,K])): the reference's loss, differentiated by autograd with
    respect to the gathered rows."""
    w = window_size
    length = walks.shape[1]
    walks, negs = walks.long(), negs.long()
    pos = torch.arange(length, device=walks.device)
    off = pos[None, :] - pos[:, None]
    avg = ((off.abs() <= w) & (off != 0)).float() / (2 * w)            # [L, L]
    center_ok = ((pos >= w) & (pos < length - w)).float()
    per_center_w = center_ok[None, :] if center_w is None else center_ok[None, :] * center_w
    with torch.enable_grad():
        rows = [
            node_embedding[walks], output_embedding[walks], output_bias[walks],
            output_embedding[negs], output_bias[negs],
        ]
        rows = [r.detach().requires_grad_() for r in rows]
        in_rows, out_rows, out_b, neg_emb, neg_b = rows
        hidden = torch.einsum("lm,bmd->bld", avg, in_rows)
        true_logit = (hidden * out_rows).sum(dim=2) + out_b
        neg_logits = torch.einsum("bld,bkd->blk", hidden, neg_emb) + neg_b[:, None, :]
        logits = _st_clip(torch.cat([true_logit[..., None], neg_logits], dim=2),
                          clipping_value)
        per = -F.log_softmax(logits, dim=2)[..., 0]
        loss = (per * per_center_w).sum()
        g_in, g_out, g_ob, g_neg, g_nb = torch.autograd.grad(loss, rows)
    return loss.detach(), (g_in, g_out, g_ob), (g_neg, g_nb)


def cbow_update_plain(
    node_embedding: torch.Tensor,
    output_embedding: torch.Tensor,
    output_bias: torch.Tensor,
    walks: torch.Tensor,
    negs: torch.Tensor,
    window_size: int,
    clipping_value: float,
    sums: SkipGramSums,
    center_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K11: the plain gradients, scattered into
    `sums` in the order `mean_scatter_plain` takes for CBOW's three tables
    (walk rows, then negatives)."""
    loss, (g_in, g_out, g_ob), (g_neg, g_nb) = cbow_grads_plain(
        node_embedding, output_embedding, output_bias, walks, negs,
        window_size, clipping_value, center_w,
    )
    d = node_embedding.shape[1]
    flat, negs_flat = walks.reshape(-1).long(), negs.reshape(-1).long()
    one = torch.ones((), dtype=torch.float32, device=walks.device)
    sums.counts_w.index_add_(0, flat, one.expand(flat.shape[0]))
    for seg in (flat, negs_flat):
        sums.counts_c.index_add_(0, seg, one.expand(seg.shape[0]))
    sums.sums_w.index_add_(0, flat, g_in.reshape(-1, d))
    sums.sums_c.index_add_(0, flat, g_out.reshape(-1, d))
    sums.sums_c.index_add_(0, negs_flat, g_neg.reshape(-1, d))
    sums.sums_b.index_add_(0, flat, g_ob.reshape(-1))
    sums.sums_b.index_add_(0, negs_flat, g_nb.reshape(-1))
    return loss


def _launch(counter, node_embedding, output_embedding, output_bias, walks, negs,
            window_size, clipping_value, sums: SkipGramSums, center_w, clocks=None,
            defines=()):
    """Check the inputs, launch K11 once into `sums`, and return the
    per-walk losses [B]."""
    dev = walks.device
    n, d = node_embedding.shape
    b, length = walks.shape
    k = negs.shape[1]
    if window_size < 1 or length <= 2 * window_size:
        raise ValueError(f"walk_length ({length}) must exceed 2*window_size "
                         f"({2 * window_size}), and window_size be at least 1.")
    if k < 1:
        raise ValueError("K11 needs at least one negative per walk.")
    for t, name, shape in (
        (node_embedding, "node_embedding", (n, d)),
        (output_embedding, "output_embedding", (n, d)),
        (output_bias, "output_bias", (n,)),
        (center_w, "center_w", (b, length)),
    ):
        _build.check(t, name, torch.float32, shape, dev)
    _build.check(walks, "walks", torch.int32, (b, length), dev)
    _build.check(negs, "negs", torch.int32, (b, k), dev)
    sums.check(n, d, dev)
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    _build.launch(
        counter, "ebt_cbow_update", dev,
        node_embedding.data_ptr(), output_embedding.data_ptr(),
        output_bias.data_ptr(), walks.data_ptr(), negs.data_ptr(),
        _build.ptr(center_w), loss.data_ptr(), *map(_build.ptr, sums.buffers()),
        _build.ptr(clocks), b, length, k, d, window_size, float(clipping_value),
        defines=defines,
    )
    return loss


def cbow_update(
    node_embedding: torch.Tensor,
    output_embedding: torch.Tensor,
    output_bias: torch.Tensor,
    walks: torch.Tensor,
    negs: torch.Tensor,
    window_size: int,
    clipping_value: float,
    sums: SkipGramSums,
    center_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Add one CBOW step's gradient rows into `sums` (and its counts);
    returns the loss sum. K11 on CUDA tensors, the plain version on CPU
    tensors."""
    if not _build.is_cuda(walks):
        return cbow_update_plain(
            node_embedding, output_embedding, output_bias, walks, negs,
            window_size, clipping_value, sums, center_w,
        )
    return _launch("cbow_update", node_embedding, output_embedding, output_bias, walks,
                   negs, window_size, clipping_value, sums, center_w).sum()


def phase_split(node_embedding, output_embedding, output_bias, walks, negs,
                window_size, clipping_value, sums: SkipGramSums,
                center_w=None) -> Dict[str, float]:
    """Share of K11's block time in each phase (PHASES), from the clock64()
    stamps of the `_build.PHASE_CLOCK` build, summed over the blocks of one
    launch into `sums` on CUDA tensors. The launch is counted nowhere."""
    clocks = torch.zeros((walks.shape[0], len(PHASES) + 1), dtype=torch.int64,
                         device=walks.device)
    _launch(None, node_embedding, output_embedding, output_bias, walks, negs, window_size,
            clipping_value, sums, center_w, clocks=clocks, defines=_build.PHASE_CLOCK)
    return _build.clock_shares(clocks, PHASES)
