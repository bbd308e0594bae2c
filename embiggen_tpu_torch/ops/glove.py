"""GloVe's co-occurrence build and weighted-least-squares step — counterparts
of `embiggen_tpu/models/embedders/glove.py::GloVe._cooccurrences` (with the
per-power count of `walklets.py::WalkletsGloVe._fit_transform`) and of
`GloVe._batch_updates` with `embiggen_tpu/ops/losses.py::glove_loss`.

Kernel K13 (`csrc/glove.cu`), in two parts:

- `cooccurrences` (K13a): the symmetric window pairs of the walks at the
  given (stride, weight)s, summed per distinct key in float64 with the
  diagonal dropped, in ascending key order. On the card: a counting sort of
  the pairs' entries by center (a count, a scan, a scatter), a sort and sum
  of each center's segment in a warp's registers or a block's shared memory
  (a hub's, longer than that, bucketed by windows of contexts, a block
  summing each window in shared memory), a scan of the distinct counts and
  a copy into place; no 64-bit key, hash table or library sort.
- `glove_step` (K13b): one SGD step for B drawn entry ids on the weighted
  least squares of pred = w_i . c_j + b_i + b_j against log X, applied to
  the tables IN PLACE (the JAX version returns new ones), every gradient
  taken from the tables as they stood before the step. On the card: a
  gradient launch, then a node-side and a context-side update launch, on a
  `GloVeStepWorkspace` that a fit allocates once.

Entry ids are drawn uniformly over [0, E) by `draw_entries`: K2's uniform
mode on the card, `torch.randint` from the fit's generator on the CPU.

On CPU tensors each is its plain version below.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build


class Entries(NamedTuple):
    """A co-occurrence matrix's non-zero entries: centers and contexts
    (int32), f(X) and log X (float32), aligned."""

    ci: torch.Tensor
    cj: torch.Tensor
    f_x: torch.Tensor
    log_x: torch.Tensor

    @property
    def n_entries(self) -> int:
        return int(self.ci.shape[0])


def glove_strides(window_size: int) -> Tuple[Tuple[int, float], ...]:
    """GloVe's (stride, weight)s: 1..w at the distance decay 1/d."""
    return tuple((d, 1.0 / d) for d in range(1, window_size + 1))


def _check_inputs(walks: torch.Tensor, n_nodes: int, strides) -> None:
    if n_nodes >= 2**31:
        raise ValueError(f"n_nodes ({n_nodes}) must be under 2^31, so that keys "
                         "a * N + b fit in int64.")
    if walks.ndim != 2:
        raise ValueError(f"walks must be [W, L], got {tuple(walks.shape)}.")
    if any(int(d) < 1 for d, _ in strides):
        raise ValueError(f"strides must be at least 1, got {strides}.")


def _split_keys(keys: torch.Tensor, sums: torch.Tensor, n_nodes: int):
    return ((keys // n_nodes).to(torch.int32), (keys % n_nodes).to(torch.int32),
            sums.to(torch.float32))


def cooccurrences_plain(
    walks: torch.Tensor, n_nodes: int, strides: Sequence[Tuple[int, float]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K13a: every key and weight, `torch.unique`,
    float64 sums by `index_add_`."""
    _check_inputs(walks, n_nodes, strides)
    keys, weights = [], []
    w = walks.long()
    for d, weight in strides:
        a, b = w[:, :-d].reshape(-1), w[:, d:].reshape(-1)
        keep = a != b
        a, b = a[keep], b[keep]
        keys += [a * n_nodes + b, b * n_nodes + a]
        weights += [torch.full((2 * a.shape[0],), float(weight), dtype=torch.float64,
                               device=walks.device)]
    keys = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.int64, device=walks.device)
    weights = (torch.cat(weights) if weights
               else torch.zeros(0, dtype=torch.float64, device=walks.device))
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.float64, device=walks.device)
    sums.index_add_(0, inverse, weights)
    return _split_keys(uniq, sums, n_nodes)


# A segment longer than this is a hub (`kBlockSeg` in csrc/glove.cu). A hub's
# entries are bucketed in chunks of _HUB_CHUNK (`kHubChunk`) by windows of
# at least 2^14 contexts, at most _MAX_HUB_WINDOWS (`kMaxHubWindows`) a hub.
_BLOCK_SEGMENT = 8192
_HUB_CHUNK = 4096
_MAX_HUB_WINDOWS = 1024


def _hub_windows(n_nodes: int) -> Tuple[int, int]:
    """(wshift, nw): a hub's windows of 2^wshift contexts, nw of them."""
    wshift = max(14, (n_nodes - 1).bit_length() - (_MAX_HUB_WINDOWS.bit_length() - 1))
    return wshift, -(-n_nodes >> wshift)
# K13a's scatter writes the entries of one range of centers a sweep, about
# this many bytes of them, so that the sectors it fills stay in the card's
# 50-MB L2 until whole.
SWEEP_BYTES = 24 << 20


def cooccurrences(
    walks: torch.Tensor, n_nodes: int, strides: Sequence[Tuple[int, float]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(centers int32, contexts int32, sums float32) of the distinct keys
    a * N + b of `walks` [W, L] (int32), in ascending key order: each pair
    (walk[t], walk[t + d]) adds `weight` to both of its keys for every
    (d, weight) of `strides`; the sums are taken in float64, the diagonal
    is dropped. K13a on CUDA tensors (its six launches, count, scan,
    scatter, sort, scan and write, each counted under "cooccurrences"; the
    output's size is read on the host once, before the write), the plain
    version on CPU tensors."""
    strides = tuple((int(d), float(weight)) for d, weight in strides)
    if not _build.is_cuda(walks):
        return cooccurrences_plain(walks, n_nodes, strides)
    _check_inputs(walks, n_nodes, strides)
    dev = walks.device
    n_walks, length = walks.shape
    _build.check(walks, "walks", torch.int32, (n_walks, length), dev)
    # Both orientations of every (walk, position, stride) pair, the diagonal
    # included: at least the entries the build takes.
    bound = 2 * n_walks * sum(max(length - d, 0) for d, _ in strides)
    if bound == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return _split_keys(empty, empty.double(), n_nodes)
    n_strides = len(strides)
    shift = (n_strides - 1).bit_length()
    if n_nodes << shift > 2**32 or bound >= 2**32:
        raise ValueError(f"K13a keeps an entry as context << {shift} | stride in 32 bits and "
                         f"counts under 2^32 entries; got {n_nodes} nodes, {n_strides} "
                         f"strides, {bound} entries.")
    i32, i64 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.int64, device=dev)
    d_t = torch.tensor([d for d, _ in strides], **i32)
    w_t = torch.tensor([w for _, w in strides], dtype=torch.float64, device=dev)
    cnt = torch.zeros((n_nodes,), **i32)
    off = torch.empty((n_nodes + 1,), **i64)
    part = torch.empty((max(1, -(-n_nodes // 2048)),), **i64)

    def launch(fn_name, *args):
        _build.launch("cooccurrences", fn_name, dev, *args)

    launch("ebt_cooc_count", walks.data_ptr(), n_walks, length, d_t.data_ptr(), n_strides,
           cnt.data_ptr())
    launch("ebt_cooc_scan", cnt.data_ptr(), n_nodes, part.data_ptr(), off.data_ptr())
    ent = torch.empty((bound,), **i32)
    rec_sum = torch.empty((bound,), dtype=torch.float32, device=dev)
    sweep = torch.empty((n_walks * length,), dtype=torch.uint8, device=dev)
    launch("ebt_cooc_scatter", walks.data_ptr(), n_walks, length, d_t.data_ptr(), n_strides,
           shift, off.data_ptr(), cnt.data_ptr(), ent.data_ptr(), bound, SWEEP_BYTES,
           sweep.data_ptr())
    del sweep
    dcnt = torch.empty((n_nodes,), **i32)
    max_hubs = min(n_nodes, bound // (_BLOCK_SEGMENT + 1) + 1)
    wshift, nw = _hub_windows(n_nodes)
    hubs = torch.empty((max_hubs,), **i32)
    hub_counts = torch.zeros((2,), **i32)
    chunks = torch.empty((bound // _HUB_CHUNK + max_hubs, 2), **i32)
    # Each hub's windows' entries and distinct contexts, and their prefixes.
    wcnt, wdist = torch.zeros((2, max_hubs * nw), **i32)
    wofs, wdofs = torch.empty((2, max_hubs * (nw + 1)), **i32)
    launch("ebt_cooc_sort", ent.data_ptr(), rec_sum.data_ptr(), off.data_ptr(), n_nodes,
           shift, w_t.data_ptr(), dcnt.data_ptr(), hubs.data_ptr(), hub_counts.data_ptr(),
           chunks.data_ptr(), wshift, nw, wcnt.data_ptr(), wofs.data_ptr(), wdist.data_ptr(),
           wdofs.data_ptr())
    out_off = torch.empty((n_nodes + 1,), **i64)
    launch("ebt_cooc_scan", dcnt.data_ptr(), n_nodes, part.data_ptr(), out_off.data_ptr())
    total = int(out_off[n_nodes])
    ci, cj = torch.empty((total,), **i32), torch.empty((total,), **i32)
    sums = torch.empty((total,), dtype=torch.float32, device=dev)
    launch("ebt_cooc_write", ent.data_ptr(), rec_sum.data_ptr(), off.data_ptr(),
           dcnt.data_ptr(), out_off.data_ptr(), n_nodes, shift, w_t.data_ptr(),
           hubs.data_ptr(), hub_counts.data_ptr(), wshift, nw, wofs.data_ptr(),
           wdofs.data_ptr(), ci.data_ptr(), cj.data_ptr(), sums.data_ptr())
    return ci, cj, sums


def glove_entries(
    centers: torch.Tensor, contexts: torch.Tensor, counts: torch.Tensor,
    x_max: float, alpha: float,
) -> Entries:
    """The entries with log X and the weight f(X) = min(1, (X / x_max)^alpha),
    in float32 on the counts' device, as `glove.py:168-180` computes them."""
    return Entries(centers, contexts,
                   torch.clamp((counts / x_max) ** alpha, max=1.0),
                   torch.log(torch.clamp(counts, min=1e-9)))


def draw_entries(entries: Entries, batch_size: int, generator: torch.Generator,
                 workspace=None) -> torch.Tensor:
    """[batch_size] int32 entry ids uniform over [0, len(entries)) on the
    entries' device: K2's uniform mode on the card (Philox seeded from
    `generator`, counted under "nce_negatives"), `torch.randint` from
    `generator` on the CPU. With a fit's `workspace` (`ops.negatives.
    BatchDraws` over a [batch_size] block) the card draws at its key and
    next offset into its block, overwritten by the next batch."""
    n_entries = entries.n_entries
    if not _build.is_cuda(entries.ci):
        return torch.randint(0, n_entries, (batch_size,), generator=generator,
                             dtype=torch.int32)
    if not 0 < n_entries < 2**32:
        raise ValueError(f"K2 draws ids in [0, 2^32); got {n_entries} entries.")
    dev = entries.ci.device
    if workspace is None:
        out = torch.empty((batch_size,), dtype=torch.int32, device=dev)
        seed, offset = _build.draw_seed(generator)
    else:
        out = workspace.block
        _build.check(out, "workspace.block", torch.int32, (batch_size,), dev)
        seed, offset = workspace.seed(generator)
    _build.launch("nce_negatives", "ebt_node_draws", dev, None, 0, n_entries,
                  out.data_ptr(), batch_size, seed, offset)
    return out


# Entries a block of K13b's gradient launch (`kThreads` in csrc/glove.cu).
_STEP_BLOCK = 256


@dataclasses.dataclass
class GloVeStepWorkspace:
    """What K13b's three launches hand each other, allocated once a fit: the
    context side's scaled rows g w_i [B, D], each entry's i, j (int32) and g,
    the gradient launch's loss partials (one a block of 256 entries) and the
    loss sum (0-d), all float32 but i and j."""

    rows: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    g: torch.Tensor
    partials: torch.Tensor
    loss: torch.Tensor

    @classmethod
    def empty(cls, batch_size: int, d: int, device) -> "GloVeStepWorkspace":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(torch.empty((batch_size, d), **f32),
                   *torch.empty((2, batch_size), dtype=torch.int32, device=device),
                   torch.empty((batch_size,), **f32),
                   torch.empty((-(-batch_size // _STEP_BLOCK),), **f32),
                   torch.empty((), **f32))


def glove_gradients_plain(
    entries: Entries, ids: torch.Tensor, node_embedding: torch.Tensor,
    context_embedding: torch.Tensor, center_bias: torch.Tensor,
    context_bias: torch.Tensor, inv_batch: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K13b's gradient launch: (i, j, g, the rows g w_i,
    the loss sum), g scaled by `inv_batch` (1 / B by default)."""
    ids = ids.long()
    i, j = entries.ci[ids], entries.cj[ids]
    f_x, log_x = entries.f_x[ids], entries.log_x[ids]
    w, c = node_embedding[i], context_embedding[j]
    diff = (w * c).sum(1) + center_bias[i] + context_bias[j] - log_x
    g = (2.0 * f_x * diff / ids.shape[0] if inv_batch is None
         else 2.0 * f_x * diff * inv_batch)
    return i, j, g, g[:, None] * w, (f_x * diff * diff).sum()


def glove_node_update_plain(
    node_embedding: torch.Tensor, context_embedding: torch.Tensor,
    center_bias: torch.Tensor, context_bias: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
    g: torch.Tensor, lr: float,
) -> None:
    """Plain version of K13b's node-side update (before the context side
    changes)."""
    node_embedding.index_add_(0, i, g[:, None] * context_embedding[j], alpha=-lr)
    center_bias.index_add_(0, i, g, alpha=-lr)
    context_bias.index_add_(0, j, g, alpha=-lr)


def glove_context_update_plain(context_embedding: torch.Tensor, rows: torch.Tensor,
                               j: torch.Tensor, lr: float) -> None:
    """Plain version of K13b's context-side update: the rows g w_i."""
    context_embedding.index_add_(0, j, rows, alpha=-lr)


def glove_step_plain(
    entries: Entries, ids: torch.Tensor, node_embedding: torch.Tensor,
    context_embedding: torch.Tensor, center_bias: torch.Tensor,
    context_bias: torch.Tensor, lr: float,
) -> torch.Tensor:
    """Plain version of K13b: its three launches' plain versions in order."""
    i, j, g, rows, loss = glove_gradients_plain(entries, ids, node_embedding,
                                                context_embedding, center_bias, context_bias)
    glove_node_update_plain(node_embedding, context_embedding, center_bias, context_bias, i, j,
                            g, lr)
    glove_context_update_plain(context_embedding, rows, j, lr)
    return loss


def _check_tables(node_embedding, context_embedding, center_bias, context_bias, dev):
    n, d = node_embedding.shape
    for t, name, shape in ((node_embedding, "node_embedding", (n, d)),
                           (context_embedding, "context_embedding", (n, d)),
                           (center_bias, "center_bias", (n,)),
                           (context_bias, "context_bias", (n,))):
        _build.check(t, name, torch.float32, shape, dev)
    return n, d


def _check_workspace(ws: GloVeStepWorkspace, b: int, d: int, dev, n_partials=None) -> None:
    for t, name, dtype, shape in (
            (ws.rows, "rows", torch.float32, (b, d)), (ws.i, "i", torch.int32, (b,)),
            (ws.j, "j", torch.int32, (b,)), (ws.g, "g", torch.float32, (b,)),
            (ws.partials, "partials", torch.float32,
             (-(-b // _STEP_BLOCK),) if n_partials is None else (n_partials,)),
            (ws.loss, "loss", torch.float32, ())):
        _build.check(t, f"workspace.{name}", dtype, shape, dev)


def glove_gradients(
    entries: Entries, ids: torch.Tensor, node_embedding: torch.Tensor,
    context_embedding: torch.Tensor, center_bias: torch.Tensor,
    context_bias: torch.Tensor, workspace: GloVeStepWorkspace, inv_batch: float,
) -> GloVeStepWorkspace:
    """The first half of `glove_step` for the B entries `ids`: each entry's
    i, j, g = 2 f (pred - log X) * inv_batch and the rows g w_i into
    `workspace` (B rows), with the loss partials (one a block of 256
    entries; on the CPU the loss sum first, then zeros). Nothing changes in
    the tables. What ranks exchange in data-parallel GloVe. K13b's gradient
    launch on CUDA tensors, the plain version on CPU tensors."""
    ws = workspace
    if not _build.is_cuda(ids):
        i, j, g, rows, loss = glove_gradients_plain(
            entries, ids, node_embedding, context_embedding, center_bias, context_bias,
            inv_batch)
        ws.i.copy_(i)
        ws.j.copy_(j)
        ws.g.copy_(g)
        ws.rows.copy_(rows)
        ws.partials.zero_()[0] = loss
        return ws
    dev = ids.device
    b, e = ids.shape[0], entries.n_entries
    for t, name, dtype in ((entries.ci, "ci", torch.int32), (entries.cj, "cj", torch.int32),
                           (entries.f_x, "f_x", torch.float32),
                           (entries.log_x, "log_x", torch.float32)):
        _build.check(t, name, dtype, (e,), dev)
    _build.check(ids, "ids", torch.int32, (b,), dev)
    _, d = _check_tables(node_embedding, context_embedding, center_bias, context_bias, dev)
    _check_workspace(ws, b, d, dev)
    if b:
        _build.launch("glove_gradients", "ebt_glove_gradients", dev,
                      *(t.data_ptr() for t in entries), ids.data_ptr(),
                      node_embedding.data_ptr(), context_embedding.data_ptr(),
                      center_bias.data_ptr(), context_bias.data_ptr(), ws.i.data_ptr(),
                      ws.j.data_ptr(), ws.g.data_ptr(), ws.rows.data_ptr(),
                      ws.partials.data_ptr(), b, d, float(inv_batch))
    return ws


def glove_apply(
    node_embedding: torch.Tensor, context_embedding: torch.Tensor,
    center_bias: torch.Tensor, context_bias: torch.Tensor,
    workspace: GloVeStepWorkspace, lr: float,
) -> torch.Tensor:
    """The second half of `glove_step`, in place: node_embedding[i] -= lr g
    c_j and both biases -= lr g (every c_j before the context side
    changes), then context_embedding[j] -= lr g w_i from the workspace's
    rows, summed over repeated rows; the loss (the sum of the partials,
    which may be any number) into `workspace.loss`, which is returned. K13b's node-side
    and context-side launches on CUDA tensors, the plain versions on CPU
    tensors."""
    ws = workspace
    if not _build.is_cuda(ws.i):
        glove_node_update_plain(node_embedding, context_embedding, center_bias, context_bias,
                                ws.i.long(), ws.j.long(), ws.g, lr)
        glove_context_update_plain(context_embedding, ws.rows, ws.j.long(), lr)
        return ws.loss.copy_(ws.partials.sum())
    dev = ws.i.device
    b = ws.i.shape[0]
    _, d = _check_tables(node_embedding, context_embedding, center_bias, context_bias, dev)
    _check_workspace(ws, b, d, dev, n_partials=ws.partials.shape[0])
    if b == 0:
        return ws.loss.zero_()
    _build.launch("glove_node_update", "ebt_glove_node_update", dev,
                  node_embedding.data_ptr(), context_embedding.data_ptr(),
                  center_bias.data_ptr(), context_bias.data_ptr(), ws.i.data_ptr(),
                  ws.j.data_ptr(), ws.g.data_ptr(), ws.partials.data_ptr(),
                  ws.partials.shape[0], ws.loss.data_ptr(), b, d, float(lr))
    _build.launch("glove_context_update", "ebt_glove_context_update", dev,
                  context_embedding.data_ptr(), ws.rows.data_ptr(), ws.j.data_ptr(), b, d,
                  float(lr))
    return ws.loss


def glove_step(
    entries: Entries, ids: torch.Tensor, node_embedding: torch.Tensor,
    context_embedding: torch.Tensor, center_bias: torch.Tensor,
    context_bias: torch.Tensor, lr: float,
    workspace: Optional[GloVeStepWorkspace] = None,
) -> torch.Tensor:
    """One GloVe step for the B entries `ids` (int32) of `entries`, in
    place: with g = 2 f (pred - log X) / B, the gradient of the batch mean
    of f (pred - log X)^2 with respect to pred, node_embedding[i] -= lr g
    c_j, context_embedding[j] -= lr g w_i and both biases -= lr g, summed
    over repeated rows, every gradient from the tables before the step.
    Returns the loss sum as a 0-d tensor: `workspace.loss`, overwritten by
    the next step on the workspace, where one is given. The tables may be
    views (Walklets' slices of [P, N, D] tables) but must be contiguous.

    K13b on CUDA tensors: `glove_gradients`, then `glove_apply` (the
    gradient launch, the node-side update and the context-side update,
    counted under "glove_gradients", "glove_node_update" and
    "glove_context_update"), on `workspace` (B rows), else on fresh
    buffers. The plain version on CPU tensors, which takes no workspace."""
    if not _build.is_cuda(ids):
        return glove_step_plain(entries, ids, node_embedding, context_embedding,
                                center_bias, context_bias, lr)
    b = ids.shape[0]
    ws = (GloVeStepWorkspace.empty(b, node_embedding.shape[1], ids.device)
          if workspace is None else workspace)
    glove_gradients(entries, ids, node_embedding, context_embedding, center_bias,
                    context_bias, ws, 1.0 / max(b, 1))
    return glove_apply(node_embedding, context_embedding, center_bias, context_bias, ws, lr)
