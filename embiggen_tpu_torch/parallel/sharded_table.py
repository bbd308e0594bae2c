"""Row-sharded embedding tables — counterpart of
`embiggen_tpu/parallel/sharded_table.py`: a table [N, ...] is padded to a
multiple of the mesh size and rank p holds rows [p S, (p + 1) S), so the
largest table grows with the number of devices.

Communication is bounded by the batch, never the table: a gather of global
rows is a masked local lookup (K17d) followed by one all-reduce of the
[B, ...] batch rows; a scatter needs no communication, because every rank
holds the same (replicated) updates and applies those of the rows it owns
(K17c).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..graph.graph import TorchGraph
from ..ops.sharded import owned_count, owned_gather, owned_scatter
from .mesh import Mesh, all_reduce

Segments = Union[torch.Tensor, Sequence[torch.Tensor]]


def padded_rows(n_rows: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= n_rows."""
    return ((n_rows + n_shards - 1) // n_shards) * n_shards


def shard_rows(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of `table` padded to a multiple of the mesh size
    (zero rows past the end), as a new tensor on the mesh's device."""
    s = padded_rows(table.shape[0], mesh.size) // mesh.size
    out = torch.zeros((s,) + tuple(table.shape[1:]), dtype=torch.float32, device=mesh.device)
    own = table[mesh.rank * s:(mesh.rank + 1) * s]
    out[:own.shape[0]] = own.to(mesh.device)
    return out


def shard_rows_skipgram_params(params: Dict[str, torch.Tensor], mesh: Mesh
                               ) -> Dict[str, torch.Tensor]:
    """This rank's row shards of SkipGram's three tables (the bias too: it
    is per-node state)."""
    return {name: shard_rows(params[name], mesh)
            for name in ("node_embedding", "context_embedding", "context_bias")}


def unshard_rows(shard: torch.Tensor, mesh: Mesh, n_rows: int) -> torch.Tensor:
    """The whole table from every rank's shard, the padding rows trimmed."""
    from .mesh import all_gather

    return all_gather(shard, mesh)[:n_rows]


def _gather_rows(shard: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of global ids `idx` [M] of a row-sharded table, on every
    rank: the owned rows (K17d), then one all-reduce of [M, ...]."""
    rows = owned_gather(shard, mesh.rank * shard.shape[0], idx.int().contiguous())
    return all_reduce(rows, mesh)


def _scatter_add_owned(shard: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """Add the (replicated) `updates` into the rows this rank owns, in
    place (K17c, no communication); returns the shard."""
    return owned_scatter(shard, mesh.rank * shard.shape[0], idx.int().contiguous(),
                         updates.contiguous(), 1.0)


def _segments(x: Segments) -> Tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _mean_scatter_owned(shard: torch.Tensor, idx: Segments, grads: Segments, lr: float,
                        mesh: Mesh, counts: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded per-row mean step: an owned row appearing k times in the
    (replicated, global) multiset takes the mean of its k gradients, once,
    at full lr; no communication. `idx` and `grads` may be tuples of
    aligned segments of one multiset. The counts ([S], over the owned rows)
    are taken once (K17c's count launch) unless given, and returned for a
    second table of the same multiset. Returns (shard, counts)."""
    segs, gsegs = _segments(idx), _segments(grads)
    lo = mesh.rank * shard.shape[0]
    segs = tuple(s.int().contiguous() for s in segs)
    if counts is None:
        counts = torch.zeros((shard.shape[0],), dtype=torch.float32, device=shard.device)
        for s in segs:
            owned_count(counts, lo, s)
    for s, g in zip(segs, gsegs):
        owned_scatter(shard, lo, s, g.contiguous(), -lr, row_den=counts)
    return shard, counts


class _RowShardView:
    """Read-only facade of a row-sharded table for the minibatch models'
    hooks, which gather with `index_select` and indexing: a gather of
    global ids is `_gather_rows`. `shape` is the padded global shape."""

    __slots__ = ("shard", "mesh")

    def __init__(self, shard: torch.Tensor, mesh: Mesh):
        self.shard = shard
        self.mesh = mesh

    def index_select(self, dim: int, idx: torch.Tensor) -> torch.Tensor:
        if dim != 0:
            raise ValueError("a row-sharded table gathers rows only.")
        return _gather_rows(self.shard, idx.reshape(-1), self.mesh)

    def __getitem__(self, idx):
        idx = torch.as_tensor(idx)
        rows = _gather_rows(self.shard, idx.reshape(-1), self.mesh)
        return rows.reshape(tuple(idx.shape) + tuple(self.shard.shape[1:]))

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.shard.shape[0] * self.mesh.size,) + tuple(self.shard.shape[1:]))

    @property
    def ndim(self) -> int:
        return self.shard.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.shard.dtype

    @property
    def device(self) -> torch.device:
        return self.shard.device


# ------------------------------------------------ the functional NCE steps
def draw_pair_batch(tg: TorchGraph, generator: torch.Generator, batch_size: int,
                    walk_length: int, window_size: int, iterations: int = 1,
                    return_weight: float = 1.0, explore_weight: float = 1.0,
                    number_of_negative_samples: int = 10):
    """(contexts [M, 2w], words [M], negatives [K]) of one step of the
    functional NCE steps: walks from uniform starts cut into window pairs,
    and K scale-free negatives shared by the batch. Every rank draws the
    same batch from the same generator state."""
    from ..ops.negatives import negative_nodes_for_nce, sample_nodes_uniform
    from ..ops.walks import node2vec_batch

    starts = sample_nodes_uniform(tg, generator, (batch_size,))
    contexts, words = node2vec_batch(
        tg, starts, walk_length, window_size, generator, iterations=iterations,
        return_weight=return_weight, explore_weight=explore_weight, max_neighbours=100)
    negs = negative_nodes_for_nce(tg, generator, number_of_negative_samples)
    return contexts, words, negs


def nce_pair_grads(w, c_pos, c_neg, b_pos, b_neg, n: int, psum: Optional[Callable] = None):
    """The reference's NCE loss over window pairs and its manual adjoints:
    (loss, g_w [M, D], g_cpos [M, 2w, D], g_cneg [K, D], g_bpos [M, 2w],
    g_bneg [K]). `psum` sums the partial dot products over a dim-sharded
    mesh."""
    pos = torch.einsum("nd,npd->np", w, c_pos)
    neg = w @ c_neg.T
    if psum is not None:
        pos, neg = psum(pos), psum(neg)
    pos_logits = pos + b_pos
    neg_logits = neg + b_neg[None, :]
    loss = (torch.nn.functional.softplus(-pos_logits).sum()
            + torch.nn.functional.softplus(neg_logits).sum()) / n
    d_pos = -torch.sigmoid(-pos_logits) / n
    d_neg = torch.sigmoid(neg_logits) / n
    g_w = torch.einsum("np,npd->nd", d_pos, c_pos) + d_neg @ c_neg
    g_cpos = d_pos[:, :, None] * w[:, None, :]
    g_cneg = d_neg.T @ w
    return loss, g_w, g_cpos, g_cneg, d_pos, d_neg.sum(0)


def skipgram_pair_step(params: Dict[str, torch.Tensor], contexts, words, negs,
                       lr: float) -> torch.Tensor:
    """The single-device step the three functional steps are held to: the
    NCE pair loss on whole tables, updates scatter-added in place (K17c
    with every row owned). Returns the loss."""
    emb, ctx, bias = (params[k] for k in ("node_embedding", "context_embedding",
                                          "context_bias"))
    loss, g_w, g_cpos, g_cneg, g_bpos, g_bneg = nce_pair_grads(
        emb[words.long()], ctx[contexts.long()], ctx[negs.long()], bias[contexts.long()],
        bias[negs.long()], words.shape[0])
    _apply_pair_updates(lambda t, i, u: owned_scatter(t, 0, i.int().contiguous(),
                                                      u.contiguous(), 1.0),
                        emb, ctx, bias, contexts, words, negs,
                        g_w, g_cpos, g_cneg, g_bpos, g_bneg, lr)
    return loss


def _apply_pair_updates(add, emb, ctx, bias, contexts, words, negs, g_w, g_cpos, g_cneg,
                        g_bpos, g_bneg, lr):
    d = g_w.shape[1]
    flat_ctx = contexts.reshape(-1)
    add(emb, words, -lr * g_w)
    add(ctx, flat_ctx, -lr * g_cpos.reshape(-1, d))
    add(ctx, negs, -lr * g_cneg)
    add(bias, flat_ctx, -lr * g_bpos.reshape(-1))
    add(bias, negs, -lr * g_bneg)


def make_row_sharded_skipgram_step(
    mesh: Mesh, tg: TorchGraph, batch_size: int, walk_length: int, window_size: int,
    iterations: int = 1, return_weight: float = 1.0, explore_weight: float = 1.0,
    number_of_negative_samples: int = 10,
):
    """step(params, generator, lr) -> loss, updating this rank's row shards
    (`shard_rows_skipgram_params`) in place; or step(params, generator, lr,
    batch=(contexts, words, negs)). Same objective as
    `make_sharded_skipgram_step` (the dim-sharded variant): row gathers by
    K17d and one all-reduce, owned updates by K17c."""

    def step(params, generator, lr, batch=None):
        contexts, words, negs = batch if batch is not None else draw_pair_batch(
            tg, generator, batch_size, walk_length, window_size, iterations,
            return_weight, explore_weight, number_of_negative_samples)
        emb, ctx, bias = (params[k] for k in ("node_embedding", "context_embedding",
                                              "context_bias"))
        flat_ctx = contexts.reshape(-1)
        d = emb.shape[1]
        w = _gather_rows(emb, words, mesh)
        c_pos = _gather_rows(ctx, flat_ctx, mesh).reshape(contexts.shape + (d,))
        c_neg = _gather_rows(ctx, negs, mesh)
        b_pos = _gather_rows(bias, flat_ctx, mesh).reshape(contexts.shape)
        b_neg = _gather_rows(bias, negs, mesh)
        loss, *grads = nce_pair_grads(w, c_pos, c_neg, b_pos, b_neg, words.shape[0])
        _apply_pair_updates(lambda t, i, u: _scatter_add_owned(t, i, u, mesh),
                            emb, ctx, bias, contexts, words, negs, *grads, lr)
        return loss

    return step
