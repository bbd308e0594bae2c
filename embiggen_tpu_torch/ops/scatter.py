"""Per-row mean SGD update — counterpart of
`embiggen_tpu/models/embedders/walk_based.py::_mean_scatter`.

A row appearing k times in the index multiset takes the AVERAGE of its k
gradients, once, at full lr: table[r] -= lr * sums[r] / max(counts[r], 1).
`idx` and `grads` may be tuples of aligned segments (e.g. SkipGram's walk
rows and per-walk negatives) that share one count vector; a caller updating
several tables from the same multiset passes the counts back in.

Unlike the JAX version, the update is IN PLACE on `table`, which is also
returned. On CUDA tensors it is kernel K4 (`csrc/scatter.cu`); on CPU
tensors the plain version below.

SkipGram's step takes K4 in two halves: K3
(`skipgram.skipgram_nce_update`) adds the gradient rows into a
`SkipGramSums` that the fit allocates once, and `skipgram_mean_combine`
applies the three tables' mean steps in one pass and zeroes the sums and
counts again for the next step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from . import _build

Segments = Union[torch.Tensor, Sequence[torch.Tensor]]


def _segments(x: Segments) -> Tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@dataclasses.dataclass
class SkipGramSums:
    """Per-node sums and counts of one SkipGram step's gradient rows, zero
    between steps: sums_w [N, D] for node_embedding, sums_c [N, D] for
    context_embedding, sums_b [N] for context_bias; counts_w [N] counts
    walk positions, counts_c [N] walk positions and negatives (the context
    table's and the bias's shared multiset)."""

    sums_w: torch.Tensor
    sums_c: torch.Tensor
    sums_b: torch.Tensor
    counts_w: torch.Tensor
    counts_c: torch.Tensor

    @classmethod
    def zeros(cls, n: int, d: int, device) -> "SkipGramSums":
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
        return cls(z(n, d), z(n, d), z(n), z(n), z(n))

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def check(self, n: int, d: int, device: torch.device) -> None:
        for f, t in zip(dataclasses.fields(self), self.buffers()):
            _build.check(t, f.name, torch.float32,
                         (n, d) if f.name in ("sums_w", "sums_c") else (n,), device)


def _denom(counts: torch.Tensor, ndim: int) -> torch.Tensor:
    denom = counts.clamp(min=1.0)
    return denom[:, None] if ndim > 1 else denom


def mean_scatter_plain(
    table: torch.Tensor, idx: Segments, grads: Segments, lr: float,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4."""
    segs, gsegs = _segments(idx), _segments(grads)
    if counts is None:
        counts = torch.zeros(table.shape[0], dtype=table.dtype, device=table.device)
        for s in segs:
            counts.index_add_(0, s.long(), torch.ones_like(s, dtype=table.dtype))
    sums = torch.zeros_like(table)
    for s, g in zip(segs, gsegs):
        sums.index_add_(0, s.long(), g)
    table.sub_(lr * (sums / _denom(counts, table.ndim)))
    return table, counts


def mean_scatter(
    table: torch.Tensor, idx: Segments, grads: Segments, lr: float,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Update `table` [N] or [N, D] in place with the per-row mean of
    `grads` scattered at `idx` (int32); returns (table, counts). Kernel K4
    on CUDA tensors (one scatter launch per segment, counted under
    "mean_scatter", then the combine, counted under "mean_combine"), the
    plain version on CPU tensors."""
    if not _build.is_cuda(table):
        return mean_scatter_plain(table, idx, grads, lr, counts)
    dev = table.device
    n = table.shape[0]
    d = 1 if table.ndim == 1 else table.shape[1]
    _build.check(table, "table", torch.float32, None, dev)
    if table.ndim not in (1, 2):
        raise ValueError(f"table must be [N] or [N, D], got {tuple(table.shape)}.")
    segs, gsegs = _segments(idx), _segments(grads)
    if len(segs) != len(gsegs):
        raise ValueError("idx and grads must have the same number of segments.")
    for s, g in zip(segs, gsegs):
        _build.check(s, "idx", torch.int32, (s.shape[0],), dev)
        _build.check(g, "grads", torch.float32, (s.shape[0],) + tuple(table.shape[1:]), dev)
    fresh = counts is None
    if fresh:
        counts = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        _build.check(counts, "counts", torch.float32, (n,), dev)
    sums = torch.zeros_like(table)
    for s, g in zip(segs, gsegs):
        _build.launch(
            "mean_scatter", "ebt_scatter_add_rows", dev, sums.data_ptr(),
            counts.data_ptr() if fresh else None, s.data_ptr(), g.data_ptr(),
            s.shape[0], d,
        )
    _build.launch(
        "mean_combine", "ebt_mean_combine", dev, table.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), float(lr), n, d,
    )
    return table, counts


def skipgram_mean_combine_plain(
    node_embedding: torch.Tensor, context_embedding: torch.Tensor,
    context_bias: torch.Tensor, sums: SkipGramSums, lr: float,
) -> None:
    """Plain PyTorch version of K4's SkipGram combine: the combine step of
    `mean_scatter_plain` for each table, then the sums and counts zeroed."""
    for table, total, counts in (
        (node_embedding, sums.sums_w, sums.counts_w),
        (context_embedding, sums.sums_c, sums.counts_c),
        (context_bias, sums.sums_b, sums.counts_c),
    ):
        table.sub_(lr * (total / _denom(counts, table.ndim)))
    for t in sums.buffers():
        t.zero_()


def skipgram_mean_combine(
    node_embedding: torch.Tensor, context_embedding: torch.Tensor,
    context_bias: torch.Tensor, sums: SkipGramSums, lr: float,
) -> None:
    """Apply one step's per-row mean update to SkipGram's three tables, in
    place, from the sums and counts K3 added, and leave
    those zero. K4's combine on CUDA tensors, the plain version on CPU
    tensors."""
    if not _build.is_cuda(node_embedding):
        return skipgram_mean_combine_plain(
            node_embedding, context_embedding, context_bias, sums, lr)
    dev = node_embedding.device
    n, d = node_embedding.shape
    for t, name, shape in ((node_embedding, "node_embedding", (n, d)),
                           (context_embedding, "context_embedding", (n, d)),
                           (context_bias, "context_bias", (n,))):
        _build.check(t, name, torch.float32, shape, dev)
    sums.check(n, d, dev)
    _build.launch(
        "skipgram_mean_combine", "ebt_skipgram_combine", dev,
        node_embedding.data_ptr(), sums.sums_w.data_ptr(), sums.counts_w.data_ptr(),
        context_embedding.data_ptr(), sums.sums_c.data_ptr(), context_bias.data_ptr(),
        sums.sums_b.data_ptr(), sums.counts_c.data_ptr(), float(lr), n, d,
    )
