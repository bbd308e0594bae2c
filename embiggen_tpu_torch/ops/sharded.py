"""Owned-row gather and scatter of a row-sharded table — the per-rank
bodies of `embiggen_tpu/parallel/sharded_table.py::_gather_rows` (K17d),
`_scatter_add_owned` and `_mean_scatter_owned` (K17c), without their
collectives (`parallel.sharded_table` adds those).

A rank holds rows [lo, lo + S) of a table [N, D] or [N] as its shard
[S, ...]; ids are global int32. `owned_gather` reads the owned ids' rows and
zeros for the rest; `owned_scatter` adds scale * grads / den into the owned
rows, with den a per-row count from `owned_count`, a per-entry count (the
compact tables of the distributed steps, one entry a row) or 1. With lo 0
and S = N every id is owned: the data-parallel steps gather and apply a
replicated table's compact rows so.

On CUDA tensors these are kernels K17d and K17c (`csrc/sharded.cu`,
counted under "owned_gather", "owned_count" and "owned_scatter"); on CPU
tensors the plain versions below.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


def _owned(idx: torch.Tensor, lo: int, shard_rows: int):
    local = idx.long() - lo
    return local, (local >= 0) & (local < shard_rows)


def _row_shape(shard: torch.Tensor):
    if shard.ndim not in (1, 2):
        raise ValueError(f"a shard is [S] or [S, D], got {tuple(shard.shape)}.")
    return 1 if shard.ndim == 1 else shard.shape[1]


def owned_gather_plain(shard: torch.Tensor, lo: int, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K17d."""
    local, ok = _owned(idx, lo, shard.shape[0])
    rows = shard[local.clamp(0, max(shard.shape[0] - 1, 0))]
    mask = ok[:, None] if shard.ndim > 1 else ok
    return torch.where(mask, rows, torch.zeros((), dtype=shard.dtype, device=shard.device))


def owned_gather(shard: torch.Tensor, lo: int, idx: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[M, ...] rows of the global ids `idx` [M] that this shard owns
    (rows [lo, lo + S)), zeros for the others; into `out` when given. K17d
    on CUDA tensors, the plain version on CPU tensors."""
    if not _build.is_cuda(shard):
        rows = owned_gather_plain(shard, lo, idx)
        return rows if out is None else out.copy_(rows)
    dev = shard.device
    d = _row_shape(shard)
    shape = (idx.shape[0],) + tuple(shard.shape[1:])
    _build.check(shard, "shard", torch.float32, None, dev)
    _build.check(idx, "idx", torch.int32, (idx.shape[0],), dev)
    _build.check(out, "out", torch.float32, shape, dev)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    _build.launch("owned_gather", "ebt_owned_gather", dev, shard.data_ptr(),
                  shard.shape[0], int(lo), idx.data_ptr(), idx.shape[0], d, out.data_ptr())
    return out


def owned_count_plain(counts: torch.Tensor, lo: int, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K17c's count launch."""
    local, ok = _owned(idx, lo, counts.shape[0])
    counts.index_add_(0, local[ok], torch.ones_like(local[ok], dtype=counts.dtype))
    return counts


def owned_count(counts: torch.Tensor, lo: int, idx: torch.Tensor) -> torch.Tensor:
    """Add 1 into counts [S] at each owned id of `idx`; returns counts.
    K17c's count launch on CUDA tensors, the plain version on CPU tensors."""
    if not _build.is_cuda(counts):
        return owned_count_plain(counts, lo, idx)
    dev = counts.device
    _build.check(counts, "counts", torch.float32, (counts.shape[0],), dev)
    _build.check(idx, "idx", torch.int32, (idx.shape[0],), dev)
    _build.launch("owned_count", "ebt_owned_count", dev, counts.data_ptr(), counts.shape[0],
                  int(lo), idx.data_ptr(), idx.shape[0])
    return counts


def owned_scatter_plain(shard: torch.Tensor, lo: int, idx: torch.Tensor,
                        grads: torch.Tensor, scale: float,
                        row_den: Optional[torch.Tensor] = None,
                        entry_den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K17c's scatter."""
    local, ok = _owned(idx, lo, shard.shape[0])
    if row_den is not None:
        den = row_den[local.clamp(0, max(shard.shape[0] - 1, 0))]
    elif entry_den is not None:
        ok = ok & (entry_den != 0)
        den = entry_den
    else:
        den = torch.ones((), dtype=grads.dtype, device=grads.device)
    den = den.clamp(min=1.0)
    upd = scale * (grads / (den[:, None] if grads.ndim > 1 and den.ndim else den))
    shard.index_add_(0, local[ok], upd[ok])
    return shard


def owned_scatter(shard: torch.Tensor, lo: int, idx: torch.Tensor, grads: torch.Tensor,
                  scale: float, row_den: Optional[torch.Tensor] = None,
                  entry_den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """shard[idx - lo] += scale * grads / max(den, 1) on the owned ids, in
    place; den is row_den[idx - lo] ([S], e.g. from `owned_count`), else
    entry_den [M] (an entry of count 0 is skipped), else 1. Returns the
    shard. K17c on CUDA tensors, the plain version on CPU tensors."""
    if row_den is not None and entry_den is not None:
        raise ValueError("give row_den or entry_den, not both.")
    if not _build.is_cuda(shard):
        return owned_scatter_plain(shard, lo, idx, grads, scale, row_den, entry_den)
    dev = shard.device
    d = _row_shape(shard)
    m = idx.shape[0]
    _build.check(shard, "shard", torch.float32, None, dev)
    _build.check(idx, "idx", torch.int32, (m,), dev)
    _build.check(grads, "grads", torch.float32, (m,) + tuple(shard.shape[1:]), dev)
    _build.check(row_den, "row_den", torch.float32, (shard.shape[0],), dev)
    _build.check(entry_den, "entry_den", torch.float32, (m,), dev)
    _build.launch("owned_scatter", "ebt_owned_scatter", dev, shard.data_ptr(), shard.shape[0],
                  int(lo), idx.data_ptr(), grads.data_ptr(), m, d, _build.ptr(row_den),
                  _build.ptr(entry_den), float(scale))
    return shard
