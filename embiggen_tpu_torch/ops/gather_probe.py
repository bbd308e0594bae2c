"""Row-gather probes that bound the SpMM (K7) — counterpart of the two
Pallas kernels of `scripts/spmm_probe.py` (`dma_kernel` → `pallas_gather`,
`vmem_kernel` → `vmem_gather`).

Both sum whole tiles of gathered rows, `out[t] = Σ x[idx[t·T : (t+1)·T]]`,
dropping a ragged last tile as the Pallas kernels do: P1 over tiles of 256
rows from a large table in device memory, P2 over blocks of 8192 rows from
an [8192, D] table that stays in the card's L2 cache. On CUDA tensors they
are kernels P1 and P2 (`csrc/gather_probe.cu`); on CPU tensors the plain
version below.
"""
from __future__ import annotations

import torch

from . import _build

P1_TILE = 256
P2_BLOCK = 8192


def tile_gather_sums_plain(x: torch.Tensor, idx: torch.Tensor,
                           tile: int) -> torch.Tensor:
    """Plain PyTorch version of P1 and P2."""
    n_tiles = idx.shape[0] // tile
    rows = x[idx[:n_tiles * tile].long()]
    return rows.reshape(n_tiles, tile, x.shape[1]).sum(dim=1)


def _launch(counter, fn_name, x, idx, tile):
    dev = x.device
    n_tiles = idx.shape[0] // tile
    d = x.shape[1]
    _build.check(x, "x", torch.float32, None, dev)
    _build.check(idx, "idx", torch.int32, (idx.shape[0],), dev)
    if x.ndim != 2 or d % 4:
        raise ValueError(f"x must be [N, D] with D % 4 == 0, got {tuple(x.shape)}.")
    out = torch.empty((n_tiles, d), dtype=torch.float32, device=dev)
    _build.launch(counter, fn_name, dev, x.data_ptr(), idx.data_ptr(), n_tiles,
                  tile, d, out.data_ptr())
    return out


def tile_gather_sums(x: torch.Tensor, idx: torch.Tensor,
                     tile: int = P1_TILE) -> torch.Tensor:
    """P1: [len(idx) // tile, D] sums of each tile of gathered rows of `x`."""
    if not _build.is_cuda(x):
        return tile_gather_sums_plain(x, idx, tile)
    return _launch("tile_gather_sums", "ebt_tile_gather_sums", x, idx, tile)


def table_gather_sums(tbl: torch.Tensor, idx: torch.Tensor,
                      block: int = P2_BLOCK) -> torch.Tensor:
    """P2: [len(idx) // block, D] sums of each block of rows gathered from a
    small (cache-resident) table."""
    if not _build.is_cuda(tbl):
        return tile_gather_sums_plain(tbl, idx, block)
    return _launch("table_gather_sums", "ebt_table_gather_sums", tbl, idx, block)
