"""First-order random walks and CSR membership — counterpart of
`embiggen_tpu/ops/walks.py` (`random_walks`, first-order branch, and
`_sample_neighbor`; `csr_has_edges` and `csr_edge_ids`).

A step draws a uniform neighbour from the CSR row, or a Walker alias draw
when the graph is weighted; a node of degree zero keeps the walker where it
is. On a CUDA graph all steps of all walkers run in one launch of kernel K1
(`csrc/sampling.cu`); on a CPU graph the plain version below loops over the
steps. The two draw different random numbers, so they agree in
distribution, not bit for bit. Arc membership is a lower-bound search in the
sorted CSR row: kernel K5 (`csrc/edges.cu`) on CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..graph.graph import TorchGraph
from . import _build


def _uniform_offset(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """floor(u * deg) clamped to [0, deg) per element (0 where deg == 0)."""
    return torch.minimum((u * deg).long(), (deg.long() - 1).clamp(min=0))


def _sample_neighbor(
    tg: TorchGraph, nodes: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """One first-order neighbour draw per node (plain version of one K1
    step): uniform over the row, or alias-weighted on weighted graphs."""
    nodes = nodes.long()
    deg = tg.degrees[nodes]
    base = tg.row_ptr[nodes].long()
    off = _uniform_offset(
        torch.rand(nodes.shape, generator=generator, device=nodes.device), deg
    )
    if tg.alias_prob is not None:
        coin = torch.rand(nodes.shape, generator=generator, device=nodes.device)
        arc = (base + off).clamp(0, max(tg.n_arcs - 1, 0))
        off = torch.where(coin < tg.alias_prob[arc], off, tg.alias_idx[arc].long())
    nxt = tg.col_idx[(base + off).clamp(0, max(tg.n_arcs - 1, 0))].long()
    return torch.where(deg > 0, nxt, nodes)


def first_order_walks_plain(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Plain PyTorch version of K1: a Python loop over the steps."""
    cols = [starts.long()]
    for _ in range(walk_length - 1):
        cols.append(_sample_neighbor(tg, cols[-1], generator))
    return torch.stack(cols, dim=1).to(torch.int32)


def first_order_walks(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """[B, walk_length] int32 first-order walks from `starts` [B] int32.
    Kernel K1 on a CUDA graph (Philox seeded from `generator`), the plain
    version on a CPU graph."""
    if walk_length < 1:
        raise ValueError(f"walk_length must be positive, got {walk_length}.")
    if not _build.is_cuda(tg.col_idx):
        return first_order_walks_plain(tg, starts, walk_length, generator)
    dev = tg.device
    _build.check(starts, "starts", torch.int32, (starts.shape[0],), dev)
    walks = torch.empty((starts.shape[0], walk_length), dtype=torch.int32,
                        device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "first_order_walks", "ebt_first_order_walks", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(),
        _build.ptr(tg.alias_prob), _build.ptr(tg.alias_idx),
        starts.data_ptr(), walks.data_ptr(), starts.shape[0], walk_length,
        seed, offset,
    )
    return walks


def random_walks(
    tg: TorchGraph,
    start_nodes: torch.Tensor,
    walk_length: int,
    generator: torch.Generator,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
) -> torch.Tensor:
    """[B, walk_length] walks starting at `start_nodes`. Only first-order
    walks (return_weight == explore_weight == 1) are ported."""
    if return_weight != 1.0 or explore_weight != 1.0:
        raise NotImplementedError(
            "Biased (p/q) walks are not ported yet (ROADMAP A6).")
    return first_order_walks(tg, start_nodes, walk_length, generator)


def csr_edge_ids_plain(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: a masked lower-bound search over all
    queries at once, until every search has ended."""
    n_arcs = col_idx.shape[0]
    if n_arcs == 0:
        return (torch.zeros_like(src, dtype=torch.int32),
                torch.zeros_like(src, dtype=torch.bool))
    src, dst = src.long(), dst.long()
    lo, hi = row_ptr[src].long(), row_ptr[src + 1].long()
    end = hi
    while True:
        valid = lo < hi
        if not bool(valid.any()):
            break
        mid = (lo + hi) // 2
        go_right = valid & (col_idx[mid.clamp(0, n_arcs - 1)].long() < dst)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(valid & ~go_right, mid, hi)
    found = (lo < end) & (col_idx[lo.clamp(0, n_arcs - 1)].long() == dst)
    return torch.where(found, lo, n_arcs).to(torch.int32), found


def csr_edge_ids(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, with_ids: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(arc id, found) of each (src[i], dst[i]) pair in a CSR with sorted
    rows: the arc's CSR position, or the sentinel n_arcs where the pair is
    not an arc. Kernel K5 on CUDA tensors (ids are None when not
    `with_ids`), the plain version on CPU tensors."""
    if not _build.is_cuda(col_idx):
        return csr_edge_ids_plain(row_ptr, col_idx, src, dst)
    dev = col_idx.device
    n = src.shape[0]
    _build.check(row_ptr, "row_ptr", torch.int32, None, dev)
    _build.check(col_idx, "col_idx", torch.int32, None, dev)
    _build.check(src, "src", torch.int32, (n,), dev)
    _build.check(dst, "dst", torch.int32, (n,), dev)
    ids = torch.empty((n,), dtype=torch.int32, device=dev) if with_ids else None
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    _build.launch(
        "csr_edge_ids", "ebt_csr_edge_ids", dev, row_ptr.data_ptr(),
        col_idx.data_ptr(), src.data_ptr(), dst.data_ptr(), n,
        col_idx.shape[0], _build.ptr(ids), found.data_ptr(),
    )
    return ids, found


def csr_has_edges(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """[B] bool: is (src[i], dst[i]) an arc? K5 without the ids."""
    return csr_edge_ids(row_ptr, col_idx, src, dst, with_ids=False)[1]
