"""Multi-source distances and window counts over anchor sets — counterpart
of `embiggen_tpu/ops/bfs.py`, the device half of SPINE and WINE.

`multi_source_distances` runs min-plus relaxations of an [N, D] distance
matrix, column j holding the distance from anchor set j, until one moves
nothing or `max_depth` have run: kernel K15a (`csrc/bfs.cu`) once per
relaxation on CUDA tensors, its plain version (a gather and an
`index_reduce_` "amin" over the arcs) on CPU tensors, each setting a change
flag that the loop reads. Each candidate is one float add and a minimum does
not depend on its order, so both give the reference's `max_depth`
relaxations exactly.

`window_cooccurrence_counts` is `window_size` hops of the adjacency at
unit values, summed: the reference's `segment_sum(x[cols], rows)` is the
SpMM K7 (`ops.spmm.csr_spmm`) over the graph's arcs with weights 1, so it
needs no kernel of its own. The counts are integers in float32, exact in
any order below 2^24.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..graph.graph import TorchGraph
from . import _build
from .spmm import CSRKernel, csr_spmm

UNREACHED = 1e9

# Arcs per chunk of the plain version's [chunk, D] gather (about 1 GB).
_CHUNK_ELEMENTS = 1 << 28


def anchor_init_from_sets(
    n_nodes: int, anchor_sets: Sequence, device: Union[str, torch.device] = "cpu",
) -> torch.Tensor:
    """[N, D] float32 on `device`: 0.0 at the members of anchor set j in
    column j, UNREACHED elsewhere."""
    init = torch.full((n_nodes, len(anchor_sets)), UNREACHED, dtype=torch.float32,
                      device=device)
    for j, nodes in enumerate(anchor_sets):
        init[torch.as_tensor(np.asarray(nodes, dtype=np.int64), device=device), j] = 0.0
    return init


def arc_rows(tg: TorchGraph) -> torch.Tensor:
    """[E] int32 source row of each arc of `tg`."""
    if tg.sources is not None:
        return tg.sources
    return torch.repeat_interleave(
        torch.arange(tg.n_nodes, dtype=torch.int32, device=tg.device),
        tg.degrees.long(), output_size=tg.n_arcs)


def _arc_weights(tg: TorchGraph, weighted: bool) -> Optional[torch.Tensor]:
    if not weighted:
        return None
    if tg.weights is None:
        raise ValueError("Weighted distances require edge weights.")
    return tg.weights


def min_plus_step_plain(
    tg: TorchGraph, dist: torch.Tensor, weighted: bool = False,
    changed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K15a: min(dist[r], dist[c] + w) over the
    arcs (r, c), as a chunked gather and `index_reduce_` "amin"."""
    w = _arc_weights(tg, weighted)
    rows = arc_rows(tg).long()
    out = dist.clone()
    chunk = max(1, _CHUNK_ELEMENTS // max(dist.shape[1], 1))
    for i in range(0, tg.n_arcs, chunk):
        cand = dist[tg.col_idx[i:i + chunk].long()]
        cand = cand + (1.0 if w is None else w[i:i + chunk, None])
        out.index_reduce_(0, rows[i:i + chunk], cand, "amin", include_self=True)
    if changed is not None:
        changed.copy_(torch.maximum(changed, (out != dist).any().to(changed.dtype)))
    return out


def min_plus_step(
    tg: TorchGraph, dist: torch.Tensor, weighted: bool = False,
    changed: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[N, D] float32: one min-plus relaxation of `dist` along the arcs of
    `tg` (w = 1, or the arc weights when `weighted`). `changed`, a
    one-element int32 tensor, is set to 1 when a distance moved. Kernel K15a
    on CUDA tensors (into `out` when given), the plain version on CPU
    tensors."""
    if not _build.is_cuda(dist):
        return min_plus_step_plain(tg, dist, weighted, changed)
    dev = dist.device
    w = _arc_weights(tg, weighted)
    n, d = dist.shape
    if n != tg.n_nodes:
        raise ValueError(f"dist has {n} rows for {tg.n_nodes} nodes.")
    _build.check(dist, "dist", torch.float32, None, dev)
    _build.check(tg.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    _build.check(tg.col_idx, "col_idx", torch.int32, None, dev)
    _build.check(w, "weights", torch.float32, (tg.n_arcs,), dev)
    _build.check(changed, "changed", torch.int32, (1,), dev)
    if out is None:
        out = torch.empty_like(dist)
    _build.check(out, "out", torch.float32, (n, d), dev)
    vec4 = d % 4 == 0 and dist.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _build.launch(
        "min_plus_step", "ebt_min_plus_step", dev, tg.row_ptr.data_ptr(),
        tg.col_idx.data_ptr(), _build.ptr(w), dist.data_ptr(), out.data_ptr(),
        _build.ptr(changed), n, d, int(vec4),
    )
    return out


def multi_source_distances(
    tg: TorchGraph, anchor_init: torch.Tensor, max_depth: int = 32,
    weighted: bool = False, changes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[N, D] distances from each anchor set after `max_depth` relaxations
    (UNREACHED where none reached). The loop stops after the first
    relaxation that moves no distance: one that changes nothing changes
    nothing after it, so the result equals `max_depth` relaxations bit for
    bit. Each relaxation sets its own flag, read on the host (4 bytes)
    before the next is launched. `changes`, an int32 [max_depth] tensor of
    zeros, receives those flags, so it records which relaxations moved a
    distance (the entries after the stop stay 0); without it the flags go
    to a scratch tensor."""
    dist = anchor_init.contiguous()
    if changes is None:
        changes = torch.zeros(max_depth, dtype=torch.int32, device=dist.device)
    # On the card, two buffers take turns as each launch's output.
    bufs = ((torch.empty_like(dist), torch.empty_like(dist))
            if _build.is_cuda(dist) and max_depth > 0 else (None, None))
    for i in range(max_depth):
        dist = min_plus_step(tg, dist, weighted, changes[i:i + 1], bufs[i % 2])
        if not int(changes[i]):
            break
    return dist


def unit_kernel(tg: TorchGraph) -> CSRKernel:
    """The arcs of `tg` at weight 1 as a CSRKernel on its device (no
    transpose): K7 over it is the reference's segment_sum(x[cols], rows)."""
    ones = torch.ones(tg.n_arcs, dtype=torch.float32, device=tg.device)
    deg = tg.degrees.to(torch.float32)
    return CSRKernel(row_ptr=tg.row_ptr, rows=arc_rows(tg), cols=tg.col_idx, vals=ones,
                     abs_weight_sum=deg, sq_weight_sum=deg, n_out=tg.n_nodes,
                     n_in=tg.n_nodes)


def window_cooccurrence_counts(
    tg: TorchGraph, anchor_membership: torch.Tensor, window_size: int = 2,
) -> torch.Tensor:
    """[N, D] number of (multi-)paths of length 1..window_size from each node
    into each anchor set: `window_size` K7 hops at unit values, summed."""
    k = unit_kernel(tg)
    total = torch.zeros_like(anchor_membership)
    reach = anchor_membership.contiguous()
    for _ in range(window_size):
        reach = csr_spmm(k, reach)
        total = total + reach
    return total
