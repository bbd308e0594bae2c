"""Per-pair topological edge heuristics — counterpart of
`embiggen_tpu/ops/edge_metrics.py`: Adamic-Adar, Jaccard, resource
allocation and preferential attachment of (src, dst) pairs.

The endpoint of lower degree is expanded: its first `cap` arcs (in row
order) are tested for membership in the other endpoint's sorted CSR row, so
pairs whose lower degree exceeds `cap` are truncated, as in the reference.
On a CUDA graph this is kernel K8 (`csrc/edge_metrics.cu`): a group of 8
lanes a pair holds the other row in its registers when it has at most
`HELD` ids, and searches longer rows in device memory. On a CPU graph the
plain version below, which is the reference's program in torch.
"""
from __future__ import annotations

import torch

from ..graph.graph import TorchGraph
from . import _build
from .walks import csr_edge_ids_plain

EDGE_METRIC_NAMES = [
    "AdamicAdar",
    "JaccardCoefficient",
    "ResourceAllocationIndex",
    "PreferentialAttachment",
]
N_EDGE_METRICS = len(EDGE_METRIC_NAMES)
# Ids of the other row K8's group holds in its registers (8 lanes of
# `kHeld` = 8 ids in the source).
HELD = 64


def edge_metrics_plain(
    tg: TorchGraph, src: torch.Tensor, dst: torch.Tensor, cap: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of K8: a [B, width] block of candidates and one
    masked search over all of them. `width` is `cap`, cut to the longest
    expanded row (the offsets past it are all masked in the reference)."""
    deg = tg.degrees.long()
    src, dst = src.long(), dst.long()
    swap = deg[dst] < deg[src]
    a = torch.where(swap, dst, src)
    b = torch.where(swap, src, dst)
    da = deg[a].clamp(max=cap)
    width = min(cap, int(da.max())) if src.numel() else 0
    offs = torch.arange(width, device=src.device)
    valid = offs[None, :] < da[:, None]
    idx = (tg.row_ptr[a].long()[:, None]
           + torch.minimum(offs[None, :], (da - 1).clamp(min=0)[:, None]))
    cand = tg.col_idx[idx.clamp(0, max(tg.n_arcs - 1, 0))].long()
    _, member = csr_edge_ids_plain(
        tg.row_ptr, tg.col_idx, b[:, None].expand(-1, width).reshape(-1),
        cand.reshape(-1))
    m = (member.reshape(src.shape[0], width) & valid).to(torch.float32)
    cdeg = deg[cand].to(torch.float32)
    inv_log = torch.where(cdeg > 1, 1.0 / torch.log(cdeg.clamp(min=2.0)), 0.0)
    inv = torch.where(cdeg > 0, 1.0 / cdeg.clamp(min=1.0), 0.0)
    inter = m.sum(dim=1)
    aa = (m * inv_log).sum(dim=1)
    ra = (m * inv).sum(dim=1)
    dsf = deg[src].to(torch.float32)
    ddf = deg[dst].to(torch.float32)
    union = dsf + ddf - inter
    jac = torch.where(union > 0, inter / union.clamp(min=1.0), 0.0)
    return torch.stack([aa, jac, ra, dsf * ddf], dim=1)


def edge_metrics(
    tg: TorchGraph, src: torch.Tensor, dst: torch.Tensor, cap: int = 128,
) -> torch.Tensor:
    """[B, 4] float32: Adamic-Adar, Jaccard, resource allocation and
    preferential attachment of each (src[i], dst[i]) over `tg`, whose
    degrees are its arc counts. Kernel K8 on a CUDA graph (src and dst
    int32), the plain version on a CPU graph."""
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}.")
    if not _build.is_cuda(tg.col_idx):
        return edge_metrics_plain(tg, src, dst, cap)
    dev = tg.device
    n = src.shape[0]
    _build.check(tg.row_ptr, "row_ptr", torch.int32, (tg.n_nodes + 1,), dev)
    _build.check(tg.col_idx, "col_idx", torch.int32, None, dev)
    _build.check(src, "src", torch.int32, (n,), dev)
    _build.check(dst, "dst", torch.int32, (n,), dev)
    out = torch.empty((n, N_EDGE_METRICS), dtype=torch.float32, device=dev)
    _build.launch(
        "edge_metrics", "ebt_edge_metrics", dev, tg.row_ptr.data_ptr(),
        tg.col_idx.data_ptr(), src.data_ptr(), dst.data_ptr(), n, cap,
        out.data_ptr(),
    )
    return out
