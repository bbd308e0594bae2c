"""HyperLogLog k-hop ball sketches and their edge features — counterpart of
`embiggen_tpu/ops/hll.py`, the device half of HyperSketching.

- `singleton_registers`: [N, 2^precision] uint8 registers of the singleton
  sets {v} (the lowbias32 hash of v plus the seed's offset, its low bits
  the register index, rho of the rest); kernel K16a's first launch on the
  card, equal to the reference's bit for bit.
- `khop_sketches`: [N, H, M] registers of the 1..H-hop balls, each hop the
  register-wise max over a node and its out-neighbours; K16a's hop launch
  once per hop. The reference returns [H, N, M] and its caller transposes;
  the port keeps [N, H, M], which is what the per-pair gathers read.
- `hll_cardinality`: the estimate over the last axis (plain torch).
- `edge_sketch_features`: [B, H^2 + 2H] overlaps and differences of each
  (src, dst) pair's balls; kernel K16b, which never forms the [B, H, H, M]
  unions of the reference: a group of lanes a pair, every set's partial
  sums in one pass over the words for H <= 3, a general route for larger H.

Each has its plain PyTorch version, which the wrappers take on CPU tensors.
The plain hash works in int64 with a mask after each multiply, since
PyTorch has no clz and no dependable uint32 multiply on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

from ..graph.graph import TorchGraph
from . import _build
from .bfs import arc_rows

_MASK32 = 0xFFFFFFFF
# Bytes per chunk of the plain versions' gathers (about 256 MB).
_CHUNK_BYTES = 1 << 28


def hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash (lowbias32) of int64 values in [0, 2^32), as
    int64 in the same range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 below 2^32 (0 for 0): 32 - clz32."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) > 0
        n = n + big * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0)


def seed_offset(seed: int) -> int:
    """The uint32 offset the reference adds to the node ids."""
    return (seed * 1_000_003) & 0x7FFFFFFF


def singleton_registers_plain(n_nodes: int, precision: int = 8, bits: int = 6,
                              seed: int = 0, device: Union[str, torch.device] = "cpu",
                              ) -> torch.Tensor:
    """Plain PyTorch version of K16a's singletons."""
    m = 1 << precision
    ids = (torch.arange(n_nodes, dtype=torch.int64, device=device)
           + seed_offset(seed)) & _MASK32
    h = hash32(ids)
    reg_idx = h & (m - 1)
    rest = h >> precision
    clz_in_width = 32 - _bit_length(rest) - precision
    top = (1 << bits) - 1
    rho = torch.where(rest == 0, top, clz_in_width + 1).clamp(1, top)
    regs = torch.zeros((n_nodes, m), dtype=torch.uint8, device=device)
    regs[torch.arange(n_nodes, device=device), reg_idx] = (rho & 0xFF).to(torch.uint8)
    return regs


def singleton_registers(n_nodes: int, precision: int = 8, bits: int = 6, seed: int = 0,
                        device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """[N, 2^precision] uint8 HLL registers of the singleton sets {v} on
    `device`: K16a's singletons launch on a CUDA device, the plain version
    on the CPU."""
    if not 4 <= precision <= 12:
        raise ValueError("precision must be in [4, 12]")
    out = torch.empty((n_nodes, 1 << precision), dtype=torch.uint8, device=device)
    if not _build.is_cuda(out):
        return singleton_registers_plain(n_nodes, precision, bits, seed, device)
    _build.launch("hll_registers", "ebt_hll_singletons", out.device, n_nodes,
                  precision, bits, seed_offset(seed), out.data_ptr())
    return out


def khop_sketches_plain(tg: TorchGraph, base: torch.Tensor, hops: int) -> torch.Tensor:
    """Plain PyTorch version of K16a's hops: each hop a chunked gather and
    an `index_reduce_` "amax" of the previous hop over the arcs."""
    n, m = base.shape
    out = torch.empty((n, hops, m), dtype=torch.uint8, device=base.device)
    rows = arc_rows(tg).long()
    chunk = max(1, _CHUNK_BYTES // m)
    current = base
    for h in range(hops):
        nxt = current.clone()
        for i in range(0, tg.n_arcs, chunk):
            nxt.index_reduce_(0, rows[i:i + chunk], current[tg.col_idx[i:i + chunk].long()],
                              "amax", include_self=True)
        out[:, h] = nxt
        current = nxt
    return out


def khop_sketches(tg: TorchGraph, base: torch.Tensor, hops: int) -> torch.Tensor:
    """[N, hops, M] uint8 registers of the 1..hops-hop balls (each hop
    includes the one before): K16a's hop launch once per hop on CUDA
    tensors, the plain version on CPU tensors."""
    if not _build.is_cuda(base):
        return khop_sketches_plain(tg, base, hops)
    dev = base.device
    n, m = base.shape
    if n != tg.n_nodes or m % 16:
        raise ValueError(f"base has shape {tuple(base.shape)} for {tg.n_nodes} nodes; "
                         "the registers must be a multiple of 16.")
    _build.check(base, "base", torch.uint8, None, dev)
    _build.check(tg.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    _build.check(tg.col_idx, "col_idx", torch.int32, None, dev)
    out = torch.empty((n, hops, m), dtype=torch.uint8, device=dev)
    for h in range(hops):
        src, src_stride = ((base.data_ptr(), m) if h == 0
                           else (out.data_ptr() + (h - 1) * m, hops * m))
        _build.launch("khop_sketches", "ebt_hll_hop", dev, tg.row_ptr.data_ptr(),
                      tg.col_idx.data_ptr(), src, src_stride, out.data_ptr() + h * m,
                      hops * m, n, m)
    return out


def _alpha_mm(precision: int) -> float:
    """alpha m^2 of the raw estimate, in float64 as the reference forms it."""
    m = 1 << precision
    alpha = {4: 0.673, 5: 0.697, 6: 0.709}.get(precision, 0.7213 / (1 + 1.079 / m))
    return alpha * m * m


def hll_cardinality(regs: torch.Tensor, precision: int) -> torch.Tensor:
    """HLL cardinality estimate over the last axis of [..., M] registers,
    with linear counting below 2.5 M when a register is zero."""
    m = 1 << precision
    inv = torch.exp2(-regs.to(torch.float32))
    raw = _alpha_mm(precision) / inv.sum(dim=-1)
    zeros = (regs == 0).sum(dim=-1).to(torch.float32)
    linear = m * torch.log(m / torch.clamp(zeros, min=1e-9))
    return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)


def _features_of_registers(src_regs: torch.Tensor, dst_regs: torch.Tensor,
                           precision: int) -> torch.Tensor:
    """The reference's features of gathered [B, H, M] registers."""
    b, h, _ = src_regs.shape
    card_s = hll_cardinality(src_regs, precision)
    card_d = hll_cardinality(dst_regs, precision)
    union = torch.maximum(src_regs[:, :, None, :], dst_regs[:, None, :, :])
    card_u = hll_cardinality(union, precision)
    overlap = torch.clamp(card_s[:, :, None] + card_d[:, None, :] - card_u, min=0.0)
    left = torch.clamp(card_s - overlap[:, :, h - 1], min=0.0)
    right = torch.clamp(card_d - overlap[:, h - 1, :], min=0.0)
    return torch.cat([overlap.reshape(b, h * h), left, right], dim=1)


def edge_sketch_features_plain(sketches: torch.Tensor, src: torch.Tensor,
                               dst: torch.Tensor, precision: int) -> torch.Tensor:
    """Plain PyTorch version of K16b: gathers and the reference's program,
    in chunks of pairs so the [chunk, H, H, M] unions stay about 256 MB."""
    _, h, m = sketches.shape
    src, dst = src.long(), dst.long()
    chunk = max(1, _CHUNK_BYTES // (h * h * m))
    parts = [_features_of_registers(sketches[src[i:i + chunk]], sketches[dst[i:i + chunk]],
                                    precision)
             for i in range(0, src.shape[0], chunk)]
    if not parts:
        return torch.zeros((0, h * h + 2 * h), dtype=torch.float32, device=sketches.device)
    return torch.cat(parts)


def edge_sketch_features(sketches: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                         precision: int) -> torch.Tensor:
    """[B, H^2 + 2H] float32 of each (src[i], dst[i]) pair over [N, H, M]
    sketches: the pairwise hop-ball overlap cardinalities |B_i(s) ∩ B_j(d)|
    (inclusion-exclusion on HLL unions), then the left and right difference
    cardinalities against the largest opposite ball. Kernel K16b on CUDA
    tensors (src and dst int32), the plain version on CPU tensors."""
    if not _build.is_cuda(sketches):
        return edge_sketch_features_plain(sketches, src, dst, precision)
    dev = sketches.device
    n, h, m = sketches.shape
    if m != 1 << precision:
        raise ValueError(f"sketches have {m} registers, precision {precision} "
                         f"means {1 << precision}.")
    b = src.shape[0]
    _build.check(sketches, "sketches", torch.uint8, None, dev)
    if sketches.data_ptr() % 16:
        raise ValueError("sketches must be 16-byte aligned for K16b's 16-byte loads.")
    _build.check(src, "src", torch.int32, (b,), dev)
    _build.check(dst, "dst", torch.int32, (b,), dev)
    out = torch.empty((b, h * h + 2 * h), dtype=torch.float32, device=dev)
    _build.launch("edge_sketch_features", "ebt_hll_edge_features", dev,
                  sketches.data_ptr(), h, m, src.data_ptr(), dst.data_ptr(), b,
                  _alpha_mm(precision), out.data_ptr())
    return out
