"""HyperLogLog k-hop ball sketches and their edge features — counterpart of
`embiggen_tpu/ops/hll.py`, the device half of HyperSketching.

- `singleton_registers`: [N, 2^precision] uint8 registers of the singleton
  sets {v} (the lowbias32 hash of v plus the seed's offset, its low bits
  the register index, rho of the rest); kernel K16a's first launch on the
  card, equal to the reference's bit for bit.
- `khop_sketches`: [N, H, M] registers of the 1..H-hop balls, each hop the
  register-wise max over a node and its out-neighbours; K16a's hop launch
  once per hop (`hop_launch`: a group of lanes a row, the rows of more
  than HOP_SPLIT arcs cut into chunks by the export's row plan and merged
  by a second launch). The reference returns [H, N, M] and its caller
  transposes; the port keeps [N, H, M], which is what the per-pair
  gathers read.
- `khop_sketches_of_singletons`: the same sketches from the singletons,
  byte for byte, as HyperSketching fits them: K16a's singleton route reads
  ids where the hops read registers (hop 1 hashes v and its row's ids; hop
  2 takes, for every row, the id route over its neighbours' rows or the
  hop launch, as `hop2_route` picks from the degrees), then the hop launch
  from hop 3 on. No singletons launch runs.
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

from typing import Optional, Union

import torch

from ..graph.graph import TorchGraph
from . import _build
from .bfs import arc_rows
from .rowplan import NO_SPLIT, RowPlan, chunk_of_arcs

_MASK32 = 0xFFFFFFFF
# Bytes per chunk of the plain versions' gathers (about 256 MB).
_CHUNK_BYTES = 1 << 28
# Hop 2 of the singleton route takes one route for every row of a launch,
# which `hop2_route` picks from the graph's mean and largest degree. The id
# route where a neighbour's row of the mean degree, 4 mean bytes of ids, is
# at most HOP2_ID_PERCENT % of the M register bytes the hop launch reads for
# it: on an H100 (80GB HBM3, 700 W) it took about 3.5 times the hop launch's
# time a byte (erdos_renyi(1M, 10M), precision 8: 1.76 GB of ids in 1.93 ms
# against 5.4 GB of registers in 1.70; PERF.md).
HOP2_ID_PERCENT = 30
# A warp forms a row, so a row whose id route reads more ids than this
# outlasts the launch (a hub's 35,000 neighbours of degree 38 took over
# 20 ms alone on the H100).
HOP2_WARP_IDS = 1 << 16
# The hop launch gives a row a group of HOP_LANES lanes where its M / 16
# pieces of 16 bytes are fewer (HOP_LANES / pieces neighbours' rows at
# once: 8 at precision 4, 1 from precision 7), else a lane a piece; rows of
# more than HOP_SPLIT arcs are cut into chunks of HOP_SPLIT arcs, each a
# group's, merged by a second launch. On an H100 (80GB HBM3, 700 W), ten
# means a setting: 8 lanes ran precision 4 fastest on the slice graph and
# the hub graph (0.181 and 0.300 ms; 4 lanes 0.185 and 0.327); at 6 they
# ran 1.4% behind a lane a piece on the slice graph (0.501 against 0.494)
# and 10% ahead on the hub graph (0.771 against 0.852). On the hub graph
# chunks of 512 arcs ran precision 8 fastest (2.471 ms; 1,024 2.491, 2,048
# 2.474), within 6% of 1,024 at precisions 4-5 and 11% ahead of 2,048 at
# 5 (PERF.md).
HOP_LANES = 8
HOP_SPLIT = 512
# "ids": hop 2 by the singleton route's id launch; "hop": by the hop
# launch, as every later hop.
HOP2_ROUTES = ("ids", "hop")


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
                        device: Union[str, torch.device] = "cuda") -> torch.Tensor:
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


def hop_merge_plain(plan: RowPlan, own: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the hop's merge launch: [L, M], the long
    rows' own registers `own` and their chunks' maxima `partials` ([C, M]),
    a byte-wise max (`index_reduce_` "amax")."""
    return own.clone().index_reduce_(0, plan.owners(), partials, "amax", include_self=True)


def khop_sketches_split_plain(tg: TorchGraph, base: torch.Tensor, hops: int,
                              split: int = HOP_SPLIT) -> torch.Tensor:
    """Plain PyTorch version of the hop launch's split route at `split`:
    each hop, the short rows' maxima and the long rows' chunk maxima (an
    `index_reduce_` "amax" over the arcs' segments,
    `rowplan.chunk_of_arcs`), then the merge's plain version."""
    n, m = base.shape
    plan = tg.row_plan(split)
    seg = chunk_of_arcs(plan, tg.row_ptr)
    long_rows = plan.rows.long()
    out = torch.empty((n, hops, m), dtype=torch.uint8, device=base.device)
    chunk = max(1, _CHUNK_BYTES // m)
    current = base
    for h in range(hops):
        ext = torch.cat([current, current.new_zeros((plan.n_chunks, m))])
        for i in range(0, tg.n_arcs, chunk):
            ext.index_reduce_(0, seg[i:i + chunk], current[tg.col_idx[i:i + chunk].long()],
                              "amax", include_self=True)
        nxt = ext[:n]
        nxt[long_rows] = hop_merge_plain(plan, current[long_rows], ext[n:])
        out[:, h] = nxt
        current = out[:, h]
    return out


def hop_slots(m: int) -> int:
    """Neighbour slots of the hop launch's group at M registers: HOP_LANES
    lanes a row where its M / 16 pieces are fewer and divide 32, else 1."""
    units = m // 16
    if units >= HOP_LANES or 32 % units:
        return 1
    return HOP_LANES // units


def hop_launch(tg: TorchGraph, src: int, src_stride: int, dst: int, dst_stride: int,
               m: int) -> None:
    """One hop of K16a on the card, from the registers at address `src`
    (rows of `m` bytes at byte stride `src_stride`) to `dst`: the hop
    launch (counted under "khop_sketches") over the export's row plan at
    HOP_SPLIT, and where the plan has chunks, the merge launch (counted
    under "khop_merge")."""
    dev = tg.device
    plan = tg.row_plan(HOP_SPLIT)
    partials = None
    if plan.n_chunks:
        partials = torch.empty((plan.n_chunks, m), dtype=torch.uint8, device=dev)
    _build.launch("khop_sketches", "ebt_hll_hop", dev, tg.row_ptr.data_ptr(),
                  tg.col_idx.data_ptr(), src, src_stride, dst, dst_stride, tg.n_nodes, m,
                  hop_slots(m),
                  *((None, None, 0, NO_SPLIT, None) if partials is None else (
                      plan.chunk_rows.data_ptr(), plan.chunk_starts.data_ptr(),
                      plan.n_chunks, plan.split, partials.data_ptr())))
    if partials is not None:
        _build.launch("khop_merge", "ebt_hll_hop_merge", dev, plan.rows.data_ptr(),
                      plan.chunk_ptr.data_ptr(), plan.n_rows, src, src_stride,
                      partials.data_ptr(), dst, dst_stride, m)


def hop2_route(tg: TorchGraph, precision: int) -> str:
    """The route of hop 2 on the singleton route, from the graph's mean and
    largest degree: "ids" where a neighbour's row of the mean degree reads
    fewer bytes than HOP2_ID_PERCENT % of its M registers and no row's id
    route (its degree times the mean degree + 1) exceeds HOP2_WARP_IDS;
    else "hop", the hop launch. It picks the fastest route measured at
    every precision from 4 to 12 on an H100 (PERF.md): on
    erdos_renyi(1M, 10M) the hop launch at 4-8 and ids at 9-12; with 256
    hubs of 4,096-65,536 neighbours added, the hop launch at 4-12."""
    m = 1 << precision
    mean = tg.n_arcs / max(tg.n_nodes, 1)
    if tg.n_arcs == 0:
        return "hop"
    longest = int(tg.degrees.max())
    if 400 * mean <= HOP2_ID_PERCENT * m and longest * (mean + 1) <= HOP2_WARP_IDS:
        return "ids"
    return "hop"


def khop_sketches_of_singletons_plain(tg: TorchGraph, hops: int, precision: int = 8,
                                      bits: int = 6, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K16a's singleton route: the plain hops over
    the plain singletons (every route gives these bytes)."""
    base = singleton_registers_plain(tg.n_nodes, precision, bits, seed, tg.col_idx.device)
    return khop_sketches_plain(tg, base, hops)


def khop_sketches_of_singletons(
    tg: TorchGraph, hops: int, precision: int = 8, bits: int = 6, seed: int = 0,
    route: Optional[str] = None,
) -> torch.Tensor:
    """[N, hops, 2^precision] uint8 sketches of the 1..hops-hop balls from
    the singletons: `khop_sketches(tg, singleton_registers(N, precision,
    bits, seed), hops)` byte for byte. On a CUDA graph K16a's singleton
    route: hop 1 from the ids; hop 2 by `route` (one of HOP2_ROUTES;
    None: as `hop2_route` picks); then the hop launch. The plain version
    on a CPU graph."""
    if not 4 <= precision <= 12:
        raise ValueError("precision must be in [4, 12]")
    if hops < 1:
        raise ValueError(f"hops must be positive, got {hops}.")
    if route is not None and route not in HOP2_ROUTES:
        raise ValueError(f"route must be one of {HOP2_ROUTES}, got {route!r}.")
    if not _build.is_cuda(tg.col_idx):
        return khop_sketches_of_singletons_plain(tg, hops, precision, bits, seed)
    dev = tg.device
    n, m = tg.n_nodes, 1 << precision
    _build.check(tg.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    _build.check(tg.col_idx, "col_idx", torch.int32, None, dev)
    out = torch.empty((n, hops, m), dtype=torch.uint8, device=dev)
    stride, offset = hops * m, seed_offset(seed)
    rp, cols = tg.row_ptr.data_ptr(), tg.col_idx.data_ptr()
    _build.launch("sketch_hop1", "ebt_hll_ball", dev, rp, cols, n, precision, bits, offset, 0,
                  out.data_ptr(), stride)
    route = route or (hop2_route(tg, precision) if hops >= 2 else "hop")
    ball_hop2 = hops >= 2 and route == "ids"
    if ball_hop2:
        _build.launch("sketch_hop2", "ebt_hll_ball", dev, rp, cols, n, precision, bits, offset,
                      1, out.data_ptr() + m, stride)
    for h in range(2 if ball_hop2 else 1, hops):
        hop_launch(tg, out.data_ptr() + (h - 1) * m, stride, out.data_ptr() + h * m, stride, m)
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
        hop_launch(tg, src, src_stride, out.data_ptr() + h * m, hops * m, m)
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
