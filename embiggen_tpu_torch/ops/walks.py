"""Random walks and CSR membership — counterpart of
`embiggen_tpu/ops/walks.py` (`random_walks` with its first-order, ELL,
rejection and exact branches, `_sample_neighbor`, `_sample_from_ell_row`,
`_second_order_step_ell`, `_second_order_step_rejection`,
`_second_order_step_exact`, `skipgram_pairs`, `node2vec_batch`;
`csr_has_edges` and `csr_edge_ids`).

A first-order step draws a uniform neighbour from the CSR row, or a Walker
alias draw when the graph is weighted; a node of degree zero keeps the
walker where it is. On a CUDA graph all steps of all walkers run in one
launch of kernel K1 (`csrc/sampling.cu`).

A second-order (p/q) step weighs each candidate c of the current node by
return_weight when c is the previous node, 1 when c neighbours the previous
node, else explore_weight, times the arc's weight. `random_walks` picks the
sampler on the host, as the JAX version does at trace time:
- the graph carries an ELL table at least as wide as the cap: kernel K9
  (`csrc/walks2.cu`), the exact inverse-CDF draw over the capped ELL rows,
  with membership tested against the previous node's ELL row;
- else a p/q weight ratio of at most 16: kernel K10 (`csrc/walks2.cu`),
  rejection sampling of first-order proposals over the full CSR row, with
  membership by K5's search (`csrc/csr.cuh`);
- else (or with `exact_pq`) the exact sampler over a rotated window of the
  row, which runs only as its plain version on the CPU (on the card it
  comes with ROADMAP A6's typed walks).
Each kernel draws from its own Philox stream, so kernel and plain version
agree in distribution, not bit for bit.

Arc membership is a lower-bound search in the sorted CSR row: kernel K5
(`csrc/edges.cu`) on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..graph.graph import TorchGraph
from . import _build

# K9's phases, as its PHASE_CLOCK build stamps them (`ell_phase_split`).
ELL_PHASES = ("row_load", "membership_weights", "pick")


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


def _ell_pick(w: torch.Tensor, generator: torch.Generator):
    """Inverse-CDF pick per row of the weights `w` [B, C]: (slot, total).
    The slot is #(cdf <= u) for u uniform in [0, total), as in the JAX
    samplers, and at most the row's last slot of positive weight, which
    differs from the JAX rule's `min(., C - 1)` only where u rounds up to
    the total and that rule would pick a padding slot."""
    cdf = torch.cumsum(w, dim=1)
    total = cdf[:, -1]
    u = torch.rand(total.shape, generator=generator, device=w.device) * total
    pick = (cdf <= u[:, None]).sum(dim=1)
    slots = torch.arange(w.shape[1], device=w.device)
    last = torch.where(w > 0, slots, 0).amax(dim=1)
    return torch.minimum(pick, last), total


def _sample_from_ell_row(
    row: torch.Tensor, w_row: Optional[torch.Tensor], fallback: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """First-order draw from gathered ELL rows `row` [B, C] (-1 padded):
    uniform over the valid slots, or by the arc weights `w_row`; the walker
    stays at `fallback` where the row is empty. Plain version of K9's first
    step."""
    valid = row >= 0
    w = valid.float() if w_row is None else torch.where(valid, w_row, 0.0)
    pick, total = _ell_pick(w, generator)
    nxt = torch.gather(row, 1, pick[:, None])[:, 0].long()
    return torch.where(total > 0, nxt, fallback.long())


def _pq_weights(cands, prev, is_common, return_weight, explore_weight):
    w = torch.full(cands.shape, float(explore_weight), device=cands.device)
    w = torch.where(is_common, 1.0, w)
    return torch.where(cands == prev[:, None], float(return_weight), w)


def _second_order_step_ell(
    tg: TorchGraph, prev: torch.Tensor, prev_row: torch.Tensor,
    curr: torch.Tensor, return_weight: float, explore_weight: float, cap: int,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One p/q step over the ELL rows: the candidates are the first
    min(cap, ell_cap) slots of curr's row, a candidate is common when it is
    in `prev_row` (prev's whole ELL row, so an over-cap prev is represented
    by its export-time subsample; padding only meets padding, which weighs
    0). Returns (next nodes, curr's whole row for the next step's
    `prev_row`). Plain version of one K9 step."""
    c_eff = min(cap, tg.ell_cap)
    row_full = tg.ell_cols[curr.long()]
    row = row_full[:, :c_eff]
    # Membership by a search in prev's row sorted, O(B cap) memory.
    members = prev_row.sort(dim=1).values
    at = torch.searchsorted(members, row).clamp(max=members.shape[1] - 1)
    is_common = torch.gather(members, 1, at) == row
    w = _pq_weights(row, prev.long(), is_common, return_weight, explore_weight)
    if tg.ell_w is not None:
        w = w * tg.ell_w[curr.long()][:, :c_eff]
    w = torch.where(row >= 0, w, 0.0)
    pick, total = _ell_pick(w, generator)
    nxt = torch.gather(row, 1, pick[:, None])[:, 0].long()
    return torch.where(total > 0, nxt, curr.long()), row_full


def _second_order_step_rejection(
    tg: TorchGraph, prev: torch.Tensor, curr: torch.Tensor,
    return_weight: float, explore_weight: float, n_tries: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """One p/q step by rejection: `n_tries` first-order proposals over the
    full CSR row (uniform, or alias draws on weighted graphs), each accepted
    when u * w_max < w(c); the first accepted is the draw, and where all
    reject, a weighted pick among the proposals (sampling-importance-
    resampling). Plain version of one K10 step."""
    curr, prev = curr.long(), prev.long()
    b, t, dev = curr.shape[0], n_tries, curr.device
    deg = tg.degrees[curr]
    base = tg.row_ptr[curr].long()
    top = max(tg.n_arcs - 1, 0)
    offs = _uniform_offset(torch.rand((b, t), generator=generator, device=dev),
                           deg[:, None])
    idx = (base[:, None] + offs).clamp(0, top)
    if tg.alias_prob is not None:
        coin = torch.rand((b, t), generator=generator, device=dev)
        offs = torch.where(coin >= tg.alias_prob[idx], tg.alias_idx[idx].long(), offs)
        idx = (base[:, None] + offs).clamp(0, top)
    cands = tg.col_idx[idx].long()
    is_common = csr_edge_ids_plain(
        tg.row_ptr, tg.col_idx, prev[:, None].expand(b, t).reshape(-1),
        cands.reshape(-1))[1].reshape(b, t)
    w = _pq_weights(cands, prev, is_common, return_weight, explore_weight)
    w_max = max(return_weight, 1.0, explore_weight)
    accept = torch.rand((b, t), generator=generator, device=dev) * w_max < w
    first = accept.int().argmax(dim=1)
    cdf = torch.cumsum(w, dim=1)
    u = torch.rand((b,), generator=generator, device=dev) * cdf[:, -1]
    fallback = torch.clamp((cdf <= u[:, None]).sum(dim=1), max=t - 1)
    pick = torch.where(accept.any(dim=1), first, fallback)
    nxt = torch.gather(cands, 1, pick[:, None])[:, 0]
    return torch.where(deg > 0, nxt, curr)


def _second_order_step_exact(
    tg: TorchGraph, prev: torch.Tensor, curr: torch.Tensor,
    return_weight: float, explore_weight: float, max_neighbours: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """One p/q step, exact within the capped neighbourhood: when deg(curr)
    exceeds `max_neighbours` the candidates are a randomly rotated window of
    that many consecutive CSR entries (a fresh rotation per step); membership
    is searched in prev's full CSR row. The test oracle of K9 and K10."""
    curr, prev = curr.long(), prev.long()
    b, m, dev = curr.shape[0], max_neighbours, curr.device
    deg_full = tg.degrees[curr].long()
    deg = deg_full.clamp(max=m)
    base = tg.row_ptr[curr].long()
    offs = torch.arange(m, device=dev).expand(b, m)
    valid = offs < deg[:, None]
    rot = _uniform_offset(torch.rand((b,), generator=generator, device=dev), deg_full)
    rot = torch.where(deg_full > m, rot, 0)
    offs = torch.where(valid, (rot[:, None] + offs) % deg_full.clamp(min=1)[:, None], 0)
    idx = (base[:, None] + offs).clamp(0, max(tg.n_arcs - 1, 0))
    cands = tg.col_idx[idx].long()
    is_common = csr_edge_ids_plain(
        tg.row_ptr, tg.col_idx, prev[:, None].expand(b, m).reshape(-1),
        cands.reshape(-1))[1].reshape(b, m)
    w = _pq_weights(cands, prev, is_common, return_weight, explore_weight)
    if tg.weights is not None:
        w = w * tg.weights[idx]
    w = torch.where(valid, w, 0.0)
    cdf = torch.cumsum(w, dim=1)
    u = torch.rand((b,), generator=generator, device=dev) * cdf[:, -1]
    pick = torch.minimum((cdf <= u[:, None]).sum(dim=1), (deg - 1).clamp(min=0))
    nxt = torch.gather(cands, 1, pick[:, None])[:, 0]
    return torch.where(deg > 0, nxt, curr)


def ell_walks_plain(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, cap: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Plain PyTorch version of K9: the first step first-order from the
    start's whole ELL row, then a Python loop of ELL steps that carries the
    previous node's row."""
    cols = [starts.long()]
    if walk_length > 1:
        row = tg.ell_cols[cols[0]]
        w0 = None if tg.ell_w is None else tg.ell_w[cols[0]]
        cols.append(_sample_from_ell_row(row, w0, cols[0], generator))
    for _ in range(walk_length - 2):
        nxt, row = _second_order_step_ell(tg, cols[-2], row, cols[-1], return_weight,
                                          explore_weight, cap, generator)
        cols.append(nxt)
    return torch.stack(cols, dim=1).to(torch.int32)


def _second_order_walks_plain(step, tg, starts, walk_length, generator):
    cols = [starts.long()]
    if walk_length > 1:
        cols.append(_sample_neighbor(tg, cols[0], generator))
    for _ in range(walk_length - 2):
        cols.append(step(cols[-2], cols[-1]))
    return torch.stack(cols, dim=1).to(torch.int32)


def rejection_walks_plain(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, n_tries: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Plain PyTorch version of K10: a first-order first step, then a
    Python loop of rejection steps."""
    return _second_order_walks_plain(
        lambda prev, curr: _second_order_step_rejection(
            tg, prev, curr, return_weight, explore_weight, n_tries, generator),
        tg, starts, walk_length, generator)


def exact_walks_plain(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, max_neighbours: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Walks of the exact sampler: a first-order first step, then exact
    steps. CPU graphs only: its kernel comes with ROADMAP A6."""
    if _build.is_cuda(tg.col_idx):
        raise NotImplementedError(
            "The exact p/q sampler (exact_pq, or a weight ratio above 16 on a "
            "graph without an ELL table) has no kernel yet (ROADMAP A6); on a "
            "CUDA graph, export the ELL table (Graph.device(ell_cap=...)).")
    return _second_order_walks_plain(
        lambda prev, curr: _second_order_step_exact(
            tg, prev, curr, return_weight, explore_weight, max_neighbours, generator),
        tg, starts, walk_length, generator)


def _launch_ell(counter, tg: TorchGraph, starts: torch.Tensor, walk_length: int,
                return_weight: float, explore_weight: float, cap: int,
                generator: torch.Generator, clocks=None, defines=()) -> torch.Tensor:
    """Check the inputs and launch K9 once; returns the walks."""
    dev = tg.device
    b = starts.shape[0]
    _build.check(starts, "starts", torch.int32, (b,), dev)
    _build.check(tg.ell_cols, "ell_cols", torch.int32, (tg.n_nodes, tg.ell_cap), dev)
    _build.check(tg.ell_w, "ell_w", torch.float32, (tg.n_nodes, tg.ell_cap), dev)
    walks = torch.empty((b, walk_length), dtype=torch.int32, device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        counter, "ebt_ell_walks", dev, tg.ell_cols.data_ptr(),
        _build.ptr(tg.ell_w), tg.ell_cap, min(cap, tg.ell_cap), starts.data_ptr(),
        walks.data_ptr(), b, walk_length, float(return_weight),
        float(explore_weight), seed, offset, _build.ptr(clocks), defines=defines,
    )
    return walks


def ell_walks(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, cap: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """[B, walk_length] int32 p/q walks over the graph's ELL table, with
    candidates capped at min(cap, ell_cap). Kernel K9 on a CUDA graph, the
    plain version on a CPU graph. K9 holds a walker's two rows in shared
    memory, and its row of arc weights when the graph is weighted: 8 bytes
    a slot (12 weighted), so its rows may be up to about 29,000 slots wide
    (19,000 weighted) on the H100."""
    if tg.ell_cols is None:
        raise ValueError("ell_walks needs a graph exported with ell_cap.")
    if walk_length < 1:
        raise ValueError(f"walk_length must be positive, got {walk_length}.")
    if not _build.is_cuda(tg.col_idx):
        return ell_walks_plain(tg, starts, walk_length, return_weight,
                               explore_weight, cap, generator)
    return _launch_ell("ell_walks", tg, starts, walk_length, return_weight,
                       explore_weight, cap, generator)


def ell_phase_split(tg: TorchGraph, starts: torch.Tensor, walk_length: int,
                    return_weight: float, explore_weight: float, cap: int,
                    generator: torch.Generator) -> Dict[str, float]:
    """Share of K9's walker time in each phase (ELL_PHASES), from the
    clock64() stamps of the `_build.PHASE_CLOCK` build, summed over the
    walkers of one launch on a CUDA graph. The launch is counted nowhere."""
    clocks = torch.zeros((starts.shape[0], len(ELL_PHASES) + 1), dtype=torch.int64,
                         device=starts.device)
    _launch_ell(None, tg, starts, walk_length, return_weight, explore_weight, cap,
                generator, clocks=clocks, defines=_build.PHASE_CLOCK)
    return _build.clock_shares(clocks, ELL_PHASES)


def rejection_walks(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, n_tries: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """[B, walk_length] int32 p/q walks by rejection with `n_tries` (8 or
    16) proposals a step over the full CSR rows. Kernel K10 on a CUDA graph,
    the plain version on a CPU graph."""
    if n_tries not in (8, 16):
        raise ValueError(f"n_tries must be 8 or 16, got {n_tries}.")
    if walk_length < 1:
        raise ValueError(f"walk_length must be positive, got {walk_length}.")
    if not _build.is_cuda(tg.col_idx):
        return rejection_walks_plain(tg, starts, walk_length, return_weight,
                                     explore_weight, n_tries, generator)
    dev = tg.device
    _build.check(starts, "starts", torch.int32, (starts.shape[0],), dev)
    walks = torch.empty((starts.shape[0], walk_length), dtype=torch.int32,
                        device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "rejection_walks", "ebt_rejection_walks", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(),
        _build.ptr(tg.alias_prob), _build.ptr(tg.alias_idx),
        starts.data_ptr(), walks.data_ptr(), starts.shape[0], walk_length,
        float(return_weight), float(explore_weight), n_tries, seed, offset,
    )
    return walks


def random_walks(
    tg: TorchGraph,
    start_nodes: torch.Tensor,
    walk_length: int,
    generator: torch.Generator,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    max_neighbours: Optional[int] = None,
    exact_pq: bool = False,
    change_node_type_weight: float = 1.0,
    change_edge_type_weight: float = 1.0,
) -> torch.Tensor:
    """[B, walk_length] int32 walks starting at `start_nodes`. First-order
    when return_weight == explore_weight == 1 (K1); else p/q walks with the
    candidate cap `max_neighbours` (default 100): K9 when the graph carries
    an ELL table covering min(cap, max degree), else K10 for a weight ratio
    of at most 16 (8 tries up to ratio 4, 16 above), else the exact sampler,
    which `exact_pq` forces (CPU graphs only)."""
    for name, value in (("change_node_type_weight", change_node_type_weight),
                        ("change_edge_type_weight", change_edge_type_weight)):
        if value != 1.0:
            raise NotImplementedError(
                f"{name}={value}: typed walks are not ported yet (ROADMAP A6).")
    if return_weight == 1.0 and explore_weight == 1.0:
        return first_order_walks(tg, start_nodes, walk_length, generator)
    cap = max_neighbours if max_neighbours is not None else 100
    if (not exact_pq and tg.ell_cols is not None
            and tg.ell_cap >= min(cap, max(tg.max_degree, 1))):
        return ell_walks(tg, start_nodes, walk_length, return_weight,
                         explore_weight, cap, generator)
    ratio = (max(return_weight, 1.0, explore_weight)
             / max(min(return_weight, 1.0, explore_weight), 1e-9))
    if exact_pq or ratio > 16.0:
        return exact_walks_plain(tg, start_nodes, walk_length, return_weight,
                                 explore_weight, cap, generator)
    return rejection_walks(tg, start_nodes, walk_length, return_weight,
                           explore_weight, 8 if ratio <= 4.0 else 16, generator)


def skipgram_pairs(
    walks: torch.Tensor, window_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(contexts [N, 2w], words [N]) training pairs of `walks` [B, L], N = B
    (L - 2w): the centres at positions w .. L - w - 1 and their contexts at
    offsets -w .. w without 0, in the reference's layout."""
    b, length = walks.shape
    w = window_size
    n_centers = length - 2 * w
    words = walks[:, w:w + n_centers].reshape(-1)
    contexts = torch.stack(
        [walks[:, w + off:w + off + n_centers] for off in range(-w, w + 1) if off != 0],
        dim=-1).reshape(-1, 2 * w)
    return contexts, words


def node2vec_batch(
    tg: TorchGraph, start_nodes: torch.Tensor, walk_length: int,
    window_size: int, generator: torch.Generator, iterations: int = 1,
    return_weight: float = 1.0, explore_weight: float = 1.0,
    max_neighbours: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walks from each start node `iterations` times, cut into
    `skipgram_pairs`."""
    walks = random_walks(tg, start_nodes.repeat(iterations), walk_length, generator,
                         return_weight=return_weight, explore_weight=explore_weight,
                         max_neighbours=max_neighbours)
    return skipgram_pairs(walks, window_size)


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
