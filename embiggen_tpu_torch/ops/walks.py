"""Random walks and CSR membership — counterpart of
`embiggen_tpu/ops/walks.py` (`random_walks` with its first-order, ELL,
rejection and exact branches, typed or not, `_sample_neighbor`,
`_sample_from_ell_row`, `_second_order_step_ell`,
`_second_order_step_rejection`, `_second_order_step_exact`,
`skipgram_pairs`, `node2vec_batch`; `csr_has_edges` and `csr_edge_ids`).

A first-order step draws a uniform neighbour from the CSR row, or a Walker
alias draw when the graph is weighted; a node of degree zero keeps the
walker where it is. On a CUDA graph all steps of all walkers run in one
launch of kernel K1 (`csrc/sampling.cu`), which reads the arcs' records
(`TorchGraph.walk_arcs`) instead of row_ptr where the graph carries them.

A second-order (p/q) step weighs each candidate c of the current node by
return_weight when c is the previous node, 1 when c neighbours the previous
node, else explore_weight, times the arc's weight. Typed walks multiply it
by change_node_type_weight where c's primary node type differs from the
current node's, and by change_edge_type_weight where the arc's edge type
differs from the previous step's arc's. `random_walks` picks the sampler on
the host, as the JAX version does at trace time:
- the graph carries an ELL table at least as wide as the cap (and, for
  typed walks, its type tables): kernel K9 (`csrc/walks2.cu`), the exact
  inverse-CDF draw over the capped ELL rows, with membership tested against
  the previous node's ELL row;
- else, for typed walks, a weight ratio above 16 or `exact_pq`: kernel K19
  (`csrc/walks2.cu`), the exact draw over a rotated window of the CSR row,
  with membership by K5's search in the previous node's full row;
- else kernel K10 (`csrc/walks2.cu`), rejection sampling of first-order
  proposals over the full CSR row, with membership by K5's search
  (`csrc/csr.cuh`).
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
    Kernel K1 on a CUDA graph (Philox seeded from `generator`; a step is one
    load of an arc record when the graph carries `walk_arcs`), the plain
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
        _build.ptr(tg.alias_prob), _build.ptr(tg.alias_idx), walk_records(tg),
        starts.data_ptr(), walks.data_ptr(), starts.shape[0], walk_length,
        seed, offset,
    )
    return walks


def walk_records(tg: TorchGraph) -> Optional[int]:
    """The pointer to the graph's arc records (`TorchGraph.walk_arcs`) for
    the first-order walk kernels, or None: weighted walks (alias tables)
    read their rows."""
    if tg.walk_arcs is None or tg.alias_prob is not None:
        return None
    _build.check(tg.walk_arcs, "walk_arcs", torch.int32, (tg.n_arcs, 4), tg.device)
    return tg.walk_arcs.data_ptr()


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
    generator: torch.Generator, extra_w: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order draw from gathered ELL rows `row` [B, C] (-1 padded):
    uniform over the valid slots, or by the arc weights `w_row`, times the
    typed factors `extra_w` when given; the walker stays at `fallback` where
    the row has no weight. Returns (next nodes, picked slots). Plain version
    of K9's first step."""
    valid = row >= 0
    w = valid.float() if w_row is None else torch.where(valid, w_row, 0.0)
    if extra_w is not None:
        w = w * extra_w
    pick, total = _ell_pick(w, generator)
    nxt = torch.gather(row, 1, pick[:, None])[:, 0].long()
    return torch.where(total > 0, nxt, fallback.long()), pick


def _pq_weights(cands, prev, is_common, return_weight, explore_weight):
    w = torch.full(cands.shape, float(explore_weight), device=cands.device)
    w = torch.where(is_common, 1.0, w)
    return torch.where(cands == prev[:, None], float(return_weight), w)


def _node_factor(cand_nt: torch.Tensor, curr_nt: torch.Tensor, node_w: float) -> torch.Tensor:
    """node_w where a candidate's primary node type differs from the current
    node's (an unknown type, -1, differs from every type), else 1."""
    return torch.where(cand_nt != curr_nt[:, None], float(node_w), 1.0)


def _edge_factor(cand_et: torch.Tensor, prev_et: torch.Tensor, edge_w: float) -> torch.Tensor:
    """edge_w where a candidate arc's edge type differs from the previous
    arc's, else 1; a previous type of -1 (the walk's head, or after a step
    that stayed) weighs nothing."""
    differs = (cand_et != prev_et[:, None]) & (prev_et[:, None] >= 0)
    return torch.where(differs, float(edge_w), 1.0)


def _second_order_step_ell(
    tg: TorchGraph, prev: torch.Tensor, prev_row: torch.Tensor, curr: torch.Tensor,
    prev_et: Optional[torch.Tensor], return_weight: float, explore_weight: float, cap: int,
    node_w: float, edge_w: float, generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One p/q and typed step over the ELL rows: the candidates are the first
    min(cap, ell_cap) slots of curr's row, a candidate is common when it is
    in `prev_row` (prev's whole ELL row, so an over-cap prev is represented
    by its export-time subsample; padding only meets padding, which weighs
    0); then the typed factors from the slot tables (`_node_factor` with
    `ell_ntypes`, `_edge_factor` with `ell_etypes` against `prev_et`) and
    the arc weights. With p = q = 1 the p/q classification is skipped.
    Returns (next nodes, curr's whole row for the next step's `prev_row`,
    the picked arcs' edge types: -1 where the walker stays or the edge
    factor is 1). Plain version of one K9 step."""
    c_eff = min(cap, tg.ell_cap)
    curr = curr.long()
    row_full = tg.ell_cols[curr]
    row = row_full[:, :c_eff]
    if return_weight == 1.0 and explore_weight == 1.0:
        w = torch.ones(row.shape, device=row.device)
    else:
        # Membership by a search in prev's row sorted, O(B cap) memory.
        members = prev_row.sort(dim=1).values
        at = torch.searchsorted(members, row).clamp(max=members.shape[1] - 1)
        is_common = torch.gather(members, 1, at) == row
        w = _pq_weights(row, prev.long(), is_common, return_weight, explore_weight)
    if node_w != 1.0:
        w = w * _node_factor(tg.ell_ntypes[curr][:, :c_eff], tg.node_type_of[curr], node_w)
    if edge_w != 1.0:
        et_row = tg.ell_etypes[curr][:, :c_eff].long()
        w = w * _edge_factor(et_row, prev_et, edge_w)
    if tg.ell_w is not None:
        w = w * tg.ell_w[curr][:, :c_eff]
    w = torch.where(row >= 0, w, 0.0)
    pick, total = _ell_pick(w, generator)
    nxt = torch.gather(row, 1, pick[:, None])[:, 0].long()
    net = torch.full_like(curr, -1)
    if edge_w != 1.0:
        net = torch.where(total > 0, torch.gather(et_row, 1, pick[:, None])[:, 0], -1)
    return torch.where(total > 0, nxt, curr), row_full, net


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
    tg: TorchGraph, prev: torch.Tensor, curr: torch.Tensor, prev_et: Optional[torch.Tensor],
    return_weight: float, explore_weight: float, max_neighbours: int, node_w: float,
    edge_w: float, generator: torch.Generator, with_edge_type: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One p/q and typed step, exact within the capped neighbourhood: when
    deg(curr) exceeds `max_neighbours` the candidates are a randomly rotated
    window of that many consecutive CSR entries (a fresh rotation per step);
    membership is searched in prev's full CSR row (skipped with p = q = 1);
    the typed factors read `node_type_of` for each candidate and the edge
    type of its arc; then the arc weights, and the inverse-CDF pick clamped
    to the window's last slot. A node of degree 0 keeps the walker. Returns
    (next nodes, the picked arcs' edge types when `with_edge_type`, else -1;
    -1 where the walker had no arc). Plain version of one K19 step."""
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
    if return_weight == 1.0 and explore_weight == 1.0:
        w = torch.ones((b, m), device=dev)
    else:
        is_common = csr_edge_ids_plain(
            tg.row_ptr, tg.col_idx, prev[:, None].expand(b, m).reshape(-1),
            cands.reshape(-1))[1].reshape(b, m)
        w = _pq_weights(cands, prev, is_common, return_weight, explore_weight)
    if node_w != 1.0:
        w = w * _node_factor(tg.node_type_of[cands], tg.node_type_of[curr], node_w)
    cand_et = tg.edge_types[idx].long() if with_edge_type or edge_w != 1.0 else None
    if edge_w != 1.0:
        w = w * _edge_factor(cand_et, prev_et, edge_w)
    if tg.weights is not None:
        w = w * tg.weights[idx]
    w = torch.where(valid, w, 0.0)
    cdf = torch.cumsum(w, dim=1)
    u = torch.rand((b,), generator=generator, device=dev) * cdf[:, -1]
    pick = torch.minimum((cdf <= u[:, None]).sum(dim=1), (deg - 1).clamp(min=0))
    nxt = torch.where(deg > 0, torch.gather(cands, 1, pick[:, None])[:, 0], curr)
    net = torch.full_like(curr, -1)
    if with_edge_type:
        net = torch.where(deg > 0, torch.gather(cand_et, 1, pick[:, None])[:, 0], -1)
    return nxt, net


def ell_walks_plain(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, cap: int,
    generator: torch.Generator, node_w: float = 1.0, edge_w: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of K9: the first step first-order from the
    start's whole ELL row, times the node factor (the edge type it takes is
    -1 where it stays), then a Python loop of ELL steps that carries the
    previous node's row and the previous arc's edge type."""
    cols = [starts.long()]
    et = torch.full_like(cols[0], -1)
    if walk_length > 1:
        s = cols[0]
        extra = None if node_w == 1.0 else _node_factor(tg.ell_ntypes[s], tg.node_type_of[s],
                                                        node_w)
        nxt, pick = _sample_from_ell_row(tg.ell_cols[s], None if tg.ell_w is None else tg.ell_w[s],
                                         s, generator, extra)
        if edge_w != 1.0:
            et = torch.where(nxt != s, torch.gather(tg.ell_etypes[s].long(), 1,
                                                    pick[:, None])[:, 0], -1)
        row = tg.ell_cols[s]
        cols.append(nxt)
    for _ in range(walk_length - 2):
        nxt, row, et = _second_order_step_ell(tg, cols[-2], row, cols[-1], et, return_weight,
                                              explore_weight, cap, node_w, edge_w, generator)
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
    generator: torch.Generator, node_w: float = 1.0, edge_w: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of K19. Typed walks (a factor other than 1)
    take a first exact step with p = q = 1 and the node factor, and carry
    the picked arcs' edge types when the edge factor is on; untyped walks
    take a first-order first step. Then a Python loop of exact steps."""
    with_et = edge_w != 1.0
    cols = [starts.long()]
    et = torch.full_like(cols[0], -1)
    if walk_length > 1:
        if node_w != 1.0 or with_et:
            nxt, et = _second_order_step_exact(tg, cols[0], cols[0], et, 1.0, 1.0,
                                               max_neighbours, node_w, 1.0, generator, with_et)
        else:
            nxt = _sample_neighbor(tg, cols[0], generator)
        cols.append(nxt)
    for _ in range(walk_length - 2):
        nxt, et = _second_order_step_exact(tg, cols[-2], cols[-1], et, return_weight,
                                           explore_weight, max_neighbours, node_w, edge_w,
                                           generator, with_et)
        cols.append(nxt)
    return torch.stack(cols, dim=1).to(torch.int32)


def _type_tables(tg: TorchGraph, node_w: float, edge_w: float, ell: bool):
    """(slot node types or node types, slot edge types or edge types) for
    the factors other than 1, checked as the kernels take them: [N, ell_cap]
    ELL slot tables and `node_type_of` when `ell`, else `node_type_of` and
    the arcs' `edge_types`; None for a factor of 1."""
    dev = tg.device
    nt = et = None
    if node_w != 1.0:
        need = ("node_type_of", "ell_ntypes") if ell else ("node_type_of",)
        for name in need:
            if getattr(tg, name) is None:
                raise ValueError(f"change_node_type_weight={node_w} needs {name}: export "
                                 "the graph with node types and with_walk_types=True.")
        _build.check(tg.node_type_of, "node_type_of", torch.int32, (tg.n_nodes,), dev)
        nt = tg.ell_ntypes if ell else tg.node_type_of
    if edge_w != 1.0:
        name = "ell_etypes" if ell else "edge_types"
        if getattr(tg, name) is None:
            raise ValueError(f"change_edge_type_weight={edge_w} needs {name}: export "
                             "the graph with edge types and with_walk_types=True.")
        et = getattr(tg, name)
    if ell:
        for name, t in (("ell_ntypes", nt), ("ell_etypes", et)):
            _build.check(t, name, torch.int32, (tg.n_nodes, tg.ell_cap), dev)
    else:
        _build.check(et, "edge_types", torch.int32, (tg.n_arcs,), dev)
    return nt, et


def _launch_ell(counter, tg: TorchGraph, starts: torch.Tensor, walk_length: int,
                return_weight: float, explore_weight: float, cap: int,
                generator: torch.Generator, node_w: float = 1.0, edge_w: float = 1.0,
                ntypes=None, etypes=None, clocks=None, defines=()) -> torch.Tensor:
    """Check the inputs and launch K9 once (its typed instantiation when a
    slot type table, `_type_tables`, is given); returns the walks."""
    dev = tg.device
    b = starts.shape[0]
    _build.check(starts, "starts", torch.int32, (b,), dev)
    _build.check(tg.ell_cols, "ell_cols", torch.int32, (tg.n_nodes, tg.ell_cap), dev)
    _build.check(tg.ell_w, "ell_w", torch.float32, (tg.n_nodes, tg.ell_cap), dev)
    walks = torch.empty((b, walk_length), dtype=torch.int32, device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        counter, "ebt_ell_walks", dev, tg.ell_cols.data_ptr(),
        _build.ptr(tg.ell_w), _build.ptr(ntypes), _build.ptr(etypes),
        _build.ptr(tg.node_type_of if ntypes is not None else None), float(node_w),
        float(edge_w), tg.ell_cap, min(cap, tg.ell_cap), starts.data_ptr(),
        walks.data_ptr(), b, walk_length, float(return_weight),
        float(explore_weight), seed, offset, _build.ptr(clocks), defines=defines,
    )
    return walks


def ell_walks(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, cap: int,
    generator: torch.Generator, node_w: float = 1.0, edge_w: float = 1.0,
) -> torch.Tensor:
    """[B, walk_length] int32 p/q walks over the graph's ELL table, with
    candidates capped at min(cap, ell_cap), and the typed factors `node_w`
    (change_node_type_weight) and `edge_w` (change_edge_type_weight), which
    need the ELL type tables when they are not 1. Kernel K9 on a CUDA graph
    (counted as `ell_walks_typed` when a factor is not 1), the plain version
    on a CPU graph. K9 holds a walker's two rows in shared memory, and its
    rows of arc weights, slot node types and slot edge types when the graph
    is weighted and the factors are on: 8 bytes a slot, 4 more for each of
    those, so its rows may be up to about 29,000 slots wide (19,000
    weighted; 11,600 weighted with both factors) on the H100."""
    if tg.ell_cols is None:
        raise ValueError("ell_walks needs a graph exported with ell_cap.")
    if walk_length < 1:
        raise ValueError(f"walk_length must be positive, got {walk_length}.")
    ntypes, etypes = _type_tables(tg, node_w, edge_w, ell=True)
    if not _build.is_cuda(tg.col_idx):
        return ell_walks_plain(tg, starts, walk_length, return_weight,
                               explore_weight, cap, generator, node_w, edge_w)
    typed = node_w != 1.0 or edge_w != 1.0
    return _launch_ell("ell_walks_typed" if typed else "ell_walks", tg, starts, walk_length,
                       return_weight, explore_weight, cap, generator, node_w, edge_w,
                       ntypes, etypes)


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


def exact_walks(
    tg: TorchGraph, starts: torch.Tensor, walk_length: int,
    return_weight: float, explore_weight: float, max_neighbours: int,
    generator: torch.Generator, node_w: float = 1.0, edge_w: float = 1.0,
) -> torch.Tensor:
    """[B, walk_length] int32 walks of the exact sampler over rotated
    windows of `max_neighbours` CSR entries, with the typed factors
    `node_w` and `edge_w` (which need `node_type_of` and the arcs'
    `edge_types` when they are not 1). Kernel K19 on a CUDA graph, the plain
    version on a CPU graph."""
    if walk_length < 1:
        raise ValueError(f"walk_length must be positive, got {walk_length}.")
    if max_neighbours < 1:
        raise ValueError(f"max_neighbours must be positive, got {max_neighbours}.")
    node_type_of, edge_types = _type_tables(tg, node_w, edge_w, ell=False)
    if not _build.is_cuda(tg.col_idx):
        return exact_walks_plain(tg, starts, walk_length, return_weight, explore_weight,
                                 max_neighbours, generator, node_w, edge_w)
    dev = tg.device
    b = starts.shape[0]
    _build.check(starts, "starts", torch.int32, (b,), dev)
    _build.check(tg.weights, "weights", torch.float32, (tg.n_arcs,), dev)
    walks = torch.empty((b, walk_length), dtype=torch.int32, device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "exact_walks", "ebt_exact_walks", dev, tg.row_ptr.data_ptr(),
        tg.col_idx.data_ptr(), _build.ptr(tg.weights), _build.ptr(tg.alias_prob),
        _build.ptr(tg.alias_idx), _build.ptr(edge_types), _build.ptr(node_type_of),
        starts.data_ptr(), walks.data_ptr(), b, walk_length, max_neighbours,
        float(return_weight), float(explore_weight), float(node_w), float(edge_w),
        seed, offset,
    )
    return walks


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
    """[B, walk_length] int32 walks starting at `start_nodes`, routed as
    the JAX version routes them. The node factor applies only when the
    graph exports node types (`node_type_of`), the edge factor only when it
    has edge types; otherwise they are inert. Untyped walks with p = q = 1
    are first-order (K1). Else, with the candidate cap `max_neighbours`
    (default 100): K9 when the graph carries an ELL table covering
    min(cap, max degree), and its type tables for the active factors; else
    K19, the exact sampler, for typed walks, a weight ratio above 16 or
    `exact_pq`; else K10 (8 tries up to ratio 4, 16 above)."""
    node_w = (change_node_type_weight
              if change_node_type_weight != 1.0 and tg.node_type_of is not None else 1.0)
    edge_w = (change_edge_type_weight
              if change_edge_type_weight != 1.0 and tg.edge_types is not None else 1.0)
    typed = node_w != 1.0 or edge_w != 1.0
    if return_weight == 1.0 and explore_weight == 1.0 and not typed:
        return first_order_walks(tg, start_nodes, walk_length, generator)
    cap = max_neighbours if max_neighbours is not None else 100
    if (not exact_pq and tg.ell_cols is not None
            and tg.ell_cap >= min(cap, max(tg.max_degree, 1))
            and (node_w == 1.0 or tg.ell_ntypes is not None)
            and (edge_w == 1.0 or tg.ell_etypes is not None)):
        return ell_walks(tg, start_nodes, walk_length, return_weight,
                         explore_weight, cap, generator, node_w, edge_w)
    ratio = (max(return_weight, 1.0, explore_weight)
             / max(min(return_weight, 1.0, explore_weight), 1e-9))
    if exact_pq or typed or ratio > 16.0:
        return exact_walks(tg, start_nodes, walk_length, return_weight,
                           explore_weight, cap, generator, node_w, edge_w)
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
    max_neighbours: Optional[int] = None, change_node_type_weight: float = 1.0,
    change_edge_type_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walks from each start node `iterations` times, cut into
    `skipgram_pairs`."""
    walks = random_walks(tg, start_nodes.repeat(iterations), walk_length, generator,
                         return_weight=return_weight, explore_weight=explore_weight,
                         max_neighbours=max_neighbours,
                         change_node_type_weight=change_node_type_weight,
                         change_edge_type_weight=change_edge_type_weight)
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
        col_idx.shape[0], row_ptr.shape[0] - 1, _build.ptr(ids), found.data_ptr(),
    )
    return ids, found


def csr_has_edges(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """[B] bool: is (src[i], dst[i]) an arc? K5 without the ids."""
    return csr_edge_ids(row_ptr, col_idx, src, dst, with_ids=False)[1]
