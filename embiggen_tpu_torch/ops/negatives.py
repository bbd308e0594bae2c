"""Node draws for negative sampling, the GCN edge minibatch and the edge and
triple batches of the minibatch embedders — counterpart of
`embiggen_tpu/ops/negatives.py` (`sample_nodes_scale_free`,
`sample_nodes_uniform`, `negative_nodes_for_nce`; `arc_sources`,
`edge_prediction_mini_batch`, `siamese_mini_batch`) and of LINE's sampler
`embiggen_tpu/models/embedders/line.py::_LINEBase._sample_batch`.

The head of a uniformly random arc is exactly degree-distributed, so a
scale-free draw is one uniform arc id and one gather. On a CUDA graph the
node draws are kernel K2 (`csrc/sampling.cu`), the edge minibatch kernel K6
(`csrc/edges.cu`) and the siamese and LINE batches kernel K14
(`csrc/batches.cu`); on a CPU graph the plain versions below.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..graph.graph import TorchGraph
from . import _build
from .walks import csr_edge_ids_plain


def nce_negatives_plain(
    tg: TorchGraph, generator: torch.Generator, shape: Tuple[int, ...],
    scale_free: bool,
) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    if scale_free:
        arc = torch.randint(0, max(tg.n_arcs, 1), shape, generator=generator,
                            device=tg.device)
        return tg.col_idx[arc]
    return torch.randint(0, tg.n_nodes, shape, generator=generator,
                         device=tg.device, dtype=torch.int32)


def nce_negatives(
    tg: TorchGraph, generator: torch.Generator, shape: Tuple[int, ...],
    scale_free: bool = True,
) -> torch.Tensor:
    """int32 node ids of `shape`: degree-proportional (`scale_free`) or
    uniform. Kernel K2 on a CUDA graph (Philox seeded from `generator`), the
    plain version on a CPU graph."""
    shape = tuple(int(s) for s in shape)
    if not _build.is_cuda(tg.col_idx):
        return nce_negatives_plain(tg, generator, shape, scale_free)
    if scale_free and tg.n_arcs == 0:
        raise ValueError("Scale-free draws need a graph with arcs.")
    out = torch.empty(shape, dtype=torch.int32, device=tg.device)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "nce_negatives", "ebt_node_draws", tg.device,
        tg.col_idx.data_ptr() if scale_free else None, tg.n_arcs, tg.n_nodes,
        out.data_ptr(), out.numel(), seed, offset,
    )
    return out


def sample_nodes_scale_free(
    tg: TorchGraph, generator: torch.Generator, shape
) -> torch.Tensor:
    """Degree-proportional node sample: head of a uniform random arc."""
    return nce_negatives(tg, generator, shape, scale_free=True)


def sample_nodes_uniform(
    tg: TorchGraph, generator: torch.Generator, shape
) -> torch.Tensor:
    return nce_negatives(tg, generator, shape, scale_free=False)


def negative_nodes_for_nce(
    tg: TorchGraph,
    generator: torch.Generator,
    n_negatives: int,
    use_scale_free_distribution: bool = True,
    per_walk: int = 0,
) -> torch.Tensor:
    """Negatives for an NCE step: [n_negatives] shared, or
    [per_walk, n_negatives] with one set per walk when `per_walk` > 0 (the
    regime SkipGram trains in: each walk's centres contrast against their
    own draws)."""
    shape = (per_walk, n_negatives) if per_walk else (n_negatives,)
    return nce_negatives(tg, generator, shape, use_scale_free_distribution)


def arc_sources(tg: TorchGraph, arc: torch.Tensor) -> torch.Tensor:
    """Source node of each arc id: a gather when the graph was exported
    `with_sources`, else a search over row_ptr."""
    if tg.sources is not None:
        return tg.sources[arc.long()]
    return (torch.searchsorted(tg.row_ptr, arc.to(tg.row_ptr.dtype), right=True)
            - 1).to(torch.int32)


def edge_prediction_mini_batch_plain(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    negative_samples_rate: float = 0.5, use_scale_free_distribution: bool = True,
    avoid_false_negatives: bool = True, n_attempts: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: the reference's rounds, each a full
    membership sweep over all negatives."""
    n_neg = int(round(batch_size * negative_samples_rate))
    n_pos = batch_size - n_neg
    dev = tg.device
    arc = torch.randint(0, max(tg.n_arcs, 1), (n_pos,), generator=generator,
                        device=dev)
    pos_src, pos_dst = arc_sources(tg, arc), tg.col_idx[arc]

    def sample_neg():
        return tuple(
            nce_negatives_plain(tg, generator, (n_neg,), use_scale_free_distribution)
            for _ in range(2))

    src, dst = sample_neg()
    if avoid_false_negatives:
        for _ in range(n_attempts):
            bad = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst)[1] | (src == dst)
            new_src, new_dst = sample_neg()
            src = torch.where(bad, new_src, src)
            dst = torch.where(bad, new_dst, dst)
    labels = torch.cat([torch.ones(n_pos, device=dev), torch.zeros(n_neg, device=dev)])
    return (torch.cat([pos_src, src]).to(torch.int32),
            torch.cat([pos_dst, dst]).to(torch.int32), labels)


def edge_prediction_mini_batch(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    negative_samples_rate: float = 0.5, use_scale_free_distribution: bool = True,
    avoid_false_negatives: bool = True, n_attempts: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sources [B] int32, destinations [B] int32, labels [B] f32): the first
    B - n_neg slots are uniform arcs (label 1), the last
    n_neg = round(B * negative_samples_rate) negatives (label 0) with
    scale-free (or uniform) endpoints. With `avoid_false_negatives`, a
    negative that is an arc or a self-loop is redrawn up to `n_attempts`
    times; the last redraw is kept unchecked. Kernel K6 on a CUDA graph
    (Philox seeded from `generator`), the plain version on a CPU graph."""
    if not _build.is_cuda(tg.col_idx):
        return edge_prediction_mini_batch_plain(
            tg, generator, batch_size, negative_samples_rate,
            use_scale_free_distribution, avoid_false_negatives, n_attempts)
    if tg.n_arcs == 0:
        raise ValueError("The edge minibatch needs a graph with arcs.")
    n_neg = int(round(batch_size * negative_samples_rate))
    dev = tg.device
    out_src = torch.empty((batch_size,), dtype=torch.int32, device=dev)
    out_dst = torch.empty((batch_size,), dtype=torch.int32, device=dev)
    labels = torch.empty((batch_size,), dtype=torch.float32, device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "edge_prediction_mini_batch", "ebt_edge_minibatch", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), _build.ptr(tg.sources),
        tg.n_nodes, tg.n_arcs, batch_size - n_neg, batch_size,
        int(use_scale_free_distribution),
        n_attempts if avoid_false_negatives else 0,
        out_src.data_ptr(), out_dst.data_ptr(), labels.data_ptr(), seed, offset,
    )
    return out_src, out_dst, labels


def siamese_mini_batch_plain(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    use_scale_free_distribution: bool = True, with_edge_types: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K14's siamese batch."""
    dev = tg.device
    arc = torch.randint(0, max(tg.n_arcs, 1), (batch_size,), generator=generator,
                        device=dev)
    src = arc_sources(tg, arc).to(torch.int32)
    dst = tg.col_idx[arc]
    node = nce_negatives_plain(tg, generator, (batch_size,), use_scale_free_distribution)
    corrupt_src = torch.randint(0, 2, (batch_size,), generator=generator,
                                device=dev).bool()
    out = (src, dst, torch.where(corrupt_src, node, src),
           torch.where(corrupt_src, dst, node))
    if with_edge_types:
        out += (tg.edge_types[arc] if tg.edge_types is not None
                else torch.zeros(batch_size, dtype=torch.int32, device=dev),)
    return out


def siamese_mini_batch(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    use_scale_free_distribution: bool = True, with_edge_types: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """(src, dst, corrupted_src, corrupted_dst[, edge_type]), each [B] int32:
    uniform arcs, each with one side replaced by a scale-free (or uniform)
    node, the side chosen by a fair coin; with `with_edge_types`, the arc's
    edge type (0 on a graph without types). Kernel K14 on a CUDA graph
    (Philox seeded from `generator`), the plain version on a CPU graph."""
    if not _build.is_cuda(tg.col_idx):
        return siamese_mini_batch_plain(tg, generator, batch_size,
                                        use_scale_free_distribution, with_edge_types)
    if tg.n_arcs == 0:
        raise ValueError("The siamese batch needs a graph with arcs.")
    dev = tg.device
    out = tuple(torch.empty((batch_size,), dtype=torch.int32, device=dev)
                for _ in range(5 if with_edge_types else 4))
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "siamese_mini_batch", "ebt_siamese_batch", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), _build.ptr(tg.sources),
        _build.ptr(tg.edge_types), tg.n_nodes, tg.n_arcs, batch_size,
        int(use_scale_free_distribution), *(t.data_ptr() for t in out[:4]),
        out[4].data_ptr() if with_edge_types else None, seed, offset,
    )
    return out


def line_mini_batch_plain(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    number_of_negative_samples: int, use_scale_free_distribution: bool = True,
    avoid_false_negatives: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K14's LINE batch: the reference's draws, a
    full membership sweep and one redraw of the whole [B, K] block."""
    arc = torch.randint(0, max(tg.n_arcs, 1), (batch_size,), generator=generator,
                        device=tg.device)
    src = arc_sources(tg, arc).to(torch.int32)
    dst = tg.col_idx[arc]
    shape = (batch_size, number_of_negative_samples)
    neg = nce_negatives_plain(tg, generator, shape, use_scale_free_distribution)
    if avoid_false_negatives:
        bad = csr_edge_ids_plain(tg.row_ptr, tg.col_idx,
                                 src[:, None].expand(shape).reshape(-1),
                                 neg.reshape(-1))[1].reshape(shape)
        redraw = nce_negatives_plain(tg, generator, shape, use_scale_free_distribution)
        neg = torch.where(bad, redraw, neg)
    return src, dst, neg


def line_mini_batch(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    number_of_negative_samples: int, use_scale_free_distribution: bool = True,
    avoid_false_negatives: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src [B], dst [B], neg [B, K]) int32: uniform arcs, each with K
    scale-free (or uniform) negatives. With `avoid_false_negatives`, a
    negative that is an arc of its src is redrawn once and the redraw is
    kept unchecked (self-loops are not checked). Kernel K14 on a CUDA graph
    (Philox seeded from `generator`), the plain version on a CPU graph."""
    if not _build.is_cuda(tg.col_idx):
        return line_mini_batch_plain(tg, generator, batch_size, number_of_negative_samples,
                                     use_scale_free_distribution, avoid_false_negatives)
    if tg.n_arcs == 0:
        raise ValueError("The LINE batch needs a graph with arcs.")
    dev = tg.device
    src = torch.empty((batch_size,), dtype=torch.int32, device=dev)
    dst = torch.empty((batch_size,), dtype=torch.int32, device=dev)
    neg = torch.empty((batch_size, number_of_negative_samples), dtype=torch.int32,
                      device=dev)
    seed, offset = _build.draw_seed(generator)
    _build.launch(
        "line_mini_batch", "ebt_line_batch", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), _build.ptr(tg.sources),
        tg.n_nodes, tg.n_arcs, batch_size, number_of_negative_samples,
        int(use_scale_free_distribution), int(avoid_false_negatives),
        src.data_ptr(), dst.data_ptr(), neg.data_ptr(), seed, offset,
    )
    return src, dst, neg
