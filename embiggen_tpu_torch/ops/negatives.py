"""Node draws for negative sampling, the GCN edge minibatch and the edge and
triple batches of the minibatch embedders — counterpart of
`embiggen_tpu/ops/negatives.py` (`sample_nodes_scale_free`,
`sample_nodes_uniform`, `negative_nodes_for_nce`; `arc_sources`,
`edge_prediction_mini_batch`, `siamese_mini_batch`, `edge_chunk`,
`chunk_mask`) and of LINE's sampler
`embiggen_tpu/models/embedders/line.py::_LINEBase._sample_batch`.

The head of a uniformly random arc is exactly degree-distributed, so a
scale-free draw is one uniform arc id and one gather. On a CUDA graph the
node draws are kernel K2 (`csrc/sampling.cu`), the edge minibatch kernel K6
(`csrc/edges.cu`), the siamese and LINE batches kernel K14
(`csrc/batches.cu`) and the arcs of a chunk kernel K20b (`csrc/edges.cu`);
on a CPU graph the plain versions below.

K14 writes each batch into one int32 block, in the layout the steps take.
A fit passes a `BatchDraws` workspace: the block allocated once, and one
Philox key drawn from the fit's generator at its first batch, with each
batch at its own counter offset, so a step makes no host RNG call. The
first-order walk step's batch (uniform starts, walks, per-walk negatives:
`first_order_batch`) is one launch of its own (`csrc/sampling.cu`) into such
a block; K2 takes a workspace's key and offset too, for the steps that
draw once a step, and K6 writes the GCN's edge batch into one
(`BatchDraws.edges`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..graph.graph import TorchGraph
from . import _build
from .walks import csr_edge_ids_plain, first_order_walks_plain, walk_records


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
    scale_free: bool = True, workspace: Optional["BatchDraws"] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int32 node ids of `shape`: degree-proportional (`scale_free`) or
    uniform. Kernel K2 on a CUDA graph (Philox seeded from `generator`, or
    at a fit's `workspace` key and next offset), the plain version on a CPU
    graph. With `out` (int32, of `shape`, on the graph's device) the ids are
    written into it, else into a fresh tensor."""
    shape = tuple(int(s) for s in shape)
    if not _build.is_cuda(tg.col_idx):
        draws = nce_negatives_plain(tg, generator, shape, scale_free)
        return draws if out is None else out.copy_(draws)
    if scale_free and tg.n_arcs == 0:
        raise ValueError("Scale-free draws need a graph with arcs.")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=tg.device)
    else:
        _build.check(out, "out", torch.int32, shape, tg.device)
    seed, offset = (_build.draw_seed(generator) if workspace is None
                    else workspace.seed(generator))
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
    tg: TorchGraph, generator: torch.Generator, shape,
    workspace: Optional["BatchDraws"] = None, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return nce_negatives(tg, generator, shape, False, workspace, out)


def negative_nodes_for_nce(
    tg: TorchGraph,
    generator: torch.Generator,
    n_negatives: int,
    use_scale_free_distribution: bool = True,
    per_walk: int = 0,
    workspace: Optional["BatchDraws"] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Negatives for an NCE step: [n_negatives] shared, or
    [per_walk, n_negatives] with one set per walk when `per_walk` > 0 (the
    regime SkipGram trains in: each walk's centres contrast against their
    own draws). `workspace` and `out` as `nce_negatives` takes them."""
    shape = (per_walk, n_negatives) if per_walk else (n_negatives,)
    return nce_negatives(tg, generator, shape, use_scale_free_distribution, workspace, out)


def first_order_batch_plain(
    tg: TorchGraph, generator: torch.Generator, batch_size: int, iterations: int,
    walk_length: int, number_of_negatives: int, scale_free: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused first-order batch: K2's, K1's and
    K2's plain versions, drawn from `generator` in that order."""
    starts = nce_negatives_plain(tg, generator, (batch_size,), False)
    walks = first_order_walks_plain(tg, starts.repeat(iterations), walk_length, generator)
    negs = nce_negatives_plain(tg, generator, (batch_size * iterations, number_of_negatives),
                               scale_free)
    return walks, negs


def first_order_batch(
    tg: TorchGraph, generator: torch.Generator, batch_size: int, iterations: int,
    walk_length: int, number_of_negatives: int, scale_free: bool = True,
    workspace: Optional["BatchDraws"] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(walks [B·iters, L], negatives [B·iters, K]) int32: the batch of a
    first-order walk step. B starts uniform over the nodes, tiled over the
    iterations (walk b starts where walk b mod B does), a first-order walk
    of `walk_length` nodes from each (uniform or alias-weighted moves; a
    zero-degree node keeps its walker), and K scale-free (or uniform)
    negatives a walk. On a CUDA graph one launch of the fused kernel, a
    step one load of an arc record where the graph carries `walk_arcs`,
    with Philox seeded from `generator` or at the workspace's key and next
    offset; with a `workspace` (`BatchDraws.walks`) both outputs are views
    of its block, overwritten by the next batch. On a CPU graph the plain
    version, which draws exactly as the three separate calls do."""
    if walk_length < 1:
        raise ValueError(f"walk_length must be positive, got {walk_length}.")
    if not _build.is_cuda(tg.col_idx):
        return first_order_batch_plain(tg, generator, batch_size, iterations, walk_length,
                                       number_of_negatives, scale_free)
    if tg.n_nodes == 0 or (scale_free and tg.n_arcs == 0):
        raise ValueError("The first-order batch needs a graph with nodes, and arcs for "
                         "scale-free negatives.")
    dev = tg.device
    shapes = BatchDraws.walk_shapes(batch_size, iterations, walk_length, number_of_negatives)
    if workspace is None:
        walks, negs, _ = _walk_views(
            torch.empty(shapes[-1], dtype=torch.int32, device=dev), *shapes[:2])
        seed, offset = _build.draw_seed(generator)
    else:
        walks, negs, _ = _walk_workspace_views(workspace, shapes, dev)
        seed, offset = workspace.seed(generator)
    _build.launch(
        "first_order_batch", "ebt_first_order_batch", dev, tg.row_ptr.data_ptr(),
        tg.col_idx.data_ptr(), _build.ptr(tg.alias_prob), _build.ptr(tg.alias_idx),
        walk_records(tg), tg.n_nodes, tg.n_arcs, batch_size, walks.shape[0], walk_length,
        number_of_negatives, int(scale_free), walks.data_ptr(), negs.data_ptr(), seed, offset,
    )
    return walks, negs


def arc_sources(tg: TorchGraph, arc: torch.Tensor) -> torch.Tensor:
    """Source node of each arc id: a gather when the graph was exported
    `with_sources`, else a search over row_ptr."""
    if tg.sources is not None:
        return tg.sources[arc.long()]
    return (torch.searchsorted(tg.row_ptr, arc.to(tg.row_ptr.dtype), right=True)
            - 1).to(torch.int32)


def _chunk_positions(tg: TorchGraph, chunk_index: int, chunk_size: int) -> torch.Tensor:
    return chunk_index * chunk_size + torch.arange(chunk_size, device=tg.device)


def edge_chunk_plain(tg: TorchGraph, chunk_index: int,
                     chunk_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K20b's ids."""
    idx = _chunk_positions(tg, chunk_index, chunk_size).clamp_(0, max(tg.n_arcs - 1, 0))
    return arc_sources(tg, idx), tg.col_idx[idx]


def chunk_mask_plain(tg: TorchGraph, chunk_index: int, chunk_size: int) -> torch.Tensor:
    """Plain PyTorch version of K20b's mask."""
    return _chunk_positions(tg, chunk_index, chunk_size) < tg.n_arcs


def _edge_chunk_launch(counter: str, tg: TorchGraph, chunk_index: int, chunk_size: int,
                       with_ids: bool):
    dev = tg.device
    n = int(chunk_size)
    src = dst = mask = None
    if with_ids:
        src, dst = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2))
    else:
        mask = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _build.launch(counter, "ebt_edge_chunk", dev, tg.row_ptr.data_ptr(),
                      tg.col_idx.data_ptr(), _build.ptr(tg.sources), tg.n_nodes, tg.n_arcs,
                      int(chunk_index) * n, n, _build.ptr(src), _build.ptr(dst),
                      _build.ptr(mask))
    return (src, dst) if with_ids else mask


def edge_chunk(tg: TorchGraph, chunk_index: int,
               chunk_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sources, destinations) [chunk_size] int32 of the arcs
    chunk_index * chunk_size + t in CSR order, for inference over all arcs;
    the slots past the last arc repeat it (callers mask with `chunk_mask`).
    An edgeless graph raises TypeError, as the JAX function's gather does.
    Kernel K20b on a CUDA graph, the plain version on a CPU graph."""
    if tg.n_arcs == 0:
        raise TypeError("edge_chunk needs a graph with arcs; this one has none.")
    if not _build.is_cuda(tg.col_idx):
        return edge_chunk_plain(tg, chunk_index, chunk_size)
    return _edge_chunk_launch("edge_chunk", tg, chunk_index, chunk_size, True)


def chunk_mask(tg: TorchGraph, chunk_index: int, chunk_size: int) -> torch.Tensor:
    """[chunk_size] bool: which slots of `edge_chunk`'s chunk are real arcs.
    Kernel K20b without its id outputs on a CUDA graph, the plain version on
    a CPU graph."""
    if not _build.is_cuda(tg.col_idx):
        return chunk_mask_plain(tg, chunk_index, chunk_size)
    return _edge_chunk_launch("chunk_mask", tg, chunk_index, chunk_size, False)


def _avoid_csr(tg: TorchGraph, graph_to_avoid: Optional[TorchGraph]) -> TorchGraph:
    """The graph whose arcs a negative must not be: `graph_to_avoid`, else
    the sampled graph."""
    if graph_to_avoid is None:
        return tg
    if graph_to_avoid.col_idx.device != tg.col_idx.device:
        raise ValueError(f"graph_to_avoid is on {graph_to_avoid.col_idx.device}, the sampled "
                         f"graph on {tg.col_idx.device}.")
    if graph_to_avoid.n_nodes < tg.n_nodes:
        raise ValueError(f"graph_to_avoid has {graph_to_avoid.n_nodes} nodes, fewer than the "
                         f"sampled graph's {tg.n_nodes}.")
    return graph_to_avoid


def edge_prediction_mini_batch_plain(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    negative_samples_rate: float = 0.5, use_scale_free_distribution: bool = True,
    avoid_false_negatives: bool = True, n_attempts: int = 2,
    graph_to_avoid: Optional[TorchGraph] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: the reference's rounds, each a full
    membership sweep over all negatives in `graph_to_avoid` (default: `tg`)."""
    avoid = _avoid_csr(tg, graph_to_avoid)
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
            bad = csr_edge_ids_plain(avoid.row_ptr, avoid.col_idx, src, dst)[1] | (src == dst)
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
    graph_to_avoid: Optional[TorchGraph] = None, workspace: Optional["BatchDraws"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sources [B] int32, destinations [B] int32, labels [B] f32): the first
    B - n_neg slots are uniform arcs (label 1), the last
    n_neg = round(B * negative_samples_rate) negatives (label 0) with
    scale-free (or uniform) endpoints. With `avoid_false_negatives`, a
    negative that is an arc of `graph_to_avoid` (default: `tg`; a graph on
    the same device with at least `tg`'s nodes) or a self-loop is redrawn up
    to `n_attempts` times; the last redraw is kept unchecked. Kernel K6 on a
    CUDA graph (Philox seeded from `generator`, or at the workspace's key and
    next offset; a positive read from the graph's `arc_pairs` where it has
    them), the plain version on a CPU graph. With a `workspace`
    (`BatchDraws.edges`) the sources and destinations are the rows of its
    block, overwritten by the next batch, and the labels its labels, written
    by its first batch and only read after; else fresh tensors."""
    avoid = _avoid_csr(tg, graph_to_avoid)
    n_neg = int(round(batch_size * negative_samples_rate))
    dev = tg.device
    if workspace is not None:
        _check_block(workspace, (2, batch_size), dev)
        if workspace.n_neg != n_neg:
            raise ValueError(f"workspace was made for {workspace.n_neg} negatives of "
                             f"{batch_size}, not {n_neg}.")
    if not _build.is_cuda(tg.col_idx):
        out = edge_prediction_mini_batch_plain(
            tg, generator, batch_size, negative_samples_rate,
            use_scale_free_distribution, avoid_false_negatives, n_attempts, graph_to_avoid)
        if workspace is None:
            return out
        src, dst, labels = workspace.views
        src.copy_(out[0])
        dst.copy_(out[1])
        if not workspace.labels_written:
            labels.copy_(out[2])
            workspace.labels_written = True
        return workspace.views
    if tg.n_arcs == 0:
        raise ValueError("The edge minibatch needs a graph with arcs.")
    if workspace is None:
        out_src, out_dst = torch.empty((2, batch_size), dtype=torch.int32, device=dev)
        labels = torch.empty((batch_size,), dtype=torch.float32, device=dev)
        write_labels = labels
        seed, offset = _build.draw_seed(generator)
    else:
        out_src, out_dst, labels = workspace.views
        write_labels = None if workspace.labels_written else labels
        seed, offset = workspace.seed(generator)
    _build.launch(
        "edge_prediction_mini_batch", "ebt_edge_minibatch", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), _build.ptr(tg.sources),
        _build.ptr(tg.arc_pairs), avoid.row_ptr.data_ptr(), avoid.col_idx.data_ptr(),
        avoid.n_nodes, tg.n_nodes, tg.n_arcs, batch_size - n_neg, batch_size,
        int(use_scale_free_distribution),
        n_attempts if avoid_false_negatives else 0,
        out_src.data_ptr(), out_dst.data_ptr(), _build.ptr(write_labels), seed, offset,
    )
    if workspace is not None:
        workspace.labels_written = True
    return out_src, out_dst, labels


@dataclasses.dataclass
class BatchDraws:
    """A fit's batches (K14's, the walk step's, K2's, K6's): the int32
    `block` each batch is written into, allocated once, and the draws' Philox
    key and the next batch's counter offset. The key is drawn from the fit's
    generator at the first batch on the card; each batch then takes the next
    offset, so batches never share a counter (the kernels' counters hold
    the slot and the offset) and the draws still follow the fit's seed. The
    plain versions draw from the generator and copy into the block."""

    block: torch.Tensor
    key: Optional[int] = None
    # None: the counter offset drawn with the key (the edge batch's).
    offset: Optional[int] = 0
    # Views of the block made once: LINE's (src, dst, neg), a walk step's
    # (walks, negatives, starts), the edge batch's (src, dst, labels).
    views: Tuple[torch.Tensor, ...] = ()
    # The edge batch's negatives a batch, and whether its labels (the third
    # view, beside the block) were written.
    n_neg: int = 0
    labels_written: bool = False

    @classmethod
    def line(cls, batch_size: int, number_of_negative_samples: int, device) -> "BatchDraws":
        """For LINE: [B (2 + K)], src, dst and neg [B, K] one after another."""
        block = torch.empty((batch_size * (2 + number_of_negative_samples),),
                            dtype=torch.int32, device=device)
        return cls(block, views=_line_views(block, batch_size, number_of_negative_samples))

    @classmethod
    def walks(cls, batch_size: int, iterations: int, walk_length: int,
              number_of_negatives: int, device) -> "BatchDraws":
        """For a walk step: walks [B·iters, L], negatives [B·iters, K] and
        starts [B] one after another (the starts for the biased steps)."""
        shapes = cls.walk_shapes(batch_size, iterations, walk_length, number_of_negatives)
        block = torch.empty(shapes[-1], dtype=torch.int32, device=device)
        return cls(block, views=_walk_views(block, *shapes[:2]))

    @staticmethod
    def walk_shapes(batch_size: int, iterations: int, walk_length: int,
                    number_of_negatives: int):
        """(walks, negatives, starts shapes, the block's size) of a walk step."""
        rows = batch_size * iterations
        return ((rows, walk_length), (rows, number_of_negatives), (batch_size,),
                (rows * (walk_length + number_of_negatives) + batch_size,))

    @classmethod
    def edges(cls, batch_size: int, negative_samples_rate: float, device) -> "BatchDraws":
        """For the GCN's edge batch: a [2, B] block, sources then
        destinations, and the [B] labels beside it, written by the first
        batch (n_pos ones, then zeros) and only read after. Its first batch
        on the card takes the key and the counter offset of one draw from
        the fit's generator, so it equals the batch drawn without a
        workspace from the same generator."""
        block = torch.empty((2, batch_size), dtype=torch.int32, device=device)
        labels = torch.empty((batch_size,), dtype=torch.float32, device=device)
        return cls(block, offset=None, views=(block[0], block[1], labels),
                   n_neg=int(round(batch_size * negative_samples_rate)))

    @classmethod
    def siamese(cls, batch_size: int, with_edge_types: bool, device) -> "BatchDraws":
        """For the siamese models: [4, B] rows src, dst, csrc, cdst, and a
        fifth row of edge types with `with_edge_types`."""
        return cls(torch.empty((5 if with_edge_types else 4, batch_size), dtype=torch.int32,
                               device=device))

    def seed(self, generator: torch.Generator) -> Tuple[int, int]:
        """(key, offset) of the next batch on the card."""
        if self.key is None:
            self.key, first = _build.draw_seed(generator)
            if self.offset is None:
                self.offset = first
        out = self.key, self.offset
        self.offset = (self.offset + 1) & 0xFFFFFFFF
        return out


def _line_views(block: torch.Tensor, batch_size: int, k: int):
    return (block[:batch_size], block[batch_size:2 * batch_size],
            block[2 * batch_size:].view(batch_size, k))


def _walk_views(block: torch.Tensor, walks_shape, negs_shape):
    """(walks, negatives, starts) views of a walk step's block."""
    n_walks, n_negs = walks_shape[0] * walks_shape[1], negs_shape[0] * negs_shape[1]
    return (block[:n_walks].view(walks_shape), block[n_walks:n_walks + n_negs].view(negs_shape),
            block[n_walks + n_negs:])


def _walk_workspace_views(workspace: BatchDraws, shapes, device):
    _build.check(workspace.block, "workspace.block", torch.int32, shapes[-1], device)
    got = tuple(tuple(v.shape) for v in workspace.views)
    if got != tuple(shapes[:-1]):
        raise ValueError(f"workspace was made for walks, negatives and starts {got}, "
                         f"not {tuple(shapes[:-1])}.")
    return workspace.views


def _line_workspace_views(workspace: BatchDraws, batch_size: int, k: int, device):
    _build.check(workspace.block, "workspace.block", torch.int32, (batch_size * (2 + k),),
                 device)
    if tuple(workspace.views[2].shape) != (batch_size, k):
        raise ValueError(f"workspace was made for negatives {tuple(workspace.views[2].shape)}, "
                         f"not ({batch_size}, {k}).")
    return workspace.views


def siamese_mini_batch_plain(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    use_scale_free_distribution: bool = True, with_edge_types: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K14's siamese batch."""
    dev = tg.device
    arc = torch.randint(0, max(tg.n_arcs, 1), (batch_size,), generator=generator,
                        device=dev)
    src = arc_sources(tg, arc).to(torch.int32)
    dst = tg.col_idx[arc]
    node = nce_negatives_plain(tg, generator, (batch_size,), use_scale_free_distribution)
    corrupt_src = torch.randint(0, 2, (batch_size,), generator=generator,
                                device=dev).bool()
    out = [src, dst, torch.where(corrupt_src, node, src), torch.where(corrupt_src, dst, node)]
    if with_edge_types:
        out.append(tg.edge_types[arc] if tg.edge_types is not None
                   else torch.zeros(batch_size, dtype=torch.int32, device=dev))
    return torch.stack(out)


def _check_block(workspace: BatchDraws, shape, device) -> torch.Tensor:
    _build.check(workspace.block, "workspace.block", torch.int32, shape, device)
    return workspace.block


def siamese_mini_batch(
    tg: TorchGraph, generator: torch.Generator, batch_size: int,
    use_scale_free_distribution: bool = True, with_edge_types: bool = False,
    workspace: Optional[BatchDraws] = None,
) -> torch.Tensor:
    """[4, B] int32 rows (src, dst, corrupted_src, corrupted_dst): uniform
    arcs, each with one side replaced by a scale-free (or uniform) node, the
    side chosen by a fair coin; with `with_edge_types`, a fifth row with the
    arc's edge type (0 on a graph without types). Kernel K14 on a CUDA graph
    (Philox seeded from `generator`, or at the workspace's key and next
    offset), the plain version on a CPU graph. With a `workspace`
    (`BatchDraws.siamese`) the batch is its block, overwritten by the next
    batch; else a fresh tensor."""
    rows = 5 if with_edge_types else 4
    if not _build.is_cuda(tg.col_idx):
        out = siamese_mini_batch_plain(tg, generator, batch_size,
                                       use_scale_free_distribution, with_edge_types)
        if workspace is None:
            return out
        return _check_block(workspace, (rows, batch_size), tg.device).copy_(out)
    if tg.n_arcs == 0:
        raise ValueError("The siamese batch needs a graph with arcs.")
    dev = tg.device
    if workspace is None:
        out = torch.empty((rows, batch_size), dtype=torch.int32, device=dev)
        seed, offset = _build.draw_seed(generator)
    else:
        out = _check_block(workspace, (rows, batch_size), dev)
        seed, offset = workspace.seed(generator)
    row = out.stride(0) * out.element_size()
    base = out.data_ptr()
    _build.launch(
        "siamese_mini_batch", "ebt_siamese_batch", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), _build.ptr(tg.sources),
        _build.ptr(tg.edge_types), tg.n_nodes, tg.n_arcs, batch_size,
        int(use_scale_free_distribution), base, base + row, base + 2 * row, base + 3 * row,
        base + 4 * row if with_edge_types else None, seed, offset,
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
    avoid_false_negatives: bool = False, workspace: Optional[BatchDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src [B], dst [B], neg [B, K]) int32 (views of one block on the card
    or with a workspace): uniform arcs, each with K scale-free (or uniform)
    negatives. With
    `avoid_false_negatives`, a negative that is an arc of its src is redrawn
    once and the redraw is kept unchecked (self-loops are not checked).
    Kernel K14 on a CUDA graph (Philox seeded from `generator`, or at the
    workspace's key and next offset), the plain version on a CPU graph. With
    a `workspace` (`BatchDraws.line`) the block is its own, overwritten by
    the next batch; else a fresh one."""
    k = number_of_negative_samples
    size = (batch_size * (2 + k),)
    if not _build.is_cuda(tg.col_idx):
        out = line_mini_batch_plain(tg, generator, batch_size, k,
                                    use_scale_free_distribution, avoid_false_negatives)
        if workspace is None:
            return out
        views = _line_workspace_views(workspace, batch_size, k, tg.device)
        for view, t in zip(views, out):
            view.copy_(t)
        return views
    if tg.n_arcs == 0:
        raise ValueError("The LINE batch needs a graph with arcs.")
    dev = tg.device
    if workspace is None:
        src, dst, neg = _line_views(torch.empty(size, dtype=torch.int32, device=dev),
                                    batch_size, k)
        seed, offset = _build.draw_seed(generator)
    else:
        src, dst, neg = _line_workspace_views(workspace, batch_size, k, dev)
        seed, offset = workspace.seed(generator)
    _build.launch(
        "line_mini_batch", "ebt_line_batch", dev,
        tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), _build.ptr(tg.sources),
        tg.n_nodes, tg.n_arcs, batch_size, number_of_negative_samples,
        int(use_scale_free_distribution), int(avoid_false_negatives),
        src.data_ptr(), dst.data_ptr(), neg.data_ptr(), seed, offset,
    )
    return src, dst, neg
