"""NodeSketch's min-hash race — counterpart of the loop body of
`embiggen_tpu/models/embedders/factorization.py::NodeSketch._fit_transform.run`.

One round, over the arcs (r -> c) of a TorchGraph, with race and noise
[N, D] float32 and sketch [N, D] int32:
- each arc offers the candidate fma(race[c], inv_decay, noise[c]), where
  inv_decay = float32(1) / float32(decay) (`inverse_decay`): the fused
  multiply-add XLA makes of the reference's race[dst] / decay + noise[dst];
- best[r] is the least candidate over r's arcs, and win[r] the smallest
  sketch[c] among the arcs whose candidate equals it;
- a row takes min(race, best), and win as its sketch where best < race.

`sketch_race_step` is kernel K18 (`csrc/nodesketch.cu`) on CUDA tensors:
`sketch_candidates` forms every node's candidates once into a workspace,
then one pass over the arcs gathers them and keeps (best, the head that gave
it) in registers, reading sketch ids only for ties and for the columns the
round lowers. On CPU tensors it is the plain version: two chunked passes
over the arcs, an `index_reduce_` "amin" of the candidates (formed by
`torch.addcmul`, which fuses them as the kernel's `__fmaf_rn` does), then
one of the tied sketch ids. Both equal the reference's rounds exactly.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..graph.graph import TorchGraph
from . import _build
from .bfs import arc_rows

# Arcs per chunk of the plain version's [chunk, D] gathers (three of them,
# race, noise and sketch: about 0.8 GB at this size).
_CHUNK_ELEMENTS = 1 << 26
_NO_WINNER = torch.iinfo(torch.int32).max


def inverse_decay(decay: float) -> float:
    """float32(1) / float32(decay), the factor of the reference's fused
    candidate."""
    return float(np.float32(1.0) / np.float32(decay))


def candidate_pitch(d: int) -> int:
    """Row pitch, in floats, of the candidate workspace: D rounded up to
    whole 32-byte sectors."""
    return -(-d // 8) * 8


def sketch_candidates_plain(race: torch.Tensor, noise: torch.Tensor,
                            inv_decay: float) -> torch.Tensor:
    """Plain PyTorch version of K18's candidate pass: the fused
    fma(race, inv_decay, noise) of every (node, column)."""
    return torch.addcmul(noise, race, torch.tensor(inv_decay, dtype=torch.float32,
                                                   device=race.device))


def sketch_candidates(race: torch.Tensor, noise: torch.Tensor, inv_decay: float,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, D] candidates fma(race, inv_decay, noise). On CUDA tensors K18's
    candidate launch writes them into `out` (an [N, candidate_pitch(D)]
    workspace, allocated when None) and returns its first D columns; the
    plain version on CPU tensors."""
    if not _build.is_cuda(race):
        return sketch_candidates_plain(race, noise, inv_decay)
    dev = race.device
    n, d = race.shape
    pitch = candidate_pitch(d)
    _build.check(race, "race", torch.float32, None, dev)
    _build.check(noise, "noise", torch.float32, (n, d), dev)
    if out is None:
        out = torch.empty((n, pitch), dtype=torch.float32, device=dev)
    _build.check(out, "candidates", torch.float32, (n, pitch), dev)
    if out.data_ptr() % 16:
        raise ValueError("the candidate workspace must be 16-byte aligned.")
    vec4 = d % 4 == 0 and race.data_ptr() % 16 == 0 and noise.data_ptr() % 16 == 0
    _build.launch("sketch_candidates", "ebt_sketch_candidates", dev, race.data_ptr(),
                  noise.data_ptr(), out.data_ptr(), n, d, pitch, inv_decay, int(vec4))
    return out[:, :d]


def _candidates(tg: TorchGraph, race, noise, inv, lo, hi):
    cols = tg.col_idx[lo:hi].long()
    return cols, torch.addcmul(noise[cols], race[cols], inv)


def sketch_race_step_plain(
    tg: TorchGraph, race: torch.Tensor, sketch: torch.Tensor, noise: torch.Tensor,
    inv_decay: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K18: the least candidate per row, then the
    least sketch id among the arcs that reached it, each an `index_reduce_`
    "amin" over chunks of arcs."""
    rows = arc_rows(tg).long()
    inv = torch.tensor(inv_decay, dtype=torch.float32, device=race.device)
    chunk = max(1, _CHUNK_ELEMENTS // max(race.shape[1], 1))
    spans = [(i, min(i + chunk, tg.n_arcs)) for i in range(0, tg.n_arcs, chunk)]
    best = torch.full_like(race, float("inf"))
    for lo, hi in spans:
        _, cand = _candidates(tg, race, noise, inv, lo, hi)
        best.index_reduce_(0, rows[lo:hi], cand, "amin", include_self=True)
    win = torch.full_like(sketch, _NO_WINNER)
    for lo, hi in spans:
        cols, cand = _candidates(tg, race, noise, inv, lo, hi)
        tied = torch.where(cand == best[rows[lo:hi]], sketch[cols], _NO_WINNER)
        win.index_reduce_(0, rows[lo:hi], tied, "amin", include_self=True)
    improved = best < race
    return torch.minimum(race, best), torch.where(improved, win, sketch)


def sketch_race_step(
    tg: TorchGraph, race: torch.Tensor, sketch: torch.Tensor, noise: torch.Tensor,
    inv_decay: float, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    workspace: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(race, sketch) after one round of the race along the arcs of `tg`.
    Kernel K18 on CUDA tensors, its two launches (into `out`, a (race,
    sketch) pair, and the candidates into `workspace`, an [N,
    candidate_pitch(D)] float32 tensor, when given), the plain version on
    CPU tensors."""
    if not _build.is_cuda(race):
        return sketch_race_step_plain(tg, race, sketch, noise, inv_decay)
    dev = race.device
    n, d = race.shape
    if n != tg.n_nodes:
        raise ValueError(f"race has {n} rows for {tg.n_nodes} nodes.")
    _build.check(race, "race", torch.float32, None, dev)
    _build.check(sketch, "sketch", torch.int32, (n, d), dev)
    _build.check(noise, "noise", torch.float32, (n, d), dev)
    _build.check(tg.row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    _build.check(tg.col_idx, "col_idx", torch.int32, None, dev)
    if out is None:
        out = (torch.empty_like(race), torch.empty_like(sketch))
    _build.check(out[0], "race out", torch.float32, (n, d), dev)
    _build.check(out[1], "sketch out", torch.int32, (n, d), dev)
    cand = sketch_candidates(race, noise, inv_decay, workspace)
    vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (race, sketch, *out))
    _build.launch(
        "sketch_race_step", "ebt_sketch_race_step", dev, tg.row_ptr.data_ptr(),
        tg.col_idx.data_ptr(), cand.data_ptr(), candidate_pitch(d), race.data_ptr(),
        sketch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n, d, int(vec4),
    )
    return out


def sketch_race(
    tg: TorchGraph, race: torch.Tensor, sketch: torch.Tensor,
    noises: Iterable[torch.Tensor], inv_decay: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(race, sketch) after one round per noise matrix of `noises`, taken
    one at a time. On the card, two pairs of buffers take turns as each
    round's output, beside one candidate workspace for the whole race."""
    race, sketch = race.contiguous(), sketch.contiguous()
    bufs, workspace = [None, None], None
    if _build.is_cuda(race):
        bufs = [(torch.empty_like(race), torch.empty_like(sketch)) for _ in range(2)]
        workspace = torch.empty((race.shape[0], candidate_pitch(race.shape[1])),
                                dtype=torch.float32, device=race.device)
    for i, noise in enumerate(noises):
        race, sketch = sketch_race_step(tg, race, sketch, noise, inv_decay, bufs[i % 2],
                                        workspace)
    return race, sketch
