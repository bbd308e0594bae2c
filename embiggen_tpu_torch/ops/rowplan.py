"""Row plans: the long rows of a CSR cut into chunks that separate warps
take, for the kernels that give a row one warp or one group of lanes (K7's
SpMM, K16a's hop launch).

A warp that walks a hub's 65,536 arcs alone outlasts the rest of its
launch. With a plan, the launch runs one work item per chunk of `split`
arcs of each long row first (so the long rows start first and do not form
the tail), writing a partial result per chunk into a workspace, then the
short rows as before; a second launch takes each long row's partials in
chunk order. Rows of at most `split` arcs are not in the plan, so a graph
without long rows has an empty plan and its launch is unchanged.
"""
from __future__ import annotations

import dataclasses

import torch

# The split a launch takes without a plan: no row is longer.
NO_SPLIT = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The rows of a CSR with more than `split` arcs, each cut into chunks
    of `split` arcs (the last one shorter), in CSR order."""

    split: int
    rows: torch.Tensor          # [L] int32, the long rows, ascending
    chunk_ptr: torch.Tensor     # [L + 1] int32: rows[i]'s chunks are chunk_ptr[i]:chunk_ptr[i + 1]
    chunk_rows: torch.Tensor    # [C] int32, the row of each chunk
    chunk_starts: torch.Tensor  # [C] int32, the first arc of each chunk

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_rows.shape[0])

    def owners(self) -> torch.Tensor:
        """[C] int64 index into `rows` of each chunk's row."""
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.chunk_ptr.device),
            (self.chunk_ptr[1:] - self.chunk_ptr[:-1]).long())

    def to(self, device) -> "RowPlan":
        return dataclasses.replace(self, **{f: getattr(self, f).to(device) for f in (
            "rows", "chunk_ptr", "chunk_rows", "chunk_starts")})


def row_plan(row_ptr: torch.Tensor, split: int) -> RowPlan:
    """The plan of the CSR with row pointers `row_ptr` ([n + 1]) at `split`
    arcs a chunk, on `row_ptr`'s device (built on the host and copied when
    `row_ptr` lies on the card: a few host reads, once per CSR)."""
    if split < 1:
        raise ValueError(f"split must be positive, got {split}.")
    device = row_ptr.device
    row_ptr = row_ptr.cpu().long()
    counts = row_ptr[1:] - row_ptr[:-1]
    rows = torch.nonzero(counts > split).flatten()
    per_row = (counts[rows] + split - 1) // split
    chunk_ptr = torch.zeros(rows.shape[0] + 1, dtype=torch.int64)
    torch.cumsum(per_row, 0, out=chunk_ptr[1:])
    chunk_rows = torch.repeat_interleave(rows, per_row)
    within = torch.arange(chunk_rows.shape[0]) - torch.repeat_interleave(chunk_ptr[:-1], per_row)
    chunk_starts = row_ptr[chunk_rows] + split * within
    as32 = lambda t: t.to(torch.int32).to(device)  # noqa: E731
    return RowPlan(split=int(split), rows=as32(rows), chunk_ptr=as32(chunk_ptr),
                   chunk_rows=as32(chunk_rows), chunk_starts=as32(chunk_starts))


def chunk_of_arcs(plan: RowPlan, row_ptr: torch.Tensor) -> torch.Tensor:
    """[E] int64 segment of each arc in the split route: its row for a row
    of at most `split` arcs, n + its chunk for a long row's arc (n rows).
    The plain versions of the split routes reduce over these segments."""
    row_ptr = row_ptr.long()
    dev, n = row_ptr.device, row_ptr.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(n, device=dev), row_ptr[1:] - row_ptr[:-1])
    if plan.n_chunks:
        starts = plan.chunk_starts.long().to(dev)
        lens = torch.minimum(row_ptr[plan.chunk_rows.long().to(dev) + 1] - starts,
                             torch.tensor(plan.split, device=dev))
        owner = torch.repeat_interleave(lens)
        offsets = torch.cumsum(lens, 0) - lens
        seg[starts[owner] + torch.arange(owner.shape[0], device=dev) - offsets[owner]] = n + owner
    return seg
