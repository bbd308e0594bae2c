"""Edge-partitioned SpMM — counterpart of `embiggen_tpu/parallel/spmm.py`
(`partition_coo`, `sharded_spmm`).

The kernel's arcs are cut into P equal slices; rank p holds slice p as a
CSR over all N output rows (`edge_shard_kernel`, built once on the host),
the features are replicated, and each rank's partial product (K17b: K7's
kernel on the shard's CSR, counted under "sharded_spmm") is summed over the
mesh with one all-reduce of [N, D].
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..ops.spmm import CSRKernel, csr_kernel, csr_spmm
from .mesh import Mesh, all_reduce


def partition_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the COO arrays to a multiple of n_shards (zero-weight self arcs
    on row 0) so each rank receives an equal slice."""
    e = len(rows)
    pad = (-e) % n_shards
    if pad:
        rows = np.concatenate([rows, np.zeros(pad, rows.dtype)])
        cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
        vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    return rows, cols, vals


def edge_shard_kernel(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_nodes: int,
    n_shards: int, shard: int, device: Union[str, torch.device] = "cuda",
) -> CSRKernel:
    """The CSR of slice `shard` of the padded COO (`partition_coo`), over
    all `n_nodes` output rows, on `device`."""
    rows, cols, vals = partition_coo(np.asarray(rows), np.asarray(cols), np.asarray(vals),
                                     n_shards)
    per = len(rows) // n_shards
    sl = slice(shard * per, (shard + 1) * per)
    return csr_kernel(rows[sl], cols[sl], vals[sl], n_nodes, device=device,
                      with_transpose=False)


def sharded_spmm(mesh: Mesh, kernel: CSRKernel, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x with A's arcs sharded over the mesh (this rank's slice
    is `kernel`) and x [N, D] replicated: the partial product, then its sum
    over the ranks."""
    return all_reduce(csr_spmm(kernel, x, counter="sharded_spmm"), mesh)
