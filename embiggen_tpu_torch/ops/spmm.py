"""Graph-convolution SpMM over a CSR kernel, with its transposed backward —
counterpart of `embiggen_tpu/ops/spmm.py::spmm_padded` (`pad_coo`,
`_spmm_padded_impl`, `_spmm_padded_bwd`).

`csr_kernel` lays a COO kernel out on the host as a `CSRKernel`: row
pointers, columns, weights, the per-row |w| and w² sums of the mean and
sqrtn combiners, and the transposed kernel, all built by a stable counting
sort. `spmm(kernel, x, combiner)` is `out[r] = Σ w·x[c] / den[r]` as a
`torch.autograd.Function` whose backward is the same product over the
transposed kernel, applied to `g / den`; the kernel weights get no
gradient. On CUDA tensors both directions are kernel K7
(`csrc/spmm.cu`); on CPU tensors the plain version below. The TPU layout
(single-K ELLPACK, COO overflow and its v5e cost model) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from . import _build

# Arcs per chunk of the plain version, so its [chunk, D] gather stays
# about 1 GB (the whole [E, D] gather is 10 GB at E = 20M, D = 128).
_CHUNK_ELEMENTS = 1 << 28
COMBINERS = ("sum", "mean", "sqrtn")


@dataclasses.dataclass(frozen=True)
class CSRKernel:
    """A sparse [n_out, n_in] propagation kernel in CSR form on one device."""

    row_ptr: torch.Tensor          # [n_out + 1] int32
    rows: torch.Tensor             # [E] int32, non-decreasing
    cols: torch.Tensor             # [E] int32
    vals: torch.Tensor             # [E] f32
    abs_weight_sum: torch.Tensor   # [n_out] f32, Σ|w| per row (mean)
    sq_weight_sum: torch.Tensor    # [n_out] f32, Σw² per row (sqrtn)
    n_out: int
    n_in: int
    transpose: Optional["CSRKernel"] = None

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_arcs(self) -> int:
        return int(self.cols.shape[0])

    def inverse_denominator(self, combiner: str) -> Optional[torch.Tensor]:
        """[n_out] 1 / den of the combiner, None for "sum"."""
        if combiner == "sum":
            return None
        if combiner == "mean":
            return 1.0 / self.abs_weight_sum.clamp(min=1e-9)
        if combiner == "sqrtn":
            return 1.0 / self.sq_weight_sum.sqrt().clamp(min=1e-9)
        raise ValueError(f"Unknown combiner {combiner!r}")


def _stable_counting_order(keys: np.ndarray) -> np.ndarray:
    """Stable sorting permutation of non-negative int keys below 2^32: an
    LSD radix sort of two 16-bit digits, each digit a counting sort (numpy's
    stable sort of 16-bit keys is a radix sort), so O(E) and not an
    O(E log E) comparison sort."""
    keys = keys.astype(np.uint32)
    order = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    high = (keys >> 16).astype(np.uint16)
    if high.any():
        order = order[np.argsort(high[order], kind="stable")]
    return order


def csr_kernel(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_out: int,
    device: Union[str, torch.device] = "cpu", n_in: Optional[int] = None,
    with_transpose: bool = True,
) -> CSRKernel:
    """Host relayout of a COO kernel (rows need not be sorted; arcs of one
    row keep their order) into a CSRKernel on `device`, with the transposed
    kernel when `with_transpose`."""
    n_in = n_out if n_in is None else int(n_in)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if rows.shape[0] >= 2**31:
        raise ValueError("The kernels index arcs with int32; this kernel has "
                         f"{rows.shape[0]} arcs.")
    if rows.shape[0] and bool((rows[1:] < rows[:-1]).any()):
        order = _stable_counting_order(rows)
        rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_out)
    absw = np.bincount(rows, weights=np.abs(vals), minlength=n_out)
    sqw = np.bincount(rows, weights=vals.astype(np.float64) ** 2, minlength=n_out)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return CSRKernel(
        row_ptr=put(np.concatenate([[0], np.cumsum(counts)]), np.int32),
        rows=put(rows, np.int32),
        cols=put(cols, np.int32),
        vals=put(vals, np.float32),
        abs_weight_sum=put(absw, np.float32),
        sq_weight_sum=put(sqw, np.float32),
        n_out=int(n_out),
        n_in=n_in,
        transpose=(csr_kernel(cols, rows, vals, n_in, device, n_out, False)
                   if with_transpose else None),
    )


def csr_spmm_plain(
    k: CSRKernel, x: torch.Tensor, row_scale: Optional[torch.Tensor] = None,
    col_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K7: gathers and `index_add_` in chunks of
    arcs."""
    d = x.shape[1]
    out = torch.zeros((k.n_out, d), dtype=x.dtype, device=x.device)
    w = k.vals if col_scale is None else k.vals * col_scale[k.cols.long()]
    chunk = max(1, _CHUNK_ELEMENTS // max(d, 1))
    for i in range(0, k.n_arcs, chunk):
        cols = k.cols[i:i + chunk].long()
        out.index_add_(0, k.rows[i:i + chunk].long(), x[cols] * w[i:i + chunk, None])
    return out if row_scale is None else out * row_scale[:, None]


def csr_spmm(
    k: CSRKernel, x: torch.Tensor, row_scale: Optional[torch.Tensor] = None,
    col_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[n_out, D] f32: out[r] = row_scale[r] · Σ_(r, c, w) w · col_scale[c] ·
    x[c] over the arcs of `k` (either scale may be None). Kernel K7 on CUDA
    tensors, the plain version on CPU tensors."""
    if not _build.is_cuda(x):
        return csr_spmm_plain(k, x, row_scale, col_scale)
    dev = x.device
    if x.ndim != 2 or x.shape[0] != k.n_in:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({k.n_in}, D).")
    x = x.contiguous()
    d = x.shape[1]
    _build.check(x, "x", torch.float32, None, dev)
    _build.check(k.vals, "kernel values", torch.float32, None, dev)
    _build.check(row_scale, "row_scale", torch.float32, (k.n_out,), dev)
    _build.check(col_scale, "col_scale", torch.float32, (k.n_in,), dev)
    out = torch.empty((k.n_out, d), dtype=torch.float32, device=dev)
    # float4 loads and stores need every row of x and out 16-byte aligned: a
    # contiguous view at an odd storage offset takes the scalar kernel.
    vec4 = d % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _build.launch(
        "spmm", "ebt_csr_spmm", dev, k.row_ptr.data_ptr(), k.cols.data_ptr(),
        k.vals.data_ptr(), x.data_ptr(), _build.ptr(row_scale),
        _build.ptr(col_scale), out.data_ptr(), k.n_out, d, int(vec4),
    )
    return out


class _SpMM(torch.autograd.Function):
    """y = D⁻¹ A x; dx = Aᵀ D⁻¹ g over the transposed kernel."""

    @staticmethod
    def forward(ctx, x, k: CSRKernel, combiner: str):
        ctx.kernel, ctx.combiner = k, combiner
        return csr_spmm(k, x, row_scale=k.inverse_denominator(combiner))

    @staticmethod
    def backward(ctx, g):
        k = ctx.kernel
        if not ctx.needs_input_grad[0]:
            return None, None, None
        dx = csr_spmm(k.transpose, g.contiguous(),
                      col_scale=k.inverse_denominator(ctx.combiner))
        return dx, None, None


def spmm(k: CSRKernel, x: torch.Tensor, combiner: str = "sum") -> torch.Tensor:
    """[n_out, D] convolution of `x` [n_in, D] by `k` with the `sum`, `mean`
    (÷ Σ|w|) or `sqrtn` (÷ √Σw²) combiner; differentiable in `x` when the
    kernel carries its transpose."""
    if combiner not in COMBINERS:
        raise ValueError(f"Unknown combiner {combiner!r}")
    if x.requires_grad and torch.is_grad_enabled():
        if k.transpose is None:
            raise ValueError("A gradient through spmm needs the kernel's "
                             "transpose (csr_kernel(with_transpose=True)).")
        return _SpMM.apply(x, k, combiner)
    return csr_spmm(k, x, row_scale=k.inverse_denominator(combiner))
