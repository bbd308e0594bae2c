"""Graph-convolution SpMM over a CSR kernel, with its transposed backward —
counterpart of `embiggen_tpu/ops/spmm.py::spmm_padded` (`pad_coo`,
`_spmm_padded_impl`, `_spmm_padded_bwd`) — and the sampled dense-dense
product `sddmm` (`embiggen_tpu/ops/spmm.py::sddmm`).

`csr_kernel` lays a COO kernel out on the host as a `CSRKernel`: row
pointers, columns, weights, the per-row |w| and w² sums of the mean and
sqrtn combiners, and the transposed kernel, all built by a stable counting
sort. `spmm(kernel, x, combiner)` is `out[r] = Σ w·x[c] / den[r]` as a
`torch.autograd.Function` whose backward is the same product over the
transposed kernel, applied to `g / den`; the kernel weights get no
gradient. On CUDA tensors both directions are kernel K7
(`csrc/spmm.cu`); on CPU tensors the plain version below. The TPU layout
(single-K ELLPACK, COO overflow and its v5e cost model) is not ported.
Each kernel and its transpose carry a row plan (`ops/rowplan.py`): rows of
more than SPLIT arcs are cut into chunks that separate warps sum, and a
second launch adds each long row's chunks in order
(`csr_spmm_split_plain` is that route's plain version).

`sddmm(rows, cols, a, b)` is the per-edge score a[rows]·b[cols], a
`torch.autograd.Function`: kernel K20a (`csrc/sddmm.cu`) forward on CUDA
tensors, the plain version on CPU tensors; its backward is two
`index_add_` passes in both cases, as the JAX function has no backward
kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from . import _build
from .rowplan import NO_SPLIT, RowPlan, chunk_of_arcs, row_plan

# Arcs per chunk of the plain version, so its [chunk, D] gather stays
# about 1 GB (the whole [E, D] gather is 10 GB at E = 20M, D = 128).
_CHUNK_ELEMENTS = 1 << 28
COMBINERS = ("sum", "mean", "sqrtn")
# Arcs a chunk of a long row (the row plan cuts every row with more). On
# an H100 (80GB HBM3, 700 W), over the slice graph plus 256 hubs, a
# forward took 4.94, 4.92, 4.91, 4.93 and 4.94 ms at splits of 256, 512,
# 1,024, 2,048 and 4,096 (22.57 unsplit; PERF.md).
SPLIT = 1024


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
    # The rows of more than `plan.split` arcs in chunks (None: no row is
    # split); `csr_kernel` builds it at SPLIT.
    plan: Optional[RowPlan] = None

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
    device: Union[str, torch.device] = "cuda", n_in: Optional[int] = None,
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

    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    return CSRKernel(
        row_ptr=put(row_ptr, np.int32),
        rows=put(rows, np.int32),
        cols=put(cols, np.int32),
        vals=put(vals, np.float32),
        abs_weight_sum=put(absw, np.float32),
        sq_weight_sum=put(sqw, np.float32),
        n_out=int(n_out),
        n_in=n_in,
        transpose=(csr_kernel(cols, rows, vals, n_in, device, n_out, False)
                   if with_transpose else None),
        plan=row_plan(torch.from_numpy(row_ptr), SPLIT).to(device),
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


def spmm_combine_plain(plan: RowPlan, partials: torch.Tensor,
                       row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K7's combine launch: [L, D], each long row's
    chunk partials ([C, D]) summed in chunk order (`index_add_`), times its
    row_scale."""
    out = torch.zeros((plan.n_rows, partials.shape[1]), dtype=partials.dtype,
                      device=partials.device)
    out.index_add_(0, plan.owners(), partials)
    return out if row_scale is None else out * row_scale[plan.rows.long(), None]


def csr_spmm_split_plain(
    k: CSRKernel, x: torch.Tensor, row_scale: Optional[torch.Tensor] = None,
    col_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K7's split route over `k.plan`: each short
    row's sum and each long row's chunk partials (gathers and `index_add_`
    over the arcs' segments, `rowplan.chunk_of_arcs`), then the combine's
    plain version for the long rows, then row_scale."""
    d = x.shape[1]
    n_chunks = 0 if k.plan is None else k.plan.n_chunks
    seg = k.rows.long() if not n_chunks else chunk_of_arcs(k.plan, k.row_ptr)
    sums = torch.zeros((k.n_out + n_chunks, d), dtype=x.dtype, device=x.device)
    w = k.vals if col_scale is None else k.vals * col_scale[k.cols.long()]
    chunk = max(1, _CHUNK_ELEMENTS // max(d, 1))
    for i in range(0, k.n_arcs, chunk):
        sums.index_add_(0, seg[i:i + chunk], x[k.cols[i:i + chunk].long()] * w[i:i + chunk, None])
    out = sums[:k.n_out] if row_scale is None else sums[:k.n_out] * row_scale[:, None]
    if n_chunks:
        out[k.plan.rows.long()] = spmm_combine_plain(k.plan, sums[k.n_out:], row_scale)
    return out


def csr_spmm(
    k: CSRKernel, x: torch.Tensor, row_scale: Optional[torch.Tensor] = None,
    col_scale: Optional[torch.Tensor] = None, counter: str = "spmm",
) -> torch.Tensor:
    """[n_out, D] f32: out[r] = row_scale[r] · Σ_(r, c, w) w · col_scale[c] ·
    x[c] over the arcs of `k` (either scale may be None). Kernel K7 on CUDA
    tensors (counted under `counter`; with a row plan that has chunks, its
    combine launch follows, counted under "spmm_combine"), the plain
    version on CPU tensors."""
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
    plan = k.plan if k.plan is not None and k.plan.n_chunks else None
    out = torch.empty((k.n_out, d), dtype=torch.float32, device=dev)
    partials = None
    if plan is not None:
        _build.check(plan.chunk_rows, "the plan's chunk rows", torch.int32, None, dev)
        partials = torch.empty((plan.n_chunks, d), dtype=torch.float32, device=dev)
    # float4 loads and stores need every row of x, out and the partials
    # 16-byte aligned: a contiguous view at an odd storage offset takes the
    # scalar kernel.
    vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, out, partials)
                              if t is not None)
    _build.launch(
        counter, "ebt_csr_spmm", dev, k.row_ptr.data_ptr(), k.cols.data_ptr(),
        k.vals.data_ptr(), x.data_ptr(), _build.ptr(row_scale),
        _build.ptr(col_scale), out.data_ptr(), k.n_out, d, int(vec4),
        *((None, None, 0, NO_SPLIT, None) if plan is None else (
            plan.chunk_rows.data_ptr(), plan.chunk_starts.data_ptr(), plan.n_chunks,
            plan.split, partials.data_ptr())),
    )
    if plan is not None:
        _build.launch("spmm_combine", "ebt_csr_spmm_combine", dev, plan.rows.data_ptr(),
                      plan.chunk_ptr.data_ptr(), plan.n_rows, partials.data_ptr(),
                      _build.ptr(row_scale), out.data_ptr(), d, int(vec4))
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


def sddmm_plain(rows: torch.Tensor, cols: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K20a: both gathers, the product and the sum
    over D, in chunks of edges."""
    n = rows.shape[0]
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    chunk = max(1, _CHUNK_ELEMENTS // max(a.shape[1], 1))
    for i in range(0, n, chunk):
        out[i:i + chunk] = (a[rows[i:i + chunk].long()] * b[cols[i:i + chunk].long()]).sum(-1)
    return out


def sddmm_forward(rows: torch.Tensor, cols: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """[E] f32 a[rows[e]]·b[cols[e]], no gradient: kernel K20a on CUDA
    tensors, the plain version on CPU tensors."""
    if rows.ndim != 1 or cols.shape != rows.shape:
        raise ValueError(f"rows and cols must be [E] alike; got {tuple(rows.shape)} and "
                         f"{tuple(cols.shape)}.")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b must be [N, D] with one D; got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}.")
    if not _build.is_cuda(a):
        return sddmm_plain(rows, cols, a, b)
    dev = a.device
    if rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows has dtype {rows.dtype}, expected int32 or int64.")
    # The kernel takes one id type for both.
    cols = cols.to(rows.dtype)
    a, b = a.contiguous(), b.contiguous()
    for name, t, dtype in (("rows", rows, rows.dtype), ("cols", cols, rows.dtype),
                           ("a", a, torch.float32), ("b", b, torch.float32)):
        _build.check(t, name, dtype, None, dev)
    n, d = rows.shape[0], a.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    # float4 loads need every row of both tables 16-byte aligned: a
    # contiguous view at an odd storage offset takes the scalar route.
    vec4 = d % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    _build.launch("sddmm", "ebt_sddmm", dev, rows.data_ptr(), cols.data_ptr(), a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), n, d, int(rows.dtype == torch.int64), int(vec4))
    return out


class _SDDMM(torch.autograd.Function):
    """s = rowwise(a[rows] * b[cols]); da = index_add(rows, g b[cols]),
    db = index_add(cols, g a[rows])."""

    @staticmethod
    def forward(ctx, a, b, rows, cols):
        ctx.save_for_backward(a, b, rows, cols)
        return sddmm_forward(rows, cols, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b, rows, cols = ctx.saved_tensors
        rows_l, cols_l = rows.long(), cols.long()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros_like(a).index_add_(0, rows_l, g[:, None] * b[cols_l])
        if ctx.needs_input_grad[1]:
            db = torch.zeros_like(b).index_add_(0, cols_l, g[:, None] * a[rows_l])
        return da, db, None, None


def sddmm(rows: torch.Tensor, cols: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: per-edge scores a[rows]·b[cols] -> [E]
    f32, differentiable in `a` and `b`."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _SDDMM.apply(a, b, rows, cols)
    return sddmm_forward(rows, cols, a, b)
