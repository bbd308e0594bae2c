"""Halo-exchange node-partitioned SpMM — counterpart of
`embiggen_tpu/parallel/halo.py` (`HaloPartition`, `build_halo_partition`,
`shard_features`, `halo_spmm_local`, `halo_spmm`).

Nodes are cut into P contiguous shards of S = ceil(N / P) rows and the
features live row-sharded: rank p holds rows [p S, (p + 1) S) as its
[S, D] shard. Arcs are cut by output row, so every write is local and only
input rows can be remote. The host builder computes, exactly as the
reference does, the boundary sets B[q -> p] (the rows of shard q that p's
arcs read, sorted), the halo width H = max |B|, the send table `send_idx`
[P, P, H] (send_idx[q, p] = B[q -> p] - q S, 0-padded), `comm_rows` =
Σ|B| and the per-row |w| and w² sums. In place of the reference's
single-K ELL stacks (a TPU layout) each shard keeps one CSR whose columns
are [0, S) for its own rows and S + q H + slot for the halo buffer, and the
CSR's transpose.

`halo_spmm` is a `torch.autograd.Function`. Forward: gather the send rows
(K17d), `all_to_all` the [P, H, D] buffer, then K17a over both tables with
the combiner fused. Backward: K17a over the transposed CSR, the reverse
`all_to_all` of the halo rows' gradients, and their scatter-add into the
owners' rows by `send_idx` (K17c). The exchange buffers are allocated once
per shard and width and reused by every layer and step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import _build
from ..ops.sharded import owned_gather, owned_scatter
from ..ops.spmm import COMBINERS, CSRKernel, csr_kernel, csr_spmm_plain
from .mesh import Mesh, all_to_all


@dataclasses.dataclass
class HaloShard:
    """One shard's device plan: its CSR over [own rows | halo buffer] with
    the transpose, its send rows send_idx[p] flattened [P H] (int32), and
    the combiners' inverse denominators."""

    kernel: CSRKernel
    send_idx: torch.Tensor
    inv_mean: torch.Tensor
    inv_sqrtn: torch.Tensor
    buffers: Dict[Tuple[int, str], torch.Tensor] = dataclasses.field(default_factory=dict)

    def inverse_denominator(self, combiner: str) -> Optional[torch.Tensor]:
        if combiner not in COMBINERS:
            raise ValueError(f"Unknown combiner {combiner!r}")
        return {"sum": None, "mean": self.inv_mean, "sqrtn": self.inv_sqrtn}[combiner]

    def buffer(self, d: int, name: str) -> torch.Tensor:
        """The [P H, d] exchange buffer `name`, made at its first use."""
        key = (d, name)
        if key not in self.buffers:
            self.buffers[key] = torch.empty((self.send_idx.shape[0], d), dtype=torch.float32,
                                            device=self.send_idx.device)
        return self.buffers[key]


@dataclasses.dataclass
class HaloPartition:
    """The host plan of one kernel over P shards (numpy arrays, the
    reference's fields) and the device plans of the shards built."""

    send_idx: np.ndarray        # [P, P, H] local row of q sent to p (0-pad)
    abs_wsum: np.ndarray        # [P, S] per-output-row |w| sums (mean)
    sq_wsum: np.ndarray         # [P, S] per-output-row w² sums (sqrtn)
    boundary: Dict[Tuple[int, int], np.ndarray]   # (q, p) -> B[q -> p]
    n_shards: int
    shard_size: int
    halo_width: int
    n_nodes: int
    comm_rows: int              # Σ|B[q -> p]|, the rows exchanged
    shards: Dict[int, HaloShard]


def halo_shard(rows, cols, vals, n_in: int, send_rows: np.ndarray, abs_wsum: np.ndarray,
               sq_wsum: np.ndarray, device) -> HaloShard:
    """One shard's device plan from its arcs (output rows in [0, S),
    columns in [0, n_in) of [own rows | halo buffer]), its send table [P,
    H] and its rows' |w| and w² sums."""
    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return HaloShard(
        kernel=csr_kernel(rows, cols, vals, abs_wsum.shape[0], device=device, n_in=n_in,
                          with_transpose=True),
        send_idx=put(send_rows.reshape(-1), np.int32),
        inv_mean=put(1.0 / np.maximum(abs_wsum, 1e-9), np.float32),
        inv_sqrtn=put(1.0 / np.maximum(np.sqrt(sq_wsum), 1e-9), np.float32),
    )


def build_halo_partition(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_nodes: int,
    n_shards: int,
    device: Union[str, torch.device] = "cuda",
    shards: Optional[Iterable[int]] = None,
) -> HaloPartition:
    """Partition a COO kernel for `halo_spmm` over `n_shards` ranks, with
    the device plans of `shards` (all by default; a rank builds its own) on
    `device`."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    p = int(n_shards)
    s = -(-n_nodes // p)

    owner_r = rows // s
    owner_c = cols // s
    remote_mask = owner_r != owner_c

    # Boundary sets B[q -> dev]: one sort over the remote arcs' (dev, q,
    # col) keys; each set comes out sorted.
    boundary: Dict[Tuple[int, int], np.ndarray] = {}
    r_keys = (owner_r[remote_mask] * p + owner_c[remote_mask]) * np.int64(
        n_nodes
    ) + cols[remote_mask]
    uniq_keys = np.unique(r_keys)
    u_group = uniq_keys // n_nodes
    u_col = uniq_keys % n_nodes
    for dev in range(p):
        for q in range(p):
            if q == dev:
                continue
            boundary[(q, dev)] = u_col[u_group == dev * p + q]
    halo_width = max(max((len(v) for v in boundary.values()), default=0), 1)
    comm_rows = int(sum(len(v) for v in boundary.values()))

    send_idx = np.zeros((p, p, halo_width), np.int32)
    for (q, dev), b in boundary.items():
        send_idx[q, dev, : len(b)] = (b - q * s).astype(np.int32)

    absw = np.zeros((p, s), np.float32)
    sqw = np.zeros((p, s), np.float32)
    built: Dict[int, HaloShard] = {}
    wanted = set(range(p) if shards is None else shards)
    for dev in range(p):
        mine = owner_r == dev
        r_in = (rows[mine] - dev * s).astype(np.int64)
        absw[dev] = np.bincount(
            r_in, weights=np.abs(vals[mine]), minlength=s
        ).astype(np.float32)
        sqw[dev] = np.bincount(
            r_in, weights=vals[mine] * vals[mine], minlength=s
        ).astype(np.float32)
        if dev not in wanted:
            continue
        # Columns: own rows in [0, S), halo slot q H + k at S + q H + k.
        c_in = cols[mine] - dev * s
        remote = remote_mask[mine]
        cc, qq = cols[mine][remote], owner_c[mine][remote]
        mapped = np.empty(len(cc), np.int64)
        for q in range(p):
            m = qq == q
            if m.any():
                mapped[m] = q * halo_width + np.searchsorted(boundary[(q, dev)], cc[m])
        c_in[remote] = s + mapped
        built[dev] = halo_shard(r_in, c_in, vals[mine], s + p * halo_width, send_idx[dev],
                                absw[dev], sqw[dev], device)
    return HaloPartition(
        send_idx=send_idx, abs_wsum=absw, sq_wsum=sqw, boundary=boundary,
        n_shards=p, shard_size=int(s), halo_width=int(halo_width),
        n_nodes=int(n_nodes), comm_rows=comm_rows, shards=built,
    )


def shard_features(x, part: HaloPartition, mesh: Mesh) -> torch.Tensor:
    """This rank's [S, D] rows of the [N, D] features (zero rows past N),
    on the mesh's device. A tensor's rows are copied where they lie when
    that is the mesh's device; host rows (numpy, or a CPU tensor) are
    moved once."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
    s, lo = part.shard_size, mesh.rank * part.shard_size
    out = torch.zeros((s, x.shape[1]), dtype=torch.float32, device=mesh.device)
    own = x[lo:lo + s]
    out[:own.shape[0]] = own.to(mesh.device, torch.float32)
    return out


# ------------------------------------------------------------------ K17a
def _halo_product_plain(kernel: CSRKernel, x: torch.Tensor, halo: Optional[torch.Tensor],
                        row_scale, col_scale) -> torch.Tensor:
    """Plain PyTorch version of K17a: K7's plain version over the two
    tables concatenated."""
    xcat = x if halo is None else torch.cat([x, halo])
    return csr_spmm_plain(kernel, xcat, row_scale, col_scale)


def _halo_product(kernel: CSRKernel, x: torch.Tensor, halo: Optional[torch.Tensor],
                  row_scale, col_scale, counter: str) -> torch.Tensor:
    """K17a over `kernel` with columns below x's rows reading x and the
    others `halo`; the plain version on CPU tensors."""
    if not _build.is_cuda(x):
        return _halo_product_plain(kernel, x, halo, row_scale, col_scale)
    dev = x.device
    split, d = x.shape
    if split + (0 if halo is None else halo.shape[0]) != kernel.n_in:
        raise ValueError(f"x and halo have {split} and "
                         f"{0 if halo is None else halo.shape[0]} rows; the kernel reads "
                         f"{kernel.n_in}.")
    _build.check(x, "x", torch.float32, (split, d), dev)
    _build.check(halo, "halo", torch.float32, None if halo is None else (halo.shape[0], d), dev)
    _build.check(row_scale, "row_scale", torch.float32, (kernel.n_out,), dev)
    _build.check(col_scale, "col_scale", torch.float32, (kernel.n_in,), dev)
    out = torch.empty((kernel.n_out, d), dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr(), out.data_ptr()] + ([] if halo is None else [halo.data_ptr()])
    vec4 = d % 4 == 0 and all(ptr % 16 == 0 for ptr in ptrs)
    _build.launch(counter, "ebt_halo_spmm", dev, kernel.row_ptr.data_ptr(),
                  kernel.cols.data_ptr(), kernel.vals.data_ptr(), x.data_ptr(),
                  _build.ptr(halo), split, _build.ptr(row_scale), _build.ptr(col_scale),
                  out.data_ptr(), kernel.n_out, d, int(vec4))
    return out


def halo_spmm_local(part: HaloPartition, shard: int, x_local: torch.Tensor,
                    halo: torch.Tensor, combiner: str = "sum") -> torch.Tensor:
    """Shard `shard`'s [S, D] rows of the product from its own rows
    `x_local` [S, D] and the filled halo buffer [P H, D]: K17a's forward on
    CUDA tensors (counted under "halo_spmm"), the plain version on CPU
    tensors."""
    sh = part.shards[shard]
    return _halo_product(sh.kernel, x_local.contiguous(), halo.contiguous(),
                         sh.inverse_denominator(combiner), None, "halo_spmm")


def halo_spmm_local_backward(part: HaloPartition, shard: int, g: torch.Tensor,
                             combiner: str = "sum") -> torch.Tensor:
    """[S + P H, D]: the gradient of shard `shard`'s product with respect
    to its own rows (the first S) and to its halo buffer, from the output
    gradient g [S, D]: K17a over the transposed CSR (counted under
    "halo_spmm_backward"), the plain version on CPU tensors."""
    sh = part.shards[shard]
    return _halo_product(sh.kernel.transpose, g.contiguous(), None, None,
                         sh.inverse_denominator(combiner), "halo_spmm_backward")


def halo_spmm_local_plain(part: HaloPartition, shard: int, x_local: torch.Tensor,
                          halo: torch.Tensor, combiner: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of `halo_spmm_local` on any device."""
    sh = part.shards[shard]
    return _halo_product_plain(sh.kernel, x_local, halo, sh.inverse_denominator(combiner), None)


def halo_spmm_local_backward_plain(part: HaloPartition, shard: int, g: torch.Tensor,
                                   combiner: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of `halo_spmm_local_backward` on any device."""
    sh = part.shards[shard]
    return _halo_product_plain(sh.kernel.transpose, g, None, None,
                               sh.inverse_denominator(combiner))


def exchange_halo(mesh: Mesh, part: HaloPartition, x_local: torch.Tensor) -> torch.Tensor:
    """This rank's filled halo buffer [P H, D]: its send rows gathered
    (K17d), then the all-to-all."""
    sh = part.shards[mesh.rank]
    d = x_local.shape[1]
    send = owned_gather(x_local.contiguous(), 0, sh.send_idx, out=sh.buffer(d, "send"))
    return all_to_all(send, mesh, out=sh.buffer(d, "recv"))


class _HaloSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, mesh: Mesh, part: HaloPartition, combiner: str):
        ctx.mesh, ctx.part, ctx.combiner = mesh, part, combiner
        halo = exchange_halo(mesh, part, x_local)
        return halo_spmm_local(part, mesh.rank, x_local, halo, combiner)

    @staticmethod
    def backward(ctx, g):
        mesh, part = ctx.mesh, ctx.part
        sh = part.shards[mesh.rank]
        s = part.shard_size
        grad = halo_spmm_local_backward(part, mesh.rank, g, ctx.combiner)
        received = all_to_all(grad[s:], mesh, out=sh.buffer(g.shape[1], "recv"))
        g_local = grad[:s]
        owned_scatter(g_local, 0, sh.send_idx, received, 1.0)
        return g_local, None, None, None


def halo_spmm(mesh: Mesh, part: HaloPartition, x_local: torch.Tensor,
              combiner: str = "sum") -> torch.Tensor:
    """This rank's [S, D] rows of A @ x, with x row-sharded ([S, D] a rank,
    rows past N zero); differentiable in x_local."""
    if combiner not in COMBINERS:
        raise ValueError(f"Unknown combiner {combiner!r}")
    return _HaloSpMM.apply(x_local, mesh, part, combiner)


class _ToShard(torch.autograd.Function):
    """Replicated [P S, D] -> this rank's [S, D] rows; the backward
    all-gathers the ranks' row gradients, each complete for its rows."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, lo: int, s: int):
        ctx.mesh = mesh
        return x[lo:lo + s]

    @staticmethod
    def backward(ctx, g):
        from .mesh import all_gather

        return all_gather(g, ctx.mesh), None, None, None


class _FromShard(torch.autograd.Function):
    """This rank's [S, D] rows -> the replicated [P S, D] (all-gather); the
    backward keeps this rank's rows of the gradient, which every rank
    computes alike from the replicated result."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        from .mesh import all_gather

        ctx.mesh, ctx.s = mesh, x.shape[0]
        return all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.s
        return g[lo:lo + ctx.s].contiguous(), None


def halo_conv(mesh: Mesh, part: HaloPartition, h: torch.Tensor,
              combiner: str = "sum") -> torch.Tensor:
    """A @ h for replicated activations h [N, D]: this rank's rows go
    through `halo_spmm` and the outputs are all-gathered, so the result is
    replicated and differentiable, and every rank computes the same
    gradients. The GCN's convolution over a mesh."""
    n, s = h.shape[0], part.shard_size
    hp = torch.nn.functional.pad(h, (0, 0, 0, part.n_shards * s - n))
    x_local = _ToShard.apply(hp, mesh, mesh.rank * s, s)
    return _FromShard.apply(halo_spmm(mesh, part, x_local, combiner), mesh)[:n]
