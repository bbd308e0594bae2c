"""K7 (the CSR SpMM and its transposed backward) and the gather probes P1
and P2 on the CPU, held against embiggen_tpu.

K7 runs against `spmm_padded(pad_coo(..., cap=4, with_transpose=True))` and
`jax.grad` through it, for every combiner: the small cap sends most of each
row through the reference's COO overflow. The reference sums ELL slots and
then the overflow, the port sums in CSR order, so the two agree to rounding:
rtol 1e-5, atol 1e-6.

P1 and P2 are checked through their plain versions against numpy per-tile
sums and the probe's XLA reference `x[idx].sum(0)`. The Pallas kernels
themselves are closures inside `scripts/spmm_probe.py::main()` that use TPU
DMA semaphores, so they can be neither imported nor run here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.ops.spmm import pad_coo, spmm_padded
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.graph.laplacians import kernel_coo
from embiggen_tpu_torch.ops.gather_probe import (
    P1_TILE, P2_BLOCK, table_gather_sums, tile_gather_sums,
)
from embiggen_tpu_torch.ops.spmm import _stable_counting_order, csr_kernel, spmm

torch.set_num_threads(1)
N, D = 120, 12


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(N, 900, seed=4, weighted=True)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("name", [
    "Symmetric Normalized Laplacian", "Left Normalized Laplacian",
    "Transposed Right Normalized Laplacian", "Weights",
])
def test_spmm_and_gradient_match_reference(graph, name, combiner):
    rows, cols, vals = kernel_coo(graph, name)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    g = rng.normal(size=(N, D)).astype(np.float32)
    pk = pad_coo(rows, cols, vals, N, cap=4, with_transpose=True)
    assert pk.ov_rows.shape[0] > 0  # the reference's overflow path runs
    want = spmm_padded(pk, jnp.asarray(x), combiner)
    want_dx = jax.grad(lambda v: jnp.sum(spmm_padded(pk, v, combiner) * g))(jnp.asarray(x))
    k = csr_kernel(rows, cols, vals, N)
    xt = torch.tensor(x, requires_grad=True)
    got = spmm(k, xt, combiner)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-6)


def test_kernel_layout(graph):
    rows, cols, vals = kernel_coo(graph, "Transposed Left Normalized Laplacian")
    assert (np.diff(rows) < 0).any()  # unsorted rows go through the counting sort
    k = csr_kernel(rows, cols, vals, N)
    assert (np.diff(k.rows.numpy()) >= 0).all()
    np.testing.assert_array_equal(np.diff(k.row_ptr.numpy()), np.bincount(rows, minlength=N))
    order = np.argsort(rows, kind="stable")
    np.testing.assert_array_equal(k.cols.numpy(), cols[order])
    np.testing.assert_allclose(k.abs_weight_sum.numpy(),
                               np.bincount(rows, np.abs(vals), minlength=N), rtol=1e-6)
    t = k.transpose
    assert t.n_out == k.n_in and t.transpose is None
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), vals)
    dense_t = np.zeros((N, N))
    np.add.at(dense_t, (t.rows.numpy(), t.cols.numpy()), t.vals.numpy())
    np.testing.assert_allclose(dense_t, dense.T, rtol=1e-6)
    keys = np.random.default_rng(3).integers(0, 1 << 31, 5000)
    np.testing.assert_array_equal(_stable_counting_order(keys),
                                  np.argsort(keys, kind="stable"))


def test_spmm_without_transpose_refuses_a_gradient(graph):
    k = csr_kernel(*kernel_coo(graph), N, with_transpose=False)
    with pytest.raises(ValueError, match="transpose"):
        spmm(k, torch.ones(N, 4, requires_grad=True))
    with pytest.raises(ValueError, match="combiner"):
        spmm(k, torch.ones(N, 4), "max")


@pytest.mark.parametrize("probe, tile, n_rows", [
    (tile_gather_sums, P1_TILE, 900), (table_gather_sums, P2_BLOCK, 64),
])
def test_gather_probes_match_numpy_and_the_xla_reference(probe, tile, n_rows):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n_rows, 8)).astype(np.float32)
    idx = rng.integers(0, n_rows, 3 * tile + tile // 3).astype(np.int32)
    got = probe(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.shape == (3, 8)  # only whole tiles
    want = x[idx[:3 * tile]].astype(np.float64).reshape(3, tile, 8).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    whole = jnp.asarray(x)[jnp.asarray(idx[:3 * tile])].sum(axis=0)
    np.testing.assert_allclose(got.sum(0), np.asarray(whole), rtol=1e-5, atol=1e-3)
