"""K7 (the CSR SpMM and its transposed backward) and the gather probes P1
and P2 on the CPU, held against embiggen_tpu.

K7 runs against `spmm_padded(pad_coo(..., cap=4, with_transpose=True))` and
`jax.grad` through it, for every combiner: the small cap sends most of each
row through the reference's COO overflow. The reference sums ELL slots and
then the overflow, the port sums in CSR order, so the two agree to rounding:
rtol 1e-5, atol 1e-6.

The feature-sliced product that `embiggen_tpu_torch/scripts/spmm_slices.py`
measures against K7 is checked through its plain versions: the pack round
trip, the column-block splits, and the product pass by pass against K7's
plain version (exactly in one column block, where every sum runs in the
same order) and against the reference.

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
from embiggen_tpu_torch.ops.spmm import (
    _stable_counting_order, csr_kernel, csr_spmm_plain, spmm,
)
from embiggen_tpu_torch.scripts.spmm_slices import (
    column_block_splits, pack_slices_plain, sliced_spmm_plain,
)

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


@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("d", [30, 64, 5])
def test_pack_slices_round_trip(s, d):
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(50, d)).astype(np.float32))
    packed = pack_slices_plain(x, s)
    passes = -(-d // s)
    assert packed.shape == (passes, 50, s) and packed.is_contiguous()
    for p in range(passes):
        width = min(s, d - p * s)
        assert torch.equal(packed[p, :, :width], x[:, p * s:p * s + width])
        assert not bool(packed[p, :, width:].any())   # the last slice is zero-padded
    assert torch.equal(packed.transpose(0, 1).reshape(50, -1)[:, :d], x)


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_column_block_splits(graph, blocks):
    k = csr_kernel(*kernel_coo(graph), N)
    splits = column_block_splits(k, blocks)
    assert splits.shape == (blocks + 1, N)
    assert torch.equal(splits[0], k.row_ptr[:-1].long())
    assert torch.equal(splits[-1], k.row_ptr[1:].long())
    nb = -(-N // blocks)
    for b in range(blocks):
        for r in (0, 7, N - 1):
            cols = k.cols[splits[b, r]:splits[b + 1, r]].numpy()
            assert ((cols >= b * nb) & (cols < (b + 1) * nb)).all()
    rows, cols, vals = kernel_coo(graph)
    shuffled = csr_kernel(rows, cols[::-1].copy(), vals, N)   # rows out of column order
    if blocks > 1:
        with pytest.raises(ValueError, match="column order"):
            column_block_splits(shuffled, blocks)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("s, blocks", [(8, 1), (16, 1), (32, 1), (8, 3)])
def test_sliced_spmm_matches_plain_and_reference(graph, combiner, s, blocks):
    rows, cols, vals = kernel_coo(graph, "Symmetric Normalized Laplacian")
    rng = np.random.default_rng(2)
    d = 30
    x = rng.normal(size=(N, d)).astype(np.float32)
    g = rng.normal(size=(N, d)).astype(np.float32)
    k = csr_kernel(rows, cols, vals, N)
    inv = k.inverse_denominator(combiner)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = sliced_spmm_plain(k, xt, s, blocks, row_scale=inv)
    got_dx = sliced_spmm_plain(k.transpose, gt, s, blocks, col_scale=inv)
    want = csr_spmm_plain(k, xt, inv)
    want_dx = csr_spmm_plain(k.transpose, gt, None, inv)
    if blocks == 1:
        assert torch.equal(got, want) and torch.equal(got_dx, want_dx)
    else:   # the blocks' partial sums are added in another order
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got_dx, want_dx, rtol=1e-6, atol=1e-6)
    pk = pad_coo(rows, cols, vals, N, cap=4, with_transpose=True)
    ref = spmm_padded(pk, jnp.asarray(x), combiner)
    ref_dx = jax.grad(lambda v: jnp.sum(spmm_padded(pk, v, combiner) * g))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(ref_dx), rtol=1e-5, atol=1e-6)
