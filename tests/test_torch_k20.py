"""K20's plain versions on the CPU against embiggen_tpu: `sddmm` (the
per-edge scores a[rows]·b[cols], within 1e-6 of each edge's sum of
|a_d b_d|, as the sums over D run in another order) and its gradients
against `jax.grad` (rtol 1e-6 / atol 1e-6), with int32 and int64 ids, a D
that is not a multiple of 4, repeated ids and no edges; and
`edge_chunk` / `chunk_mask` exactly, with and without the exported
sources, on the first, a middle, the last (clamped) and a past-the-end
chunk, and on an edgeless graph, where the reference's gather raises
TypeError (its mask is all False). The kernels themselves are tested on the
card (`tests/test_torch_cuda.py -k "sddmm or edge_chunk"`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.ops.negatives import chunk_mask as ref_chunk_mask
from embiggen_tpu.ops.negatives import edge_chunk as ref_edge_chunk
from embiggen_tpu.ops.spmm import sddmm as ref_sddmm
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.ops import _build
from embiggen_tpu_torch.ops.negatives import chunk_mask, edge_chunk
from embiggen_tpu_torch.ops.spmm import sddmm

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, n_edges, d, id_dtype):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(50, d)).astype(np.float32)
    b = rng.normal(size=(30, d)).astype(np.float32)
    rows = rng.integers(0, 50, n_edges).astype(id_dtype)
    cols = rng.integers(0, 30, n_edges).astype(id_dtype)
    return rows, cols, a, b


@pytest.mark.parametrize("d", [1, 8, 13, 128])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_sddmm_matches_reference(d, id_dtype):
    rows, cols, a, b = _inputs(d, 400, d, id_dtype)
    want = np.asarray(ref_sddmm(*(jnp.asarray(x) for x in (rows, cols, a, b))))
    got = sddmm(*(torch.from_numpy(x) for x in (rows, cols, a, b)))
    assert got.dtype == torch.float32 and got.shape == (400,)
    scale = np.abs(a[rows] * b[cols]).sum(1)
    assert (np.abs(got.numpy() - want) <= 1e-6 * scale).all()


@pytest.mark.parametrize("same_table", [False, True])
def test_sddmm_gradients_match_jax_grad(same_table):
    """The backward's two index_add_ passes against jax.grad of the sum of
    weighted scores; with one table on both sides the two gradients add."""
    rows, cols, a, b = _inputs(3, 300, 12, np.int32)
    if same_table:
        cols = rows[::-1].copy()
        b = a
    w = np.random.default_rng(4).normal(size=300).astype(np.float32)
    if same_table:
        want = jax.grad(lambda x: (ref_sddmm(rows, cols, x, x) * w).sum())(jnp.asarray(a))
        ta = torch.from_numpy(a).requires_grad_()
        (got,) = torch.autograd.grad((sddmm(torch.from_numpy(rows), torch.from_numpy(cols),
                                            ta, ta) * torch.from_numpy(w)).sum(), ta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    want = jax.grad(lambda x, y: (ref_sddmm(rows, cols, x, y) * w).sum(), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = torch.autograd.grad((sddmm(torch.from_numpy(rows), torch.from_numpy(cols), ta, tb)
                               * torch.from_numpy(w)).sum(), (ta, tb))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)


def test_sddmm_without_edges_and_its_shape_checks():
    a = torch.ones(4, 3)
    empty = torch.zeros(0, dtype=torch.int32)
    assert sddmm(empty, empty, a, a).shape == (0,)
    with pytest.raises(ValueError, match="alike"):
        sddmm(torch.zeros(3, dtype=torch.int32), empty, a, a)
    with pytest.raises(ValueError, match="one D"):
        sddmm(empty, empty, a, torch.ones(4, 2))


def test_k20_refuses_devices_other_than_cpu_and_cuda():
    a = torch.ones(4, 3, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="No kernel or plain version"):
        sddmm(ids, ids, a, a)
    assert not _build.is_cuda(torch.ones(1))


@pytest.fixture(scope="module")
def chunk_graphs():
    """(port graph, reference graph): 60 nodes with isolated ones, 311
    arcs, directed (so rows end anywhere)."""
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 50, 320), rng.integers(0, 60, 320)
    port = Graph.from_edge_arrays(src, dst, n_nodes=60, directed=True)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=60, directed=True)
    np.testing.assert_array_equal(port.col_idx, ref.col_idx)
    return port, ref


@pytest.mark.parametrize("with_sources", [False, True])
@pytest.mark.parametrize("size", [1, 7, 64])
def test_edge_chunk_and_mask_match_reference(chunk_graphs, with_sources, size):
    port, ref = chunk_graphs
    tg = port.device("cpu", with_sources=with_sources)
    dg = ref.device(with_sources=with_sources)
    n_arcs = port.number_of_directed_edges
    last = (n_arcs - 1) // size
    assert n_arcs % size or size == 1
    for i in sorted({0, last // 2, last, last + 1, last + 5}):
        src, dst = edge_chunk(tg, i, size)
        want_src, want_dst = ref_edge_chunk(dg, i, size)
        assert src.dtype == dst.dtype == torch.int32
        np.testing.assert_array_equal(src.numpy(), np.asarray(want_src), err_msg=f"chunk {i}")
        np.testing.assert_array_equal(dst.numpy(), np.asarray(want_dst), err_msg=f"chunk {i}")
        mask = chunk_mask(tg, i, size)
        assert mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_chunk_mask(dg, i, size)))


@pytest.mark.parametrize("with_sources", [False, True])
def test_edge_chunk_on_an_edgeless_graph_raises_as_the_reference(with_sources):
    empty = np.zeros(0, np.int64)
    port = Graph.from_edge_arrays(empty, empty, n_nodes=5, directed=True)
    ref = RefGraph.from_edge_arrays(empty, empty, n_nodes=5, directed=True)
    tg = port.device("cpu", with_sources=with_sources)
    dg = ref.device(with_sources=with_sources)
    with pytest.raises(TypeError):
        ref_edge_chunk(dg, 0, 4)
    with pytest.raises(TypeError, match="no"):
        edge_chunk(tg, 0, 4)
    np.testing.assert_array_equal(chunk_mask(tg, 0, 4).numpy(),
                                  np.asarray(ref_chunk_mask(dg, 0, 4)))
