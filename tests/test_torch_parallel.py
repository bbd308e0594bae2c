"""The port's multi-device pieces on gloo ranks (P = 2 and 4 CPU processes,
`tests/dist_ranks.py`) against the JAX package on a P-device sub-mesh of
its 8 virtual CPU devices, on the same numpy inputs: the edge-sharded
SpMM, the halo partition's host plan (exactly), the halo SpMM's forward and
gradient per combiner, and the row-sharded gathers and scatters. Then the
functional steps held to the port's own single-device step, the exchange
volume, the sharded GCN step and the multi-rank dry run."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.graph import karate_club as ref_karate_club
from embiggen_tpu.graph import kernel_coo as ref_kernel_coo
from embiggen_tpu.parallel import build_halo_partition as ref_build_halo_partition
from embiggen_tpu.parallel import halo_spmm as ref_halo_spmm
from embiggen_tpu.parallel import make_mesh as ref_make_mesh
from embiggen_tpu.parallel import partition_coo as ref_partition_coo
from embiggen_tpu.parallel import shard_features as ref_shard_features
from embiggen_tpu.parallel import sharded_spmm as ref_sharded_spmm
from embiggen_tpu.parallel import sharded_table as ref_sharded_table
from embiggen_tpu_torch.graph import erdos_renyi, karate_club
from embiggen_tpu_torch.models.embedders import FirstOrderLINE, SkipGram
from embiggen_tpu_torch.parallel import (
    Mesh, build_halo_partition, halo_spmm_local, partition_coo, resolve_mesh,
)
from embiggen_tpu_torch.parallel.halo import halo_spmm_local_backward
from embiggen_tpu_torch.utils.convert import halo_partition_from_jax, row_shard_from_jax

import dist_ranks

WORLDS = (2, 4)
# Sums over arcs and over ranks in another order than XLA's.
SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
# The mean scatter scales each gradient by 1 / count before adding, as the
# reference's owned scatter does, in float32 on either side.
SCATTER_TOL = dict(rtol=1e-6, atol=1e-7)


def _sub_mesh(world, axis="nodes"):
    return ref_make_mesh((axis,), devices=jax.devices()[:world])


def _halo_graph():
    g = ref_erdos_renyi(200, 1500, seed=3, weighted=True)
    return ref_kernel_coo(g, "Symmetric Normalized Laplacian"), g.number_of_nodes


def _payload():
    rng = np.random.default_rng(0)
    karate = ref_karate_club()
    rows, cols, vals = ref_kernel_coo(karate, "Symmetric Normalized Laplacian")
    x = rng.normal(size=(karate.number_of_nodes, 16)).astype(np.float32)
    (h_rows, h_cols, h_vals), n = _halo_graph()
    h_x = rng.normal(size=(n, 16)).astype(np.float32)
    h_g = rng.normal(size=(n, 16)).astype(np.float32)
    table = rng.normal(size=(37, 8)).astype(np.float32)
    bias = rng.normal(size=(37,)).astype(np.float32)
    # Ids with repeats, across every shard.
    idx = rng.integers(0, 37, 90).astype(np.int32)
    grads = rng.normal(size=(90, 8)).astype(np.float32)
    bgrads = rng.normal(size=(90,)).astype(np.float32)
    return {"spmm": (rows, cols, vals, x), "halo": (h_rows, h_cols, h_vals, h_x, h_g),
            "tables": (table, bias, idx, grads, bgrads, 0.3)}


@pytest.fixture(scope="module")
def payload():
    return _payload()


_payload = functools.lru_cache(maxsize=None)(_payload)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"P{w}")
def pieces(request, tmp_path_factory, payload):
    world = request.param
    return world, dist_ranks.spawn("pieces", world, tmp_path_factory.mktemp("pieces"), payload)


# ------------------------------------------------------- edge-sharded SpMM
def test_sharded_spmm_matches_reference(pieces, payload):
    world, ranks = pieces
    rows, cols, vals, x = payload["spmm"]
    rows_p, cols_p, vals_p = ref_partition_coo(rows, cols, vals, world)
    for got, want in zip(partition_coo(rows, cols, vals, world), (rows_p, cols_p, vals_p)):
        np.testing.assert_array_equal(got, want)
    want = np.asarray(ref_sharded_spmm(
        _sub_mesh(world, "edges"), "edges", jnp.asarray(rows_p, jnp.int32),
        jnp.asarray(cols_p, jnp.int32), jnp.asarray(vals_p, jnp.float32), jnp.asarray(x),
        x.shape[0]))
    for r in ranks:
        np.testing.assert_allclose(r["sharded_spmm"], want, **SPMM_TOL)


# --------------------------------------------------------------- the halo
def _boundary_sets(rows, cols, n, p):
    """B[q -> p] by its definition: the distinct columns owned by q that
    p's arcs (by output row) read."""
    s = -(-n // p)
    return {(q, dev): np.unique(cols[(rows // s == dev) & (cols // s == q)])
            for dev in range(p) for q in range(p) if q != dev}


def _assert_same_host_plan(got, ref, rows, cols, n, p):
    assert (got.n_shards, got.shard_size, got.halo_width, got.n_nodes, got.comm_rows) == (
        ref.n_shards, ref.shard_size, ref.halo_width, ref.n_nodes, ref.comm_rows)
    np.testing.assert_array_equal(got.send_idx, np.asarray(ref.send_idx))
    np.testing.assert_array_equal(got.abs_wsum, np.asarray(ref.abs_wsum))
    np.testing.assert_array_equal(got.sq_wsum, np.asarray(ref.sq_wsum))
    want = _boundary_sets(np.asarray(rows), np.asarray(cols), n, p)
    assert got.boundary.keys() == want.keys()
    for key, b in want.items():
        np.testing.assert_array_equal(got.boundary[key], b)


@pytest.mark.parametrize("world", WORLDS + (8,))
def test_halo_partition_matches_reference_exactly(world):
    (rows, cols, vals), n = _halo_graph()
    got = build_halo_partition(rows, cols, vals, n, world, device="cpu", shards=[])
    ref = ref_build_halo_partition(rows, cols, vals, n, world)
    _assert_same_host_plan(got, ref, rows, cols, n, world)
    # The JAX partition carried across has the same plan.
    _assert_same_host_plan(halo_partition_from_jax(ref, shards=[]), ref, rows, cols, n, world)


def _planted_cut():
    """tests/test_parallel.py::test_halo_comm_rows_tracks_planted_cut's
    graph: 4 shards of 16 with dense intra-shard arcs and exactly 5 arcs
    from shard 0 to distinct nodes of shard 1."""
    p, s = 4, 16
    rng = np.random.default_rng(0)
    src, dst = [], []
    for dev in range(p):
        a = rng.integers(dev * s, dev * s + s, 200)
        b = rng.integers(dev * s, dev * s + s, 200)
        keep = a != b
        src.append(a[keep])
        dst.append(b[keep])
    src.append(np.arange(5))
    dst.append(s + np.arange(5))
    rows, cols = np.concatenate(src), np.concatenate(dst)
    return rows, cols, rng.random(len(rows)).astype(np.float32), p * s, p


def test_planted_cut_comm_rows():
    rows, cols, vals, n, p = _planted_cut()
    got = build_halo_partition(rows, cols, vals, n, p, device="cpu")
    ref = ref_build_halo_partition(rows, cols, vals, n, p)
    assert got.comm_rows == ref.comm_rows == 5
    assert got.halo_width == ref.halo_width == 5
    _assert_same_host_plan(got, ref, rows, cols, n, p)
    # Every shard's product from its halo, filled by indexing (the
    # exchange in one process), is the dense product.
    x = np.random.default_rng(1).random((n, 8)).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    out = _halo_by_indexing(got, torch.from_numpy(x), "sum")
    np.testing.assert_allclose(out[:n], dense @ x, rtol=2e-4, atol=2e-5)


def test_comm_volume_tracks_boundary_not_n():
    """tests/test_halo_spmm.py's 8 near-disjoint communities: comm_rows
    stays at the boundary, far below a random graph's."""
    n, per = 400, 50
    rng = np.random.default_rng(1)
    src = [rng.integers(b * per, (b + 1) * per, 400) for b in range(8)]
    dst = [rng.integers(b * per, (b + 1) * per, 400) for b in range(8)]
    src.append(np.arange(8) * per)
    dst.append(((np.arange(8) + 1) % 8) * per)
    src, dst = np.concatenate(src), np.concatenate(dst)
    vals = np.ones(len(src), np.float32)
    got = build_halo_partition(src, dst, vals, n, 8, device="cpu", shards=[])
    assert got.comm_rows == ref_build_halo_partition(src, dst, vals, n, 8).comm_rows <= 16
    dense = build_halo_partition(rng.integers(0, n, 2000), rng.integers(0, n, 2000),
                                 np.ones(2000, np.float32), n, 8, device="cpu", shards=[])
    assert dense.comm_rows > got.comm_rows


def _halo_by_indexing(part, x, combiner):
    """Every shard's rows of the product, its halo buffer filled by
    indexing the whole x: the exchange in one process."""
    p, s, h = part.n_shards, part.shard_size, part.halo_width
    xp = torch.zeros((p * s, x.shape[1]))
    xp[:x.shape[0]] = x
    outs = []
    for dev in range(p):
        halo = torch.cat([xp[q * s + torch.from_numpy(part.send_idx[q, dev]).long()]
                          for q in range(p)])
        outs.append(halo_spmm_local(part, dev, xp[dev * s:(dev + 1) * s], halo, combiner))
    return torch.cat(outs).numpy()


@functools.lru_cache(maxsize=None)
def _reference_halo(world):
    """The JAX halo SpMM's forward and gradient of sum(out * g) on the
    payload, per combiner, in one jitted program (eager shard_map takes
    tens of seconds a call here), and its partition."""
    (rows, cols, vals), n = _halo_graph()
    *_, x, g_out = _payload()["halo"]
    mesh = _sub_mesh(world)
    part = ref_build_halo_partition(rows, cols, vals, n, world)
    xs = ref_shard_features(x, part, mesh, "nodes")
    gp = np.zeros((part.n_shards * part.shard_size, x.shape[1]), np.float32)
    gp[:n] = g_out

    @jax.jit
    def run(xs, gp):
        out = {}
        for combiner in ("sum", "mean", "sqrtn"):
            y, vjp = jax.vjp(lambda v: ref_halo_spmm(mesh, "nodes", part, v, combiner), xs)
            out[combiner] = (y, vjp(gp)[0])
        return out

    return jax.tree_util.tree_map(np.asarray, run(xs, jnp.asarray(gp))), part


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_halo_spmm_forward_and_gradient_match_reference(pieces, payload, combiner):
    world, ranks = pieces
    x = payload["halo"][3]
    halo, ref_part = _reference_halo(world)
    want_out, want_grad = halo[combiner]
    got_out = np.concatenate([r[f"halo_{combiner}"][0] for r in ranks])
    got_grad = np.concatenate([r[f"halo_{combiner}"][1] for r in ranks])
    np.testing.assert_allclose(got_out, want_out, **SPMM_TOL)
    np.testing.assert_allclose(got_grad, want_grad, **SPMM_TOL)
    # The padding rows stay zero.
    n = x.shape[0]
    assert not got_out[n:].any()
    # On the JAX partition carried across, exchanged by indexing, too.
    part = halo_partition_from_jax(ref_part)
    np.testing.assert_allclose(_halo_by_indexing(part, torch.from_numpy(x), combiner),
                               want_out, **SPMM_TOL)


def test_halo_backward_is_the_transposed_product():
    """K17a's backward plain version over the transposed CSR equals
    autograd of its forward plain version, halo rows included."""
    (rows, cols, vals), n = _halo_graph()
    part = build_halo_partition(rows, cols, vals, n, 4, device="cpu")
    s, ph = part.shard_size, part.n_shards * part.halo_width
    rng = np.random.default_rng(5)
    for combiner in ("sum", "mean", "sqrtn"):
        x = torch.from_numpy(rng.normal(size=(s, 6)).astype(np.float32)).requires_grad_()
        halo = torch.from_numpy(rng.normal(size=(ph, 6)).astype(np.float32)).requires_grad_()
        g = torch.from_numpy(rng.normal(size=(s, 6)).astype(np.float32))
        gx, gh = torch.autograd.grad((halo_spmm_local(part, 1, x, halo, combiner) * g).sum(),
                                     (x, halo))
        got = halo_spmm_local_backward(part, 1, g, combiner)
        np.testing.assert_allclose(got.numpy(), torch.cat([gx, gh]).numpy(), **SPMM_TOL)


# ---------------------------------------------------- row-sharded tables
@functools.lru_cache(maxsize=None)
def _reference_tables(world):
    """The JAX row-sharded gathers and scatters on the payload, jitted."""
    table, bias, idx, grads, bgrads, lr = _payload()["tables"]
    mesh = _sub_mesh(world)
    half = idx.shape[0] // 2
    spec = functools.partial(shard_map, mesh=mesh, check_vma=False)

    @jax.jit
    def run(tp, i, g):
        mean, counts = spec(
            lambda sh, i, u: ref_sharded_table._mean_scatter_owned(
                sh, (i[:half], i[half:]), (u[:half], u[half:]), lr, "nodes"),
            in_specs=(P("nodes"), P(), P()), out_specs=(P("nodes"), P("nodes")))(tp, i, g)
        return {
            "gather": spec(lambda sh, i: ref_sharded_table._gather_rows(sh, i, "nodes"),
                           in_specs=(P("nodes"), P()), out_specs=P())(tp, i),
            "scatter_add": spec(
                lambda sh, i, u: ref_sharded_table._scatter_add_owned(sh, i, u, "nodes"),
                in_specs=(P("nodes"), P(), P()), out_specs=P("nodes"))(tp, i, g),
            "mean_scatter": mean, "mean_counts": counts,
        }

    out = {}
    for name, t, g in (("table", table, grads), ("bias", bias, bgrads)):
        n_pad = -(-t.shape[0] // world) * world
        tp = np.zeros((n_pad,) + t.shape[1:], np.float32)
        tp[:t.shape[0]] = t
        tp = jax.device_put(jnp.asarray(tp), NamedSharding(mesh, P("nodes")))
        for piece, v in run(tp, jnp.asarray(idx), jnp.asarray(g)).items():
            out[f"{piece}_{name}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("piece", ["gather", "scatter_add", "mean_scatter", "mean_counts"])
@pytest.mark.parametrize("name", ["table", "bias"])
def test_row_sharded_tables_match_reference(pieces, payload, piece, name):
    world, ranks = pieces
    want = _reference_tables(world)[f"{piece}_{name}"]
    if piece == "gather":
        for r in ranks:
            np.testing.assert_array_equal(r[f"gather_{name}"], want)
        return
    got = np.concatenate([r[f"{piece}_{name}"] for r in ranks])
    if piece == "mean_counts":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **SCATTER_TOL)
    if piece == "scatter_add":
        # The JAX padded table carried across: each rank's rows.
        s = want.shape[0] // world
        for rank, r in enumerate(ranks):
            np.testing.assert_array_equal(row_shard_from_jax(want, world, rank).numpy(),
                                          want[rank * s:(rank + 1) * s])


# ---------------------------------------------------------- resolve_mesh
def test_initialize_distributed_without_a_coordinator(monkeypatch):
    from embiggen_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv("EMBIGGEN_TPU_COORDINATOR", raising=False)
    assert initialize_distributed() is False


def test_resolve_mesh_contract_without_a_world():
    assert resolve_mesh(None) is None
    assert resolve_mesh(1) is None
    assert resolve_mesh(0) is None
    assert resolve_mesh("auto") is None
    one = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    assert resolve_mesh(one) is None
    with pytest.raises(ValueError):
        resolve_mesh(10_000)
    with pytest.raises(TypeError):
        resolve_mesh(3.5)


def test_resolve_mesh_sub_mesh_on_four_ranks(pieces):
    world, ranks = pieces
    if world < 4:
        assert all("sub_mesh" not in r for r in ranks)
        return
    assert [r["sub_mesh"] for r in ranks[:2]] == [(2, 0), (2, 1)]
    assert all("is not in the first 2 ranks" in r["sub_mesh"] for r in ranks[2:])


# ------------------------------------------------------ functional steps
@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"P{w}")
def steps(request, tmp_path_factory):
    rng = np.random.default_rng(0)
    payload = {
        "skipgram": {"node_embedding": (rng.normal(size=(34, 16)) / 4).astype(np.float32),
                     "context_embedding": (rng.normal(size=(34, 16)) / 4).astype(np.float32),
                     "context_bias": np.zeros(34, np.float32)},
        "dp": {"node_embedding": rng.normal(size=(120, 16)).astype(np.float32),
               "context_embedding": rng.normal(size=(120, 16)).astype(np.float32),
               "context_bias": np.zeros(120, np.float32)},
        "gcn_x": rng.normal(size=(34, 16)).astype(np.float32),
    }
    world = request.param
    return world, dist_ranks.spawn("steps", world, tmp_path_factory.mktemp("steps"), payload)


def test_row_sharded_step_matches_dim_sharded(steps):
    """The mirror of tests/test_parallel.py::
    test_row_sharded_skipgram_matches_dim_sharded: the same objective, per
    step losses and final tables, and untouched padding rows."""
    world, ranks = steps
    losses, rows, dim, last_shard = ranks[0]["rows_vs_dim"]
    for i, (loss_r, loss_d) in enumerate(losses):
        np.testing.assert_allclose(loss_r, loss_d, rtol=1e-4, err_msg=f"step {i}")
    np.testing.assert_allclose(rows, dim, rtol=1e-3, atol=1e-5)
    pad = ranks[-1]["rows_vs_dim"][3]
    n_pad = -(-34 // world) * world - 34
    assert not pad[pad.shape[0] - n_pad:].any()


def test_dp_step_matches_single_device_and_stays_replicated(steps):
    """The mirror of tests/test_parallel_gcn.py::
    test_dp_skipgram_step_matches_replication_invariant, held also to the
    single-device step on the same batches."""
    world, ranks = steps
    dp_losses, single_losses, dp, single = ranks[0]["dp"]
    np.testing.assert_allclose(dp_losses, single_losses, rtol=2e-5, atol=2e-6)
    for k in dp:
        np.testing.assert_allclose(dp[k], single[k], rtol=2e-5, atol=2e-6)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["dp"][2][k], dp[k])
    assert np.isfinite(dp_losses).all()


def test_sharded_gcn_edge_step_trains(steps):
    """The mirror of tests/test_parallel_gcn.py::
    test_sharded_gcn_edge_step_trains (150 steps at lr 1.0: from the port's
    draws, 60 steps at lr 0.1 move the mean loss by under 0.01), after one
    step held to autograd of the same model with a dense kernel."""
    world, ranks = steps
    for r in ranks:
        assert r["gcn_grad_err"] < 1e-6
    losses = ranks[0]["gcn_losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.01, (losses[:5], losses[-5:])
    for r in ranks[1:]:
        assert r["gcn_losses"] == losses


# ------------------------------------------------------ exchange volume
def test_exchange_volume_grows_with_the_batch_not_n():
    """The data-parallel exchange: the minibatch models' all-gathered Update
    payloads, and the walk models' all-reduced compact sums (U rows, at most
    B L + B K), depend on the batch and not on [N, D]."""
    small, big = karate_club(), erdos_renyi(1000, 8000, seed=1)

    def payload(graph, batch):
        m = FirstOrderLINE(embedding_size=8, batch_size=batch, epochs=1, random_state=0,
                           device="cpu")
        ctx = m._prepare_data(graph)
        params = m._init_params(graph, torch.Generator().manual_seed(0))
        batch_draw = m._sample_batch(ctx, torch.Generator().manual_seed(1), batch)
        _, updates = m._batch_updates(params, batch_draw, batch)
        return [(u.name, tuple(t.shape for t in u.idx), tuple(t.shape for t in u.grad))
                for u in updates]

    p_small, p_big, p_big2 = payload(small, 64), payload(big, 64), payload(big, 128)
    assert p_small == p_big
    for (_, i1, g1), (_, i2, g2) in zip(p_big, p_big2):
        assert [s[0] * 2 for s in i1] == [s[0] for s in i2]
        assert [s[0] * 2 for s in g1] == [s[0] for s in g2]

    b, length, k = 16, 8, 4
    for graph in (small, big):
        m = SkipGram(embedding_size=8, walk_length=length, window_size=2,
                     number_of_negative_samples=k, device="cpu")
        tg = m._device_graph(graph)
        walks, negs = m._sample_batch(tg, torch.Generator().manual_seed(0), b)
        uniq, walks_u, negs_u = m._compact_batch(walks, negs)
        assert uniq.shape[0] <= b * (length + k)
        np.testing.assert_array_equal(uniq[walks_u.long()].numpy(), walks.numpy())
        np.testing.assert_array_equal(uniq[negs_u.long()].numpy(), negs.numpy())


# ------------------------------------------------------------ the dry run
def test_dryrun_multichip_on_two_gloo_ranks():
    from embiggen_tpu_torch.scripts.dryrun_multichip import dryrun_multichip

    run = dryrun_multichip(2, backend="gloo")
    assert run["backend"] == "gloo" and run["device"] == "cpu"
    out = run["results"]
    assert len(out) == 9 and np.isfinite(list(out.values())).all()
    # The three functional SkipGram steps take the same first step.
    losses = [out[k] for k in ("dim-sharded SkipGram", "row-sharded SkipGram",
                               "data-parallel SkipGram")]
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)
