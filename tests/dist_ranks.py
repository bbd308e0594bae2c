"""Spawned gloo ranks for the multi-device tests of the port: `spawn` runs
one named body on P CPU processes (one torch.distributed rank each) and
returns each rank's result. Imports torch, numpy and the port only, never
jax, so the children never load it.

A rank that raises fails the spawn with its traceback; a spawn that has not
ended by its deadline is killed and fails, so a hung rank cannot run the
suite into its time limit."""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 120.0


def spawn(body: str, world: int, tmp_path, payload=None, deadline_s: float = DEADLINE_S):
    """[result of rank r] of BODIES[body](mesh, payload) on `world` gloo
    ranks, rendezvous through a file store under `tmp_path`."""
    tmp = str(tmp_path)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    store = os.path.join(tmp, f"store_{body}_{world}")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"   # the children's, taken at their start
    try:
        ctx = mp.start_processes(_entry, args=(world, store, body, tmp), nprocs=world,
                                 join=False, start_method="spawn")
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    end = time.monotonic() + deadline_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"the {body} ranks did not end within {deadline_s} s")
    return [torch.load(os.path.join(tmp, f"out_{body}_{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, store, body, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        from embiggen_tpu_torch.parallel import make_mesh

        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = BODIES[body](make_mesh(), payload)
        torch.save(out, os.path.join(tmp, f"out_{body}_{rank}.pt"))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------------------ the pieces
def pieces(mesh, payload):
    """The deterministic pieces on the payload's numpy inputs: the
    edge-sharded SpMM, the halo SpMM forward and gradient per combiner, and
    the row-sharded gathers and scatters."""
    from embiggen_tpu_torch.parallel import (
        build_halo_partition, edge_shard_kernel, halo_spmm, resolve_mesh, shard_features,
        sharded_spmm,
    )
    from embiggen_tpu_torch.parallel.sharded_table import (
        _gather_rows, _mean_scatter_owned, _scatter_add_owned, shard_rows,
    )

    out = {}
    rows, cols, vals, x = payload["spmm"]
    k = edge_shard_kernel(rows, cols, vals, x.shape[0], mesh.size, mesh.rank,
                          device=mesh.device)
    out["sharded_spmm"] = _np(sharded_spmm(mesh, k, torch.from_numpy(x)))

    rows, cols, vals, x, g_out = payload["halo"]
    n = x.shape[0]
    part = build_halo_partition(rows, cols, vals, n, mesh.size, device=mesh.device,
                                shards=[mesh.rank])
    s = part.shard_size
    for combiner in ("sum", "mean", "sqrtn"):
        x_local = shard_features(x, part, mesh).requires_grad_()
        y = halo_spmm(mesh, part, x_local, combiner)
        g = torch.zeros((s, x.shape[1]))
        own = torch.from_numpy(g_out[mesh.rank * s:(mesh.rank + 1) * s])
        g[:own.shape[0]] = own
        (grad,) = torch.autograd.grad((y * g).sum(), x_local)
        out[f"halo_{combiner}"] = (_np(y), _np(grad))

    table, bias, idx, grads, bgrads, lr = payload["tables"]
    idx_t = torch.from_numpy(idx)
    for name, t, gr in (("table", table, grads), ("bias", bias, bgrads)):
        shard = shard_rows(torch.from_numpy(t), mesh)
        gr = torch.from_numpy(gr)
        out[f"gather_{name}"] = _np(_gather_rows(shard, idx_t, mesh))
        out[f"scatter_add_{name}"] = _np(_scatter_add_owned(shard.clone(), idx_t, gr, mesh))
        # Two segments of one multiset, as LINE's context rows and negatives.
        half = idx.shape[0] // 2
        seg, gseg = (idx_t[:half], idx_t[half:]), (gr[:half], gr[half:])
        mean, counts = _mean_scatter_owned(shard.clone(), seg, gseg, lr, mesh)
        out[f"mean_scatter_{name}"] = _np(mean)
        out[f"mean_counts_{name}"] = _np(counts)

    # resolve_mesh: a mesh of the first 2 ranks; outside it a rank raises.
    if mesh.size > 2:
        try:
            sub = resolve_mesh(2)
            out["sub_mesh"] = (sub.size, sub.rank)
        except ValueError as e:
            out["sub_mesh"] = str(e)
    return out


# -------------------------------------------------------- functional steps
def steps(mesh, payload):
    """The functional steps: row-sharded against dim-sharded on the same
    batches, the data-parallel step against the single-device step and its
    replication, and the sharded GCN step's losses."""
    from embiggen_tpu_torch.graph import erdos_renyi, karate_club
    from embiggen_tpu_torch.graph.laplacians import kernel_coo
    from embiggen_tpu_torch.parallel import (
        build_halo_partition, make_dp_skipgram_step, make_row_sharded_skipgram_step,
        make_sharded_gcn_edge_step, make_sharded_skipgram_step, shard_features,
        shard_rows_skipgram_params, shard_skipgram_params,
    )
    from embiggen_tpu_torch.parallel.mesh import all_gather
    from embiggen_tpu_torch.parallel.sharded_table import (
        draw_pair_batch, skipgram_pair_step, unshard_rows,
    )

    out = {}
    g = karate_club()
    tg = g.device("cpu")
    params = {k: torch.from_numpy(v) for k, v in payload["skipgram"].items()}
    kw = dict(batch_size=16, walk_length=12, window_size=2, number_of_negative_samples=8)
    rows = shard_rows_skipgram_params(params, mesh)
    dim = shard_skipgram_params(params, mesh)
    step_rows = make_row_sharded_skipgram_step(mesh, tg, **kw)
    step_dim = make_sharded_skipgram_step(mesh, tg, **kw)
    gen_r, gen_d = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    losses = [(float(step_rows(rows, gen_r, 0.5)), float(step_dim(dim, gen_d, 0.5)))
              for _ in range(10)]
    out["rows_vs_dim"] = (losses,
                          _np(unshard_rows(rows["node_embedding"], mesh, g.number_of_nodes)),
                          _np(all_gather(dim["node_embedding"].T.contiguous(), mesh).T),
                          _np(rows["node_embedding"]))

    er = erdos_renyi(120, 700, seed=2)
    etg = er.device("cpu")
    dp = {k: torch.from_numpy(v) for k, v in payload["dp"].items()}
    single = {k: v.clone() for k, v in dp.items()}
    step = make_dp_skipgram_step(mesh, etg, batch_size=64, walk_length=12, window_size=2,
                                 number_of_negative_samples=6)
    gen = torch.Generator().manual_seed(10)
    dp_losses, single_losses = [], []
    for _ in range(8):
        batch = draw_pair_batch(etg, gen, 64, 12, 2, number_of_negative_samples=6)
        dp_losses.append(float(step(dp, None, 0.1, batch=batch)))
        single_losses.append(float(skipgram_pair_step(single, *batch, 0.1)))
    out["dp"] = (dp_losses, single_losses, {k: _np(v) for k, v in dp.items()},
                 {k: _np(v) for k, v in single.items()})

    coo = kernel_coo(g, "Symmetric Normalized Laplacian")
    part = build_halo_partition(*coo, g.number_of_nodes, mesh.size, device=mesh.device,
                                shards=[mesh.rank])
    x = shard_features(payload["gcn_x"], part, mesh)
    lr = 1.0
    init, gcn_step = make_sharded_gcn_edge_step(mesh, part, x, tg, units=[16, 8],
                                                batch_size=128, learning_rate=lr)
    gcn_params = init(torch.Generator().manual_seed(0))
    # One step's parameter change against autograd of the same model and
    # batch with a dense [N, N] kernel on one process.
    before = [t.clone() for t in _gcn_leaves(gcn_params)]
    gcn_step(gcn_params, torch.Generator().manual_seed(1))
    want = _dense_gcn_grads(before, coo, g.number_of_nodes, payload["gcn_x"], tg,
                            torch.Generator().manual_seed(1))
    out["gcn_grad_err"] = max(
        float(((b - a) / lr - w).abs().max())
        for b, a, w in zip(before, _gcn_leaves(gcn_params), want))
    gen = torch.Generator().manual_seed(2)
    out["gcn_losses"] = [float(gcn_step(gcn_params, gen)) for _ in range(150)]
    return out


def _gcn_leaves(params):
    return [t for layer in params["conv"] for t in (layer["w"], layer["b"])] + [
        params["head"]["w"], params["head"]["b"]]


def _dense_gcn_grads(leaves, coo, n, x, tg, generator):
    """The sharded GCN step's gradients by autograd of the same model on
    one process, with the kernel as a dense [N, N] matrix."""
    import torch.nn.functional as F

    from embiggen_tpu_torch.ops.negatives import edge_prediction_mini_batch

    rows, cols, vals = (torch.from_numpy(np.asarray(a)) for a in coo)
    a = torch.zeros((n, n)).index_put_((rows.long(), cols.long()), vals.float(),
                                       accumulate=True)
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    h = torch.from_numpy(x)
    for i in range(0, len(leaves) - 2, 2):
        h = torch.relu((a @ h) @ leaves[i] + leaves[i + 1])
    src, dst, labels = edge_prediction_mini_batch(tg, generator, 128, negative_samples_rate=0.5,
                                                  use_scale_free_distribution=True)
    logits = (h[src.long()] * h[dst.long()]) @ leaves[-2] + leaves[-1]
    return torch.autograd.grad((F.softplus(logits) - labels * logits).mean(), leaves)


# ------------------------------------------------------------- the models
EMB_KWARGS = dict(embedding_size=8, epochs=2, batch_size=16, walk_length=8, window_size=2,
                  number_of_negative_samples=4, random_state=7, device="cpu")
MINIBATCH_KWARGS = dict(embedding_size=8, epochs=2, batch_size=64, random_state=7,
                        device="cpu")
WALKLETS_KWARGS = dict(embedding_size=8, power=2, epochs=2, batch_size=16, walk_length=8,
                       window_size=2, number_of_negative_samples=4, random_state=7,
                       device="cpu")
GLOVE_KWARGS = dict(embedding_size=8, epochs=2, walk_length=8, window_size=2, iterations=1,
                    batch_size=64, random_state=7, device="cpu")
WALKLETS_GLOVE_KWARGS = dict(embedding_size=8, power=2, epochs=2, walk_length=8,
                             window_size=2, batch_size=16, random_state=7, device="cpu")
ROLE2VEC_KWARGS = dict(embedding_size=8, epochs=2, batch_size=16, walk_length=8,
                       window_size=2, number_of_negative_samples=4, random_state=7,
                       device="cpu")
NODEPIECE_KWARGS = dict(MINIBATCH_KWARGS, number_of_anchors=8, tokens_per_node=2)
GCN_KWARGS = dict(units=[16], tower_units=[8], head_units=[8], epochs=3, batch_size=64,
                  random_state=0, device="cpu")


def typed_karate():
    """Karate with an edge type per arc: whether its ends' clubs differ."""
    from embiggen_tpu_torch.graph import karate_club

    g = karate_club()
    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    return dataclasses.replace(g, edge_types=etypes)


def sbm():
    from embiggen_tpu_torch.graph.generators import planted_partition

    return planted_partition(n_nodes=200, n_communities=3, p_in=0.12, p_out=0.01, seed=1)


# (label, model name, kwargs, graph, extra constructor arguments)
MESH_FITS = (
    ("SkipGram data", "Node2Vec SkipGram", EMB_KWARGS, "karate", dict(distribution="data")),
    ("SkipGram rows", "Node2Vec SkipGram", EMB_KWARGS, "karate", dict(distribution="rows")),
    ("CBOW data", "Node2Vec CBOW", EMB_KWARGS, "karate", dict(distribution="data")),
    ("CBOW rows", "Node2Vec CBOW", EMB_KWARGS, "karate", dict(distribution="rows")),
    ("SkipGram p/q auto", "Node2Vec SkipGram",
     dict(EMB_KWARGS, return_weight=2.0, explore_weight=0.5), "karate", dict(mesh="auto")),
    ("DeepWalk CBOW data", "DeepWalk CBOW", EMB_KWARGS, "karate", dict(distribution="data")),
    ("First-order LINE data", "First-order LINE", MINIBATCH_KWARGS, "typed", {}),
    ("Second-order LINE data", "Second-order LINE", MINIBATCH_KWARGS, "typed", {}),
    ("TransE data", "TransE", MINIBATCH_KWARGS, "typed", {}),
    ("First-order LINE rows", "First-order LINE", MINIBATCH_KWARGS, "typed",
     dict(distribution="rows")),
    ("Second-order LINE rows", "Second-order LINE", MINIBATCH_KWARGS, "typed",
     dict(distribution="rows")),
    ("TransE rows", "TransE", MINIBATCH_KWARGS, "typed", dict(distribution="rows")),
    ("RotatE data", "RotatE", MINIBATCH_KWARGS, "typed", {}),
    ("RotatE rows", "RotatE", MINIBATCH_KWARGS, "typed", dict(distribution="rows")),
    ("NodePiece data", "NodePiece", NODEPIECE_KWARGS, "typed", {}),
    ("Walklets SkipGram data", "Walklets SkipGram", WALKLETS_KWARGS, "karate",
     dict(distribution="data")),
    ("Walklets CBOW data", "Walklets CBOW", WALKLETS_KWARGS, "karate",
     dict(distribution="data")),
    ("GloVe data", "Node2Vec GloVe", GLOVE_KWARGS, "karate", {}),
    ("GloVe rows", "Node2Vec GloVe", GLOVE_KWARGS, "karate", dict(distribution="rows")),
    ("Walklets GloVe data", "Walklets GloVe", WALKLETS_GLOVE_KWARGS, "karate", {}),
    ("Role2Vec data", "Role2Vec", ROLE2VEC_KWARGS, "karate", {}),
)

def karate():
    from embiggen_tpu_torch.graph import karate_club

    return karate_club()


GRAPHS = {"karate": karate, "typed": typed_karate}


def mesh_fit(label, model_name, kwargs, graph, extra, mesh=None):
    """The first node embedding of one fit of `model_name` (on `mesh` when
    given, else as `extra` says), as numpy."""
    from embiggen_tpu_torch.models import get_model_from_library

    cls = get_model_from_library(model_name, task_name="Node Embedding")
    extra = dict(extra)
    if mesh is not None:
        extra.setdefault("mesh", mesh.size)
    else:
        extra = {}
    result = cls(**kwargs, **extra).fit_transform(GRAPHS[graph]())
    return np.asarray(result.node_embeddings[0])


def gcn_fit(dropout_rate, mesh=None):
    """predict_proba of a Kipf GCN edge predictor fitted on the planted
    partition (on `mesh` when given)."""
    from embiggen_tpu_torch.models.gcn import KipfGCNEdgePrediction

    g = sbm()
    extra = {} if mesh is None else dict(mesh=mesh.size)
    m = KipfGCNEdgePrediction(**GCN_KWARGS, dropout_rate=dropout_rate, **extra)
    m.fit(g)
    return m.predict_proba(g), m


def models(mesh, payload):
    """Every distributable row through its entry point on the mesh, the
    fallback warnings (a model without the hooks; NodePiece, which has no
    node-row table to shard), and the edge GCN with and without dropout."""
    from embiggen_tpu_torch.graph import karate_club
    from embiggen_tpu_torch.models.embedders import SkipGram

    out = {label: mesh_fit(label, name, kw, graph, extra, mesh)
           for label, name, kw, graph, extra in MESH_FITS
           if payload is None or label in payload}

    class NoMeshSkipGram(SkipGram):
        @classmethod
        def supports_distribution(cls):
            return False

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        emb = NoMeshSkipGram(**EMB_KWARGS, mesh=mesh.size).fit_transform(karate_club())
    out["fallback"] = ([str(w.message) for w in caught], np.asarray(emb.node_embeddings[0]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        emb = mesh_fit("NodePiece rows", "NodePiece", NODEPIECE_KWARGS, "typed",
                       dict(distribution="rows"), mesh)
    out["NodePiece rows"] = ([str(w.message) for w in caught], emb)
    for rate in (0.0, 0.5):
        proba, m = gcn_fit(rate, mesh)
        out[f"gcn dropout {rate}"] = (proba, m._history)
    return out


NODE_LABEL_GCN_KWARGS = dict(units=[16, 16], head_units=[8], epochs=5, random_state=0,
                             device="cpu")


def node_label_gcn_fit(dropout_rate, mesh=None):
    """(predict_proba, loss history) of a Kipf GCN node-label model fitted
    on the planted partition (on `mesh` when given), the mirror of the
    reference's tests/test_mesh_models.py node-label case."""
    from embiggen_tpu_torch.models.gcn import KipfGCNNodeLabelPrediction

    g = sbm()
    extra = {} if mesh is None else dict(mesh=mesh.size)
    m = KipfGCNNodeLabelPrediction(**NODE_LABEL_GCN_KWARGS, dropout_rate=dropout_rate, **extra)
    m.fit(g)
    return m.predict_proba(g), m._history


def node_label(mesh, payload):
    """The node-label GCN on the mesh, without and with dropout."""
    return {rate: node_label_gcn_fit(rate, mesh) for rate in (0.0, 0.5)}


def resume(mesh, payload):
    """SkipGram over the mesh (payload["distribution"]) on karate: an
    uninterrupted fit, a fit with `checkpoint_dir=payload["dir"]` killed
    after payload["saves"] saves (each rank raising once the save, which
    rank 0 writes and every rank waits for, is done), and its resumed fit.
    Returns the two fits' tables and the checkpoint files after each."""
    import embiggen_tpu_torch.utils.checkpoint as ck
    from embiggen_tpu_torch.models.embedders import SkipGram

    kw = dict(EMB_KWARGS, epochs=4, early_stopping_patience=100, mesh=mesh.size,
              distribution=payload["distribution"])
    directory = payload["dir"]
    full = SkipGram(**kw).fit_transform(karate()).node_embeddings
    real, left = ck.FitCheckpoint.save, [payload["saves"]]

    def save_then_kill(self, state):
        real(self, state)
        left[0] -= 1
        if left[0] <= 0:
            raise KeyboardInterrupt("simulated kill")

    ck.FitCheckpoint.save = save_then_kill
    killed = False
    try:
        SkipGram(**kw, checkpoint_dir=directory).fit_transform(karate())
    except KeyboardInterrupt:
        killed = True
    finally:
        ck.FitCheckpoint.save = real
    after_kill = sorted(os.listdir(directory))
    resumed = SkipGram(**kw, checkpoint_dir=directory).fit_transform(karate()).node_embeddings
    dist.barrier()
    return dict(full=[np.asarray(e) for e in full], resumed=[np.asarray(e) for e in resumed],
                killed=killed, after_kill=after_kill, after_resume=sorted(os.listdir(directory)))


BODIES = {"pieces": pieces, "steps": steps, "models": models, "node_label": node_label,
          "resume": resume}
