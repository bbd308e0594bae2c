"""One step of every multi-device path of the port on n ranks — the port's
counterpart of `__graft_entry__.py::dryrun_multichip`.

Spawns n processes, one torch.distributed rank each: NCCL ranks, one card
each, where n cards exist, and gloo ranks on the CPU where no card does or
`--backend gloo` asks for them. Fewer than n cards raises, unless gloo is
asked for. Each rank runs, on a
small Erdős–Rényi graph, one step of the dim-sharded, row-sharded and
data-parallel SkipGram steps, the edge-sharded and the halo-exchange SpMM
(forward and backward), the sharded GCN edge step, and one step of the
walk models' data-parallel and row-sharded paths, and checks every result
finite. Prints one JSON line: the ranks, the backend, rank 0's device and
its results.

    python -m embiggen_tpu_torch.scripts.dryrun_multichip --n 2 [--backend gloo]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 300.0


def run_steps(mesh) -> Dict[str, float]:
    """One step of each distributed path on this rank; {path: loss or
    output sum}. Raises if a result is not finite."""
    from ..graph import erdos_renyi
    from ..graph.laplacians import kernel_coo
    from ..models.embedders import SkipGram
    from ..parallel import (
        build_halo_partition, edge_shard_kernel, halo_spmm, make_dp_skipgram_step,
        make_row_sharded_skipgram_step, make_sharded_gcn_edge_step,
        make_sharded_skipgram_step, shard_features, shard_rows_skipgram_params,
        shard_skipgram_params, sharded_spmm,
    )

    dev = mesh.device
    graph = erdos_renyi(256, 2048, seed=0)
    tg = graph.device(dev, with_sources=True)
    n, d = graph.number_of_nodes, 16 * mesh.size
    rng = np.random.default_rng(0)
    params = {"node_embedding": torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
              "context_embedding": torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
              "context_bias": torch.zeros(n)}
    kw = dict(batch_size=8 * mesh.size, walk_length=16, window_size=4,
              number_of_negative_samples=10)
    out = {}
    for name, make, place in (
            ("dim-sharded SkipGram", make_sharded_skipgram_step, shard_skipgram_params),
            ("row-sharded SkipGram", make_row_sharded_skipgram_step,
             shard_rows_skipgram_params),
            ("data-parallel SkipGram", make_dp_skipgram_step,
             lambda p, m: {k: v.to(m.device) for k, v in p.items()})):
        step = make(mesh, tg, **kw)
        out[name] = float(step(place(params, mesh), torch.Generator().manual_seed(1), 0.05))

    rows, cols, vals = kernel_coo(graph, "Symmetric Normalized Laplacian")
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    k = edge_shard_kernel(rows, cols, vals, n, mesh.size, mesh.rank, device=dev)
    out["edge-sharded SpMM"] = float(sharded_spmm(mesh, k, x.to(dev)).sum())
    part = build_halo_partition(rows, cols, vals, n, mesh.size, device=dev,
                                shards=[mesh.rank])
    x_local = shard_features(x, part, mesh).requires_grad_()
    y = halo_spmm(mesh, part, x_local, "mean")
    (grad,) = torch.autograd.grad(y.sum(), x_local)
    out["halo SpMM"] = float(y.detach().sum())
    out["halo SpMM backward"] = float(grad.sum())
    init, gcn_step = make_sharded_gcn_edge_step(mesh, part, x_local.detach(), tg, units=[8],
                                                batch_size=64)
    out["sharded GCN step"] = float(gcn_step(init(torch.Generator().manual_seed(0)),
                                             torch.Generator().manual_seed(1)))

    for distribution in ("data", "rows"):
        model = SkipGram(embedding_size=d, walk_length=16, window_size=4, random_state=0,
                         device=dev)
        model._run_batch_size = batch = 8 * mesh.size
        g = torch.Generator().manual_seed(0)
        tables = model._initial_tables(graph, g)
        if distribution == "data":
            step = model._make_dp_step(mesh, batch)
        else:
            step = model._make_row_sharded_step(mesh, batch)
            tables = shard_rows_skipgram_params(tables, mesh)
        out[f"SkipGram {distribution}"] = float(step(model._device_graph(graph), tables, g,
                                                     0.05))
    bad = {k: v for k, v in out.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"rank {mesh.rank}: not finite: {bad}")
    return out


def _rank(rank: int, world: int, store: str, backend: str, result: str) -> None:
    from ..parallel import make_mesh

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(device=torch.device("cuda", rank) if backend == "nccl" else None)
        out = run_steps(mesh)
        if rank == 0:
            with open(result, "w") as f:
                json.dump({"device": str(mesh.device), "results": out}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, backend: Optional[str] = None) -> Dict[str, Any]:
    """Spawn n ranks, run `run_steps` on each, and return {"backend",
    "device": rank 0's, "results": rank 0's}; raises if a rank fails or the
    ranks do not end within DEADLINE_S. `backend` None picks NCCL where
    there are cards (one a rank: fewer than n raises) and gloo on the CPU
    where there are none; "gloo" runs CPU ranks whatever the cards."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if cards else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'.")
    if backend == "nccl" and cards < n:
        raise ValueError(f"{n} NCCL ranks need {n} cards, and {cards} are visible; "
                         "pass backend='gloo' (--backend gloo) for CPU ranks.")
    with tempfile.TemporaryDirectory() as tmp:
        store, result = os.path.join(tmp, "store"), os.path.join(tmp, "result.json")
        ctx = mp.start_processes(_rank, args=(n, store, backend, result), nprocs=n,
                                 join=False, start_method="spawn")
        end = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"the {n} ranks did not end within {DEADLINE_S} s")
        with open(result) as f:
            return {"backend": backend, **json.load(f)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=2, help="ranks to spawn")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="NCCL ranks on n cards, or gloo ranks on the CPU (default: "
                        "NCCL where there are cards, else gloo)")
    args = parser.parse_args()
    print(json.dumps({"ranks": args.n, **dryrun_multichip(args.n, args.backend)}))


if __name__ == "__main__":
    main()
