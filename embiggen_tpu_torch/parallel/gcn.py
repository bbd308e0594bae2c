"""A multi-device GCN edge-prediction training step over node-sharded
features — counterpart of `embiggen_tpu/parallel/gcn.py`
(`init_sharded_gcn_params`, `make_sharded_gcn_edge_step`).

Each convolution is the halo-exchange SpMM (`parallel.halo.halo_spmm`), so
per-layer communication is the boundary rows; the dense layers run on each
rank's own rows. The edge head reads the source and destination rows of an
edge minibatch (K6, the same batch on every rank) from the all-gathered
representations, which every rank then scores alike. The weights are
replicated: the convolution weights' gradients, each rank's share from its
own rows, are summed over the mesh, the head's are whole on every rank,
and plain SGD (in place of optax's) applies them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.graph import TorchGraph
from ..ops.negatives import BatchDraws, edge_prediction_mini_batch
from .halo import HaloPartition, _FromShard, halo_spmm
from .mesh import Mesh, all_reduce


def init_sharded_gcn_params(generator: torch.Generator, in_dim: int, units: Sequence[int],
                            mesh: Mesh) -> Dict:
    """Replicated convolution and head parameters on the mesh's device:
    glorot-uniform layers with zero biases, and a head vector of normal
    entries / sqrt(width). Every rank draws the same values from the same
    generator state."""
    dims = [in_dim] + list(units)
    conv: List[Dict[str, torch.Tensor]] = []
    for i in range(len(units)):
        lim = float(np.sqrt(6.0 / (dims[i] + dims[i + 1])))
        conv.append({"w": torch.empty((dims[i], dims[i + 1])).uniform_(
            -lim, lim, generator=generator), "b": torch.zeros(dims[i + 1])})
    head = {"w": torch.randn((dims[-1],), generator=generator) / np.sqrt(dims[-1]),
            "b": torch.zeros(())}
    move = lambda t: t.to(mesh.device)  # noqa: E731
    return {"conv": [{k: move(v) for k, v in layer.items()} for layer in conv],
            "head": {k: move(v) for k, v in head.items()}}


def make_sharded_gcn_edge_step(
    mesh: Mesh, part: HaloPartition, x_local: torch.Tensor, tg: TorchGraph,
    units: Sequence[int], batch_size: int = 256, combiner: str = "sum",
    learning_rate: float = 0.01,
):
    """(init, step): init(generator) -> params; step(params, generator) ->
    loss, one SGD step in place: the halo-SpMM encoder over this rank's
    feature rows `x_local` [S, D], an edge minibatch with scale-free
    negatives, the Hadamard edge head and the logistic loss. The batches
    are K6's into one `BatchDraws.edges` workspace: on the card the first
    step's generator gives the key and first offset, and each later step
    takes the next offset, so ranks whose first generators agree draw the
    same global batch every step."""
    draws = BatchDraws.edges(batch_size, 0.5, tg.device)

    def init(generator):
        return init_sharded_gcn_params(generator, x_local.shape[1], units, mesh)

    def step(params, generator):
        leaves = [t for layer in params["conv"] for t in (layer["w"], layer["b"])]
        head = [params["head"]["w"], params["head"]["b"]]
        with torch.enable_grad():
            for t in leaves + head:
                t.requires_grad_(True)
            h = x_local
            for layer in params["conv"]:
                h = torch.relu(halo_spmm(mesh, part, h, combiner) @ layer["w"] + layer["b"])
            h = _FromShard.apply(h, mesh)
            src, dst, labels = edge_prediction_mini_batch(
                tg, generator, batch_size, negative_samples_rate=0.5,
                use_scale_free_distribution=True, workspace=draws)
            e = h[src.long()] * h[dst.long()]
            logits = e @ params["head"]["w"] + params["head"]["b"]
            loss = (F.softplus(logits) - labels * logits).mean()
            grads = torch.autograd.grad(loss, leaves + head)
        with torch.no_grad():
            for t, g in zip(leaves, grads[:len(leaves)]):
                t.sub_(learning_rate * all_reduce(g.contiguous(), mesh))
            for t, g in zip(head, grads[len(leaves):]):
                t.sub_(learning_rate * g)
            for t in leaves + head:
                t.requires_grad_(False)
        return loss.detach()

    return init, step
