"""Functional multi-device SkipGram steps — counterpart of
`embiggen_tpu/parallel/embedder.py` (`shard_skipgram_params`,
`make_sharded_skipgram_step`, `make_dp_skipgram_step`).

- Dim-sharded: the tables' columns are cut over the mesh (D / P a rank),
  the bias replicated. A row gather is a local column-slice gather; the
  only collective is one all-reduce of the partial dot products, after
  which the logit adjoints are replicated and every rank updates its own
  columns (K17c with every row owned).
- Data-parallel: the tables are replicated; every rank draws the same
  global batch, takes the gradients of its slice of the pairs, and the
  sparse (index, gradient row) payloads are all-gathered in rank order, so
  every rank applies the same global update (K17c with every row owned).

Each step is step(params, generator, lr[, batch]) -> loss, in place on
this rank's tables.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..graph.graph import TorchGraph
from ..ops.sharded import owned_scatter
from .mesh import Mesh, all_gather, all_reduce
from .sharded_table import _apply_pair_updates, draw_pair_batch, nce_pair_grads


def _add(t, i, u):
    return owned_scatter(t, 0, i.int().contiguous(), u.contiguous(), 1.0)


def shard_skipgram_params(params: Dict[str, torch.Tensor], mesh: Mesh
                          ) -> Dict[str, torch.Tensor]:
    """This rank's column slices of the two [N, D] tables (D divisible by
    the mesh size) and the whole bias, on the mesh's device."""
    d = params["node_embedding"].shape[1]
    if d % mesh.size:
        raise ValueError(f"embedding width {d} is not divisible by {mesh.size} ranks.")
    w = d // mesh.size
    cols = slice(mesh.rank * w, (mesh.rank + 1) * w)
    return {
        "node_embedding": params["node_embedding"][:, cols].contiguous().to(mesh.device),
        "context_embedding": params["context_embedding"][:, cols].contiguous().to(mesh.device),
        "context_bias": params["context_bias"].clone().to(mesh.device),
    }


def make_sharded_skipgram_step(
    mesh: Mesh, tg: TorchGraph, batch_size: int, walk_length: int, window_size: int,
    iterations: int = 1, return_weight: float = 1.0, explore_weight: float = 1.0,
    number_of_negative_samples: int = 10,
):
    """The dim-sharded step over `shard_skipgram_params`' tables."""

    def step(params, generator, lr, batch=None):
        contexts, words, negs = batch if batch is not None else draw_pair_batch(
            tg, generator, batch_size, walk_length, window_size, iterations,
            return_weight, explore_weight, number_of_negative_samples)
        emb, ctx, bias = (params[k] for k in ("node_embedding", "context_embedding",
                                              "context_bias"))
        c, wd, ng = contexts.long(), words.long(), negs.long()
        loss, *grads = nce_pair_grads(emb[wd], ctx[c], ctx[ng], bias[c], bias[ng],
                                      words.shape[0], psum=lambda t: all_reduce(t, mesh))
        _apply_pair_updates(_add, emb, ctx, bias, contexts, words, negs, *grads, lr)
        return loss

    return step


def make_dp_skipgram_step(
    mesh: Mesh, tg: TorchGraph, batch_size: int, walk_length: int, window_size: int,
    iterations: int = 1, return_weight: float = 1.0, explore_weight: float = 1.0,
    number_of_negative_samples: int = 10,
):
    """The data-parallel step over replicated tables: rank p takes pairs
    [p M / P, (p + 1) M / P) of the global batch (M divisible by the mesh
    size), the shared negatives' gradients of all slices are summed, and
    the payloads are exchanged as (index, row) pairs — communication grows
    with the batch, never with [N, D]. Returns the loss of the whole
    batch."""

    def step(params, generator, lr, batch=None):
        contexts, words, negs = batch if batch is not None else draw_pair_batch(
            tg, generator, batch_size, walk_length, window_size, iterations,
            return_weight, explore_weight, number_of_negative_samples)
        m = words.shape[0]
        if m % mesh.size:
            raise ValueError(f"{m} pairs do not split over {mesh.size} ranks.")
        per = m // mesh.size
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
        emb, ctx, bias = (params[k] for k in ("node_embedding", "context_embedding",
                                              "context_bias"))
        c, wd, ng = contexts[sl].long(), words[sl].long(), negs.long()
        loss, g_w, g_cpos, g_cneg, g_bpos, g_bneg = nce_pair_grads(
            emb[wd], ctx[c], ctx[ng], bias[c], bias[ng], m)
        g_w, g_cpos, g_bpos = (all_gather(t, mesh) for t in (g_w, g_cpos, g_bpos))
        g_cneg, g_bneg = all_reduce(g_cneg, mesh), all_reduce(g_bneg, mesh)
        _apply_pair_updates(_add, emb, ctx, bias, contexts, words, negs,
                            g_w, g_cpos, g_cneg, g_bpos, g_bneg, lr)
        return all_reduce(loss, mesh)

    return step
