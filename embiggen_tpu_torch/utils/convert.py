"""Carry JAX-side parameter tables into the port as tensors, so both
packages can start training from the same tables."""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

SKIPGRAM_KEYS = ("node_embedding", "context_embedding", "context_bias")
CBOW_KEYS = ("node_embedding", "output_embedding", "output_bias")
ROLE2VEC_KEYS = ("node_embedding", "role_embedding")


def _tables_from_jax(params, keys, model, device) -> Dict[str, torch.Tensor]:
    missing = [k for k in keys if k not in params]
    if missing:
        raise KeyError(f"Missing {model} tables: {missing}")
    return {
        k: torch.from_numpy(np.array(params[k], dtype=np.float32)).to(device)
        for k in keys
    }


def skipgram_params_from_jax(
    params: Mapping[str, np.ndarray], device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """SkipGram tables (`node_embedding`, `context_embedding`,
    `context_bias`, as numpy arrays, e.g. `np.asarray` of the JAX model's
    params) as float32 tensors on `device`, in the layout the port's
    SkipGram takes as `initial_params`."""
    return _tables_from_jax(params, SKIPGRAM_KEYS, "SkipGram", device)


def cbow_params_from_jax(
    params: Mapping[str, np.ndarray], device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """CBOW tables (`node_embedding`, `output_embedding`, `output_bias`, as
    numpy arrays) as float32 tensors on `device`, in the layout the port's
    CBOW takes as `initial_params`."""
    return _tables_from_jax(params, CBOW_KEYS, "CBOW", device)


def walklets_params_from_jax(
    params: Mapping[str, np.ndarray], device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """Walklets' stacked tables (`node_embedding`, `context_embedding`
    [P, N, sub] and `context_bias` [P, N], as numpy arrays) as float32
    tensors on `device`, in the layout the port's Walklets models take as
    `initial_params`."""
    out = _tables_from_jax(params, SKIPGRAM_KEYS, "Walklets", device)
    p, n, _ = out["node_embedding"].shape
    if out["context_embedding"].shape != out["node_embedding"].shape or \
            tuple(out["context_bias"].shape) != (p, n):
        raise ValueError("Walklets tables must be [P, N, sub], [P, N, sub] and [P, N]; got "
                         f"{[tuple(out[k].shape) for k in SKIPGRAM_KEYS]}")
    return out


def role2vec_params_from_jax(
    params: Mapping[str, np.ndarray], device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """Role2Vec's tables (`node_embedding` [N, D], `role_embedding`
    [roles, D], as numpy arrays) as float32 tensors on `device`, in the
    layout the port's Role2Vec takes as `initial_params`."""
    return _tables_from_jax(params, ROLE2VEC_KEYS, "Role2Vec", device)


def minibatch_params_from_jax(params: Mapping[str, np.ndarray], model, graph) -> Dict[str, torch.Tensor]:
    """The tables of a JAX minibatch embedder (LINE, the siamese models, the
    21 KGE models with NodePiece's anchor and encoder tables, GloVe; its
    `_init_params` dict as numpy arrays) as float32 tensors on
    `model.device`, in the layout the port's model takes as
    `initial_params`. The keys and shapes must be the ones the port's
    `model` gives `graph`."""
    shapes = model._param_shapes(graph.number_of_nodes, graph.number_of_edge_types)
    if set(params) != set(shapes):
        raise KeyError(f"{model.model_name()} tables {sorted(shapes)}, got {sorted(params)}")
    out = _tables_from_jax(params, tuple(shapes), model.model_name(), model.device)
    for name, shape in shapes.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{model.model_name()} table {name!r} has shape "
                             f"{tuple(out[name].shape)}, expected {shape}")
    return out


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def gcn_params_from_jax(params: Mapping, model) -> Dict:
    """A fitted or built JAX GCN parameter tree as the port's tree of
    float32 tensors on `model.device` (numpy leaves, dense layers as {"w":
    [in, out], "b": [out]}; "embed" holds "node_embedding" and
    "node_type_embedding" [n_node_types + 1, d] when used). Two layouts:

    - an edge GCN's (edge prediction and edge label), `{"embed", "enc":
      {"kernels"}, "src_tower", "dst_tower"?, "head",
      "edge_type_embedding"?}`: its head is as wide as its edge
      representation (the combined towers, then each lazy and static
      feature's width, the edge metrics, the edge-type feature tables and
      the edge-type embedding [n_edge_types + 1, d]) and ends in
      `model._n_outputs` (1 for edge prediction, max(edge types, 2) for
      edge labels); the feature models and feature tables hold no
      parameters;
    - a node-label GCN's, `{"embed", "enc": {"kernels"}, "head"}`, its head
      ending in `model._n_classes`.

    When `model` already holds parameters (`_params`, built with the same
    features), the two trees must have the same structure and shapes; when
    it knows its outputs, the head must end in them."""
    out = _tree_to_torch(dict(params), model.device)
    held = getattr(model, "_params", None)
    if held is not None and _shapes(held) != _shapes(out):
        raise ValueError("The JAX parameter tree does not match the model's: "
                         f"{_shapes(out)} vs {_shapes(held)}")
    outputs = getattr(model, "_n_outputs", getattr(model, "_n_classes", None))
    width = int(out["head"][-1]["b"].shape[0])
    if outputs is not None and width != outputs:
        raise ValueError(f"The JAX head ends in {width} outputs; the model has {outputs}.")
    return out


def perceptron_params_from_jax(
    w: np.ndarray, b: float, mean: np.ndarray, std: np.ndarray,
    device: Union[str, torch.device],
) -> Dict[str, torch.Tensor]:
    """A fitted JAX Perceptron's weights, bias and feature normalization
    (`_w`, `_b`, `_mean`, `_std`) as the port's `_linear` tensors on
    `device`."""
    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {"w": put(w), "b": put(b), "mean": put(mean), "std": put(std)}


# The random draws of each factorization model's fit, by name: what its
# `initial_state` returns and its `run` takes.
FACTORIZATION_STATE_KEYS = {
    "NetMF": (), "GraRep": (), "BoostNE": ("w", "h"), "RandNE": ("base",),
    "NodeSketch": ("race0", "noise"), "MNMF": ("m", "u", "h", "c"),
    "NMFADMM": ("w", "h"), "NNSED": ("w",),
}


def factorization_state_from_jax(
    model_name: str, draws: Mapping, device: Union[str, torch.device]
) -> Dict:
    """The JAX model's random draws (numpy arrays, made with the same
    `jax.random` calls its fit makes) as the port's state for `run`: float32
    tensors on `device`, a list of them where the draw is one per block or
    round (BoostNE's `w` and `h`, NodeSketch's `noise`)."""
    if model_name not in FACTORIZATION_STATE_KEYS:
        raise ValueError(f"{model_name!r} is not a factorization model with a state; "
                         f"expected one of {sorted(FACTORIZATION_STATE_KEYS)}")
    keys = FACTORIZATION_STATE_KEYS[model_name]
    missing = [k for k in keys if k not in draws]
    if missing:
        raise KeyError(f"Missing {model_name} draws: {missing}")

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {k: [put(a) for a in draws[k]] if isinstance(draws[k], (list, tuple))
            else put(draws[k]) for k in keys}


def halo_partition_from_jax(part, device: Union[str, torch.device] = "cpu", shards=None):
    """A JAX `HaloPartition` (its numpy-convertible array leaves and sizes)
    as the port's, with the device plans of `shards` (all by default): each
    shard's local and halo ELL blocks and overflow COO (zero-weight padding
    dropped) become its CSR over [own rows | halo buffer], and each
    boundary set is the send slots its reader's halo columns reach."""
    from ..parallel.halo import HaloPartition, halo_shard

    p, s, h = part.n_shards, part.shard_size, part.halo_width
    send_idx = np.asarray(part.send_idx, np.int32)
    absw, sqw = np.asarray(part.abs_wsum, np.float32), np.asarray(part.sq_wsum, np.float32)
    arrays = {name: np.asarray(getattr(part, name)) for name in (
        "ell_cols_local", "ell_vals_local", "ov_rows_local", "ov_cols_local", "ov_vals_local",
        "ell_cols_halo", "ell_vals_halo", "ov_rows_halo", "ov_cols_halo", "ov_vals_halo")}

    def coo(dev, side, offset):
        cols, vals = arrays[f"ell_cols_{side}"][dev], arrays[f"ell_vals_{side}"][dev]
        rows = np.repeat(np.arange(s), cols.shape[1])
        r = np.concatenate([rows, arrays[f"ov_rows_{side}"][dev]])
        c = np.concatenate([cols.reshape(-1), arrays[f"ov_cols_{side}"][dev]])
        v = np.concatenate([vals.reshape(-1), arrays[f"ov_vals_{side}"][dev]])
        keep = v != 0
        return r[keep], c[keep] + offset, v[keep]

    boundary, built = {}, {}
    for dev in range(p):
        halo_cols = coo(dev, "halo", 0)[1]
        for q in range(p):
            if q != dev:
                slots = halo_cols[(halo_cols >= q * h) & (halo_cols < (q + 1) * h)] - q * h
                width = int(slots.max()) + 1 if slots.size else 0
                boundary[(q, dev)] = send_idx[q, dev, :width].astype(np.int64) + q * s
        if shards is None or dev in shards:
            r, c, v = (np.concatenate(a) for a in zip(coo(dev, "local", 0), coo(dev, "halo", s)))
            built[dev] = halo_shard(r, c, v, s + p * h, send_idx[dev], absw[dev], sqw[dev],
                                    device)
    return HaloPartition(send_idx=send_idx, abs_wsum=absw, sq_wsum=sqw, boundary=boundary,
                         n_shards=p, shard_size=s, halo_width=h, n_nodes=part.n_nodes,
                         comm_rows=part.comm_rows, shards=built)


def row_shard_from_jax(table, n_shards: int, rank: int,
                       device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Rank `rank`'s rows of a JAX row-sharded table (padded to a multiple
    of `n_shards` rows; `np.asarray` of it) as a float32 tensor on
    `device`, the layout the port's row-sharded steps hold."""
    table = np.asarray(table, np.float32)
    if table.shape[0] % n_shards:
        raise ValueError(f"a row-sharded table of {table.shape[0]} rows over {n_shards} "
                         "shards is not padded.")
    s = table.shape[0] // n_shards
    return torch.from_numpy(table[rank * s:(rank + 1) * s].copy()).to(device)
