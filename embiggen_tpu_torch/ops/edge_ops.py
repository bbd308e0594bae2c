"""Edge-embedding operators: combine source and destination node
embeddings into edge features — counterpart of
`embiggen_tpu/ops/edge_ops.py`, with the same method tables. Every operator
takes numpy arrays or torch tensors (`_xp` picks the namespace), so it
serves host feature pipelines and device code alike.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

import numpy as np
import torch

EPS = 1e-6


class _TorchNamespace:
    """The numpy functions the operators use, on torch tensors."""

    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    minimum = staticmethod(torch.minimum)
    maximum = staticmethod(torch.maximum)

    @staticmethod
    def concatenate(arrays, axis=0):
        return torch.cat(list(arrays), dim=axis)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return torch.sum(x, dim=axis, keepdim=keepdims)


def _xp(*arrays):
    """torch (through `_TorchNamespace`) when any input is a tensor, else
    numpy."""
    return _TorchNamespace if any(isinstance(a, torch.Tensor) for a in arrays) else np


def _maximum_scalar(xp, x, eps):
    return x.clamp(min=eps) if xp is _TorchNamespace else np.maximum(x, eps)


def hadamard(src, dst):
    return src * dst


def sum_op(src, dst):
    return src + dst


def average(src, dst):
    return (src + dst) / 2.0


def l1(src, dst):
    """Signed difference (the reference's 'L1')."""
    return src - dst


def absolute_l1(src, dst):
    return _xp(src, dst).abs(src - dst)


def squared_l2(src, dst):
    return (src - dst) ** 2


def l2(src, dst):
    """Element-wise sqrt of the squared difference = |src - dst|."""
    return _xp(src, dst).sqrt((src - dst) ** 2)


def concatenate(src, dst):
    return _xp(src, dst).concatenate([src, dst], axis=-1)


def minimum(src, dst):
    return _xp(src, dst).minimum(src, dst)


def maximum(src, dst):
    return _xp(src, dst).maximum(src, dst)


def l2_distance(src, dst):
    xp = _xp(src, dst)
    return xp.sqrt(xp.sum((src - dst) ** 2, axis=-1, keepdims=True))


def cosine_similarity(src, dst):
    xp = _xp(src, dst)
    num = xp.sum(src * dst, axis=-1, keepdims=True)
    norm = xp.sqrt(
        xp.sum(src ** 2, axis=-1, keepdims=True)
        * xp.sum(dst ** 2, axis=-1, keepdims=True)
    )
    return num / _maximum_scalar(xp, norm, EPS)


def subtract(src, dst):
    return src - dst


def l1_norm(edge_embedding):
    """Row-wise L1 norm of an edge embedding → [B, 1]."""
    xp = _xp(edge_embedding)
    return xp.sum(xp.abs(edge_embedding), axis=-1, keepdims=True)


def l2_norm(edge_embedding):
    """Row-wise L2 norm of an edge embedding → [B, 1]."""
    xp = _xp(edge_embedding)
    return xp.sqrt(xp.sum(edge_embedding ** 2, axis=-1, keepdims=True))


def dot(src, dst):
    return _xp(src, dst).sum(src * dst, axis=-1, keepdims=True)


def l1_norm_op(src, dst):
    """'L1Norm': row L1 norm of the signed difference → [B, 1]."""
    return l1_norm(src - dst)


def l2_norm_op(src, dst):
    """'L2Norm': row L2 norm of the signed difference → [B, 1]."""
    return l2_norm(src - dst)


EDGE_TRANSFORMER_METHODS: Dict[str, Callable] = {
    "Hadamard": hadamard,
    "Sum": sum_op,
    "Average": average,
    "L1": l1,
    "AbsoluteL1": absolute_l1,
    "SquaredL2": squared_l2,
    "L2": l2,
    "Concatenate": concatenate,
    "Min": minimum,
    "Max": maximum,
    "L2Distance": l2_distance,
    "CosineSimilarity": cosine_similarity,
    "L1Norm": l1_norm_op,
    "L2Norm": l2_norm_op,
}

# The edge GCN's combination set.
EDGE_GCN_METHODS: Dict[str, Callable] = {
    "Concatenate": concatenate,
    "Average": average,
    "Hadamard": hadamard,
    "Maximum": maximum,
    "Minimum": minimum,
    "Add": sum_op,
    "Subtract": subtract,
    "L1": absolute_l1,
    "L2": squared_l2,
    "Dot": dot,
}

# The Perceptron's edge-embedding set.
PERCEPTRON_EDGE_METHODS: Dict[str, Callable] = {
    "CosineSimilarity": cosine_similarity,
    "EuclideanDistance": l2_distance,
    "Concatenate": concatenate,
    "Hadamard": hadamard,
    "L1": absolute_l1,
    "L2": squared_l2,
    "Add": sum_op,
    "Sub": subtract,
    "Maximum": maximum,
    "Minimum": minimum,
}


def resolve(method: Union[str, Callable], table: Dict[str, Callable] = None) -> Callable:
    """The operator named `method` in `table` (case-insensitive); a
    callable passes through."""
    if callable(method):
        return method
    table = table or EDGE_TRANSFORMER_METHODS
    for name, fn in table.items():
        if name.lower() == method.lower():
            return fn
    raise ValueError(
        f"Unknown edge-embedding method {method!r}; available: {sorted(table)}"
    )


def output_dim(method: str, embedding_dim: int) -> int:
    """Feature width the operator produces for a node-embedding width."""
    name = method.lower()
    if name == "concatenate":
        return 2 * embedding_dim
    if name in (
        "l2distance", "cosinesimilarity", "dot", "euclideandistance",
        "l1norm", "l2norm",
    ):
        return 1
    return embedding_dim
