"""Distances and the siamese margin loss — counterpart of
`embiggen_tpu/ops/losses.py` (`l1_distance`, `squared_l2_distance`,
`margin_loss`). Plain differentiable torch on gathered rows, so the
gradients stay sparse and the training loops scatter them back into the
tables."""
from __future__ import annotations

import torch


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at x = 0 and -0, where torch.abs's is
    0, so a difference that is exactly zero moves the tables as in the
    reference."""
    return torch.where(x >= 0, x, -x)


def l1_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return absolute(a - b).sum(dim=-1)


def squared_l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).sum(dim=-1)


def margin_loss(
    pos_distance: torch.Tensor, neg_distance: torch.Tensor, bias: float = 1.0
) -> torch.Tensor:
    """Siamese margin loss: the mean of ReLU(bias + d(pos) - d(neg));
    `relu_bias` is the margin. torch.maximum splits the gradient at a tie, as
    jnp.maximum does."""
    margin = bias + pos_distance - neg_distance
    return torch.maximum(margin, margin.new_zeros(())).mean()
