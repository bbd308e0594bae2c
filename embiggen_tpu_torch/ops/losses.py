"""Losses and distances — counterpart of `embiggen_tpu/ops/losses.py`: NCE
with shared negatives, sampled softmax, the siamese margin loss, sigmoid
binary cross-entropy and the L1, L2 and squared L2 distances. Plain
differentiable torch on gathered rows, so the gradients stay sparse and the
training loops scatter them back into the tables. Dense formulas, as in the
reference: no kernel."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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


def nce_loss_per_sample(
    center: torch.Tensor,        # [N, D]
    pos_context: torch.Tensor,   # [N, P, D]
    pos_bias: torch.Tensor,      # [N, P]
    neg_context: torch.Tensor,   # [K, D], shared by the batch
    neg_bias: torch.Tensor,      # [K]
) -> torch.Tensor:
    """[N] NCE losses with shared negatives, `tf.nn.nce_loss` with
    num_true = P: each positive carries the target 1/P, so its loss is
    softplus(l) - l / P; a negative's is softplus(l). Unreduced, so that a
    caller holding a slice of the batch can divide by the whole batch."""
    p = pos_context.shape[1]
    pos_logits = torch.einsum("nd,npd->np", center, pos_context) + pos_bias
    neg_logits = center @ neg_context.T + neg_bias[None, :]
    loss_pos = (F.softplus(pos_logits) - pos_logits / p).sum(dim=1)
    return loss_pos + F.softplus(neg_logits).sum(dim=1)


def nce_loss(center, pos_context, pos_bias, neg_context, neg_bias) -> torch.Tensor:
    """The mean of `nce_loss_per_sample`."""
    return nce_loss_per_sample(center, pos_context, pos_bias, neg_context, neg_bias).mean()


def sampled_softmax_loss_per_sample(
    hidden: torch.Tensor,      # [N, D]
    true_emb: torch.Tensor,    # [N, D]
    true_bias: torch.Tensor,   # [N]
    neg_emb: torch.Tensor,     # [K, D], shared by the batch
    neg_bias: torch.Tensor,    # [K]
) -> torch.Tensor:
    """[N] sampled-softmax losses with one true class and K shared sampled
    classes (`tf.nn.sampled_softmax_loss`)."""
    true_logit = (hidden * true_emb).sum(dim=1) + true_bias
    neg_logits = hidden @ neg_emb.T + neg_bias[None, :]
    logits = torch.cat([true_logit[:, None], neg_logits], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0]


def sampled_softmax_loss(hidden, true_emb, true_bias, neg_emb, neg_bias) -> torch.Tensor:
    """The mean of `sampled_softmax_loss_per_sample`."""
    return sampled_softmax_loss_per_sample(hidden, true_emb, true_bias, neg_emb,
                                           neg_bias).mean()


def bce_logits_loss(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Sigmoid binary cross-entropy on logits: the mean, or with `weights`
    the weighted sum over the weights' sum (at least 1e-9)."""
    per = F.softplus(logits) - labels * logits
    if weights is not None:
        return (per * weights).sum() / weights.sum().clamp(min=1e-9)
    return per.mean()


def l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Euclidean distance, its square held at 1e-12 or more."""
    return torch.sqrt(((a - b) ** 2).sum(dim=-1).clamp(min=1e-12))

