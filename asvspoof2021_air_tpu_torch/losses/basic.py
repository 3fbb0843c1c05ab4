"""Base classification losses: cross-entropy, BCE with logits, focal loss
and the center loss.

Counterparts of the JAX package's ``losses/basic.py``. ``cross_entropy``
and ``binary_cross_entropy_with_logits`` are the train step's base losses
(torch's ``F.cross_entropy`` / ``F.binary_cross_entropy_with_logits``, the
same functions to rounding). ``CenterLoss`` folds the reference's
count-normalized center update into the loss, as the JAX module does: its
value is 0.5 sum ||x_i - c_{y_i}||^2, its gradient in the features is
x_i - c_{y_i}, and in the centers -(x_i - c_{y_i}) / (count_{y_i} + 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy on integer labels."""
    return F.cross_entropy(logits, labels.long())


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    """Mean BCE-with-logits on {0, 1} labels."""
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 0.0, alpha=None,
               size_average: bool = True) -> torch.Tensor:
    """-(1 - p_t)^gamma alpha_t log p_t, p_t held constant in the
    gradient; ``alpha`` a scalar (class 0's weight, 1 - alpha for class 1)
    or a per-class sequence; the mean, or the sum."""
    labels = labels.long()
    logpt = torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    pt = torch.exp(logpt.detach())
    if alpha is not None:
        alpha = torch.as_tensor(alpha, dtype=logits.dtype,
                                device=logits.device)
        if alpha.dim() == 0:
            alpha = torch.stack([alpha, 1 - alpha])
        logpt = logpt * alpha[labels]
    loss = -((1 - pt) ** gamma) * logpt
    return loss.mean() if size_average else loss.sum()


class CenterLoss(nn.Module):
    """Class-center pull loss over ``centers`` (num_classes, feat_dim),
    drawn from N(0, 1) (flax ``normal(1.0)``) on ``device``."""

    def __init__(self, num_classes: int, feat_dim: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.num_classes = num_classes
        self.centers = nn.Parameter(torch.randn(
            (num_classes, feat_dim), generator=generator).to(
                resolve_device(device)))

    def forward(self, feat: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
        labels = labels.long()
        onehot = F.one_hot(labels, self.num_classes).to(feat.dtype)
        counts = onehot.sum(dim=0) + 1.0      # the reference counts from 1
        c = self.centers[labels]
        diff = (feat - c).detach()
        loss = 0.5 * (diff ** 2).sum()
        feat_term = ((feat - feat.detach()) * diff).sum()
        pull = ((c - c.detach()) * (-diff / counts[labels][:, None])).sum()
        return loss + feat_term + pull
