"""One-class losses: OC-Softmax (= AngularIsoLoss), Isolate, IsolateSquare,
P2SGrad and AMSoftmax.

Counterparts of the JAX package's ``losses/one_class.py``, with its
parameter names, layouts, initializers and return values:

- ``OCSoftmax``: cosine of the L2-normalized embedding to a learned,
  L2-normalized ``center``; loss = mean softplus(alpha * margin) with
  margin r_real - cos for bona fide (label 0) and cos - r_fake for spoof
  (label 1); returns (loss, -cos);
- ``IsolateLoss`` / ``IsolateSquareLoss``: the hinges relu(d - r_real)
  over bona fide and relu(r_fake - d) over spoof, each averaged over its
  class (at least one), of the distance d = ||x - center|| (squared, and
  against squared radii, for IsolateSquare); returns the loss; the score is
  :meth:`score`, the distance to the center;
- ``P2SGradLoss``: the mean squared error of cos-theta, against the unit
  columns of ``weight`` (in_dim, out_dim) and clipped to [-1, 1], to the
  (optionally smoothed) one-hot labels; returns (loss, -cos[:, 0]);
- ``AMSoftmax``: cosine logits to the L2-normalized class ``centers`` and
  the margin logits s (logits - m onehot); returns both.

Every branch is a mask, as in the JAX package. The parameters live on
``device`` (the GPU unless the caller asks for the CPU) and are drawn from
``generator`` (a CPU generator) as flax draws them: OC-Softmax's center
from ``variance_scaling(2 / (1 + 0.25^2), fan_in, uniform)``, the Isolate
centers and AMSoftmax's from ``normal(1.0)``, P2SGrad's weight from
``uniform(2.0)``, U[0, 2).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device


class OCSoftmax(nn.Module):
    def __init__(self, feat_dim: int = 2, r_real: float = 0.9,
                 r_fake: float = 0.5, alpha: float = 20.0,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.r_real, self.r_fake, self.alpha = r_real, r_fake, alpha
        # variance_scaling(2 / (1 + 0.25^2), fan_in, uniform) on a (1, D)
        # parameter: fan_in = 1, bound = sqrt(3 * scale).
        bound = math.sqrt(3.0 * 2.0 / (1.0 + 0.25 ** 2))
        self.center = nn.Parameter(
            ((torch.rand((1, feat_dim), generator=generator) * 2.0 - 1.0)
             * bound).to(dev))

    def forward(self, x: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = F.normalize(self.center, p=2, dim=1)
        xn = F.normalize(x, p=2, dim=1)
        scores = (xn @ w.t())[:, 0]
        margins = torch.where(labels == 0, self.r_real - scores,
                              scores - self.r_fake)
        loss = F.softplus(self.alpha * margins).mean()
        return loss, -scores


AngularIsoLoss = OCSoftmax


def _param(shape, draw, generator, device) -> nn.Parameter:
    """A parameter of ``shape`` drawn on the CPU from ``generator`` by
    ``draw`` (``torch.randn`` or ``torch.rand``), moved to ``device``."""
    return nn.Parameter(draw(shape, generator=generator).to(
        resolve_device(device)))


def _class_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (v * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class IsolateLoss(nn.Module):
    """Hinge on the distance to the center against the radii ``r_real``
    and ``r_fake``."""

    squared = False

    def __init__(self, feat_dim: int = 2, r_real: float = 0.042,
                 r_fake: float = 1.638,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.r_real, self.r_fake = r_real, r_fake
        self.center = _param((1, feat_dim), torch.randn, generator, device)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        real = (labels == 0).to(x.dtype)
        fake = (labels == 1).to(x.dtype)
        if self.squared:
            d = ((x - self.center) ** 2).sum(dim=1)
            r_real, r_fake = self.r_real ** 2, self.r_fake ** 2
        else:
            d = torch.linalg.vector_norm(x - self.center, dim=1)
            r_real, r_fake = self.r_real, self.r_fake
        return (_class_mean(torch.relu(d - r_real), real)
                + _class_mean(torch.relu(r_fake - d), fake))

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """The distance to the center, the rule the JAX package scores and
        selects models with."""
        return torch.linalg.vector_norm(x - self.center, dim=1)


class IsolateSquareLoss(IsolateLoss):
    """Squared-distance variant: hinges on ||x - center||^2 against the
    squared radii; scored by the distance, as IsolateLoss."""

    squared = True


class P2SGradLoss(nn.Module):
    """P2SGrad: MSE of cos-theta to the one-hot labels (smoothed by
    ``smooth``); ``weight``'s columns are renormalized to unit norm at each
    call."""

    def __init__(self, in_dim: int, out_dim: int = 2, smooth: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.out_dim, self.smooth = out_dim, smooth
        self.weight = _param((in_dim, out_dim),
                             lambda shape, generator: 2.0 * torch.rand(
                                 shape, generator=generator),
                             generator, device)

    def forward(self, x: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.weight / torch.clamp(torch.linalg.vector_norm(
            self.weight, dim=0, keepdim=True), min=1e-12)
        x_mod = torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                            min=1e-12)
        cos = torch.clamp((x @ w) / x_mod, -1.0, 1.0)
        onehot = F.one_hot(labels.long(), self.out_dim).to(x.dtype)
        if self.smooth:
            onehot = onehot * (1 - self.smooth) + self.smooth / self.out_dim
        return ((cos - onehot) ** 2).mean(), -cos[:, 0]


class AMSoftmax(nn.Module):
    """Additive-margin softmax head: returns (cosine logits, margin
    logits); trained with cross-entropy on the margin logits, scored by
    softmax(logits)[:, 0]."""

    def __init__(self, num_classes: int, enc_dim: int, s: float = 20.0,
                 m: float = 0.9, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_classes, self.s, self.m = num_classes, s, m
        self.centers = _param((num_classes, enc_dim), torch.randn, generator,
                              device)

    def forward(self, feat: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = F.normalize(feat, p=2, dim=-1) @ F.normalize(
            self.centers, p=2, dim=-1).t()
        onehot = F.one_hot(labels.long(), self.num_classes).to(feat.dtype)
        return logits, self.s * (logits - self.m * onehot)
