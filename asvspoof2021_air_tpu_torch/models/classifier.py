"""Adversarial channel classifier behind a gradient-reversal layer (GRL).

Counterpart of the JAX package's ``models/classifier.py``: the identity
forward whose backward multiplies the gradient by -lambda (domain-
adversarial training), feeding an MLP channel classifier, for the ADV_AUG
training mode. The JAX GRL is a ``jax.custom_vjp``; here it is a
``torch.autograd.Function``.

:class:`ChannelClassifier` keeps the reference's ``nn.Sequential`` names
(``classifier.0`` and ``classifier.3``, the JAX package's
``interop/torch_port.port_channel_classifier``) and flax's initializer
(``variance_scaling(2.0, "fan_in", "uniform")`` kernels, zero biases). Its
dropout runs only when the caller asks for it (``train=True``), as flax's
``nn.Dropout(deterministic=not train)``; the JAX training step calls every
classifier with ``train=False``, so the module's own train/eval mode never
turns it on.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device


class GradientReversal(torch.autograd.Function):
    """Identity forward; backward ``-lambda_ * g``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, lambda_: float) -> torch.Tensor:
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambda_ * g, None


def gradient_reversal(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    """The identity in the forward pass; scales the gradient by -lambda_ in
    the backward pass."""
    return GradientReversal.apply(x, lambda_)


def linear_kaiming_(linear: nn.Linear,
                    generator: Optional[torch.Generator] = None) -> None:
    """flax's ``variance_scaling(2.0, "fan_in", "uniform")`` kernel (uniform
    in +-sqrt(6 / fan_in)) and a zero bias."""
    limit = math.sqrt(3.0 * 2.0 / linear.in_features)
    with torch.no_grad():
        nn.init.uniform_(linear.weight, -limit, limit, generator=generator)
        nn.init.zeros_(linear.bias)


class ChannelClassifier(nn.Module):
    """GRL -> Linear(enc_dim, enc_dim // 2) -> Dropout -> ReLU ->
    Linear(-> nclasses) -> ReLU. Built on ``device``, initialized from
    ``generator`` (a CPU generator; torch's global one when None)."""

    def __init__(self, enc_dim: int, nclasses: int, lambda_: float = 0.05,
                 dropout_rate: float = 0.3,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.lambda_ = lambda_
        self.classifier = nn.Sequential(
            nn.Linear(enc_dim, enc_dim // 2),
            nn.Dropout(dropout_rate),
            nn.ReLU(),
            nn.Linear(enc_dim // 2, nclasses),
            nn.ReLU(),
        )
        for i in (0, 3):
            linear_kaiming_(self.classifier[i], generator)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        lin0, drop, _, lin3, _ = self.classifier
        h = lin0(gradient_reversal(x, self.lambda_))
        h = torch.relu(F.dropout(h, drop.p, training=train))
        return torch.relu(lin3(h))
