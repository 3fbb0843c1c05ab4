"""Shared model building blocks: eval-mode BatchNorm and the SE module.

Counterparts of the JAX package's ``models/common.py`` ``BatchNorm``
(inference branch) and ``SEModule1D``. Only inference is ported here; the
train-mode BatchNorm, whose running-variance update uses the biased batch
variance unlike ``torch.nn.BatchNorm1d``, belongs to the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


class BatchNorm1d(nn.Module):
    """Inference BatchNorm over dim 1 of (B, C) or (B, C, T):
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, returned in
    x's type promoted to at least f32 (as the JAX BatchNorm returns it).
    State names match ``torch.nn.BatchNorm1d`` (weight, bias, running_mean,
    running_var)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = ((x.float() - self.running_mean.view(shape)) * mul.view(shape)
             + self.bias.view(shape))
        return y.to(torch.promote_types(x.dtype, torch.float32))


class SEModule1D(nn.Module):
    """Squeeze-excitation over (B, C, T) with a BatchNorm'd bottleneck:
    ``se`` = [avg-pool, 1x1 conv C->128, ReLU, BN, 1x1 conv 128->C,
    sigmoid], indexed as the reference's state_dict names them."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.se = nn.Sequential(
            nn.AdaptiveAvgPool1d(1),
            nn.Conv1d(channels, bottleneck, kernel_size=1),
            nn.ReLU(),
            BatchNorm1d(bottleneck),
            nn.Conv1d(bottleneck, channels, kernel_size=1),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.se(x)
