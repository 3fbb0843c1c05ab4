"""Shared model building blocks: BatchNorm (eval and train mode), the SE
module, flax's convolution and dense semantics under a compute dtype, and
flax's default initializer.

Counterparts of the JAX package's ``models/common.py`` ``BatchNorm`` and
``SEModule1D``. Train mode follows the JAX ``BatchNorm`` and flax's
``nn.BatchNorm``, not ``torch.nn.BatchNorm1d``: batch statistics in f32
over every axis but the channel, variance max(0, E[x^2] - E[x]^2), and the
running statistics updated as ``0.9 ra + 0.1 batch`` with the *biased*
variance (``torch.nn.BatchNorm1d`` updates with the unbiased one).

A compute ``dtype`` (None or ``torch.bfloat16``) has flax's meaning, with
the parameters kept in f32: :func:`conv` and :func:`dense` cast input,
kernel and bias to it, round the product to it and add the bias in it
(``flax.linen`` ``Conv``/``Dense``); BatchNorm computes its statistics and
its normalization in f32 and returns ``dtype`` (``models/common.py:187-188``
of the JAX package); None is f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import (
    channel_layout, relu_bn_train)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9      # flax: the retained fraction of the running statistics


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: Optional[torch.dtype],
           padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` over (B, C, T): x, the kernel and the bias cast to
    ``dtype`` (None: their promoted type), the product rounded to it, then
    the bias added in it."""
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    y = F.conv1d(x.to(dt), weight.to(dt), None, 1, padding, dilation)
    return y if bias is None else y + bias.to(dt)[:, None]


def conv(m: nn.Conv1d, x: torch.Tensor,
         dtype: Optional[torch.dtype]) -> torch.Tensor:
    """:func:`conv1d` with the parameters and geometry of ``m``."""
    return conv1d(x, m.weight, m.bias, dtype, m.padding[0], m.dilation[0])


def dense(m: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense``: as :func:`conv1d`, for ``m``'s product."""
    dt = dtype or torch.promote_types(x.dtype, m.weight.dtype)
    return F.linear(x.to(dt), m.weight.to(dt)) + m.bias.to(dt)


class BatchNorm1d(nn.Module):
    """BatchNorm over channel dim ``dim`` (default 1, for (B, C) and
    (B, C, T)), computed in f32 and returned in ``dtype``, or with ``dtype``
    None in x's type promoted to at least f32 (as the JAX BatchNorm returns
    it). Eval mode normalizes with the running statistics: ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias``. State names match
    ``torch.nn.BatchNorm1d`` (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _out(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))

    def _update(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mu)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        dims, shape = channel_layout(x, dim)
        xf = x.float()
        if self.training:
            mu = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mu * mu, min=0.0)
            self._update(mu.detach(), var.detach())
        else:
            mu, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return self._out(y, x)

    def relu_bn(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``self(relu(x))``; in train mode through the recompute VJP of
        ``ops/bn_relu_vjp.py`` (same values, lighter residuals)."""
        if not self.training:
            return self(torch.relu(x), dim)
        y, mu, var = relu_bn_train(x, self.weight, self.bias, self.eps, dim)
        self._update(mu.detach(), var.detach())
        return self._out(y, x)


class Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``) in x's type, op by op as XLA
    expands it: 1 / (1 + exp(-x)), each step rounded to x's type; its
    backward is ``lax.logistic``'s rule g * (y * (1 - y)), also op by op.
    In f32 it is ``torch.sigmoid`` to rounding; in bf16 it rounds where
    the JAX model does (``torch.sigmoid`` rounds once)."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


class SEModule1D(nn.Module):
    """Squeeze-excitation over (B, C, T) with a BatchNorm'd bottleneck:
    ``se`` = [avg-pool, 1x1 conv C->128, ReLU, BN, 1x1 conv 128->C,
    sigmoid], indexed as the reference's state_dict names them. In train
    mode the BN takes its statistics over the batch, as flax's
    ``nn.BatchNorm`` does in the JAX module. The mean over T sums in f32
    and returns x's type (``jnp.mean``); the convs and the BN follow
    ``dtype``."""

    def __init__(self, channels: int, bottleneck: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.se = nn.Sequential(
            nn.AdaptiveAvgPool1d(1),
            nn.Conv1d(channels, bottleneck, kernel_size=1),
            nn.ReLU(),
            BatchNorm1d(bottleneck, dtype=dtype),
            nn.Conv1d(bottleneck, channels, kernel_size=1),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, c1, _, bn, c2, _ = self.se
        y = x.mean(2, keepdim=True, dtype=torch.float32).to(x.dtype)
        y = bn(torch.relu(conv(c1, y, self.dtype)))
        return x * Logistic.apply(conv(c2, y, self.dtype))


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal``: a normal truncated to +-2 standard
    deviations, scaled to variance 1 / fan_in. ``fan_in`` is the input
    width times the kernel taps, ``weight[0].numel()`` in torch's (out, in,
    k) and (out, in) layouts."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)


def init_flax_like_(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Re-initialize ``module`` as flax initializes the JAX model:
    lecun-normal kernels and zero biases for every conv and linear layer,
    scale 1, bias 0, mean 0 and var 1 for every BatchNorm. Equal in law to
    the JAX init, not bit for bit (the two generators differ)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm1d):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0),
                         (m.running_mean, 0.0), (m.running_var, 1.0)):
                nn.init.constant_(t, v)
