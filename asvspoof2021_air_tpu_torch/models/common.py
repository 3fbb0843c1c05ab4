"""Shared model building blocks: BatchNorm (eval and train mode, with or
without its affine, ReLU before or after it, leaky ReLU after it), the SE
modules (1-D with a BN'd bottleneck, 2-D with bias-free denses), max-feature-map,
self-attentive statistics pooling, flax's convolution and dense semantics
under a compute dtype, and flax's initializers.

Counterparts of the JAX package's ``models/common.py`` ``BatchNorm``,
``batch_norm``, ``relu_bn``, ``bn_relu`` (with ``fused`` either way),
``leaky_slope``, ``SEModule1D``,
``SELayer2D``, ``MaxFeatureMap``,
``SelfAttentionPooling``, ``to_2d_input``, ``conv_kaiming_init`` and
``linear_kaiming_init``. Train mode follows the JAX ``BatchNorm`` and
flax's ``nn.BatchNorm``, not ``torch.nn.BatchNorm1d``: batch statistics in
f32 over every axis but the channel, variance max(0, E[x^2] - E[x]^2), and
the running statistics updated as ``0.9 ra + 0.1 batch`` with the *biased*
variance (``torch.nn.BatchNorm1d`` updates with the unbiased one).

The 2-D models are NCHW with H the frequency axis (the JAX models are NHWC):
the channel is dim 1 everywhere.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import (
    AllReduceSum, bn_leaky_relu_train, bn_relu_train, bn_train,
    channel_layout, current_group, relu_bn_train)

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


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: Optional[torch.dtype],
           stride=1, padding=0, dilation=1) -> torch.Tensor:
    """flax ``nn.Conv`` over NCHW, as :func:`conv1d`: ``padding`` an int,
    a pair, or ``"SAME"`` (odd kernels at stride 1: k // 2 each side)."""
    if padding == "SAME":
        kh, kw = weight.shape[2:]
        if stride not in (1, (1, 1)) or not (kh % 2 and kw % 2):
            raise ValueError("'SAME' is ported for odd kernels at stride 1")
        padding = (kh // 2, kw // 2)
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    y = F.conv2d(x.to(dt), weight.to(dt), None, stride, padding, dilation)
    return y if bias is None else y + bias.to(dt)[:, None, None]


def conv(m: nn.Module, x: torch.Tensor,
         dtype: Optional[torch.dtype]) -> torch.Tensor:
    """:func:`conv1d` or :func:`conv2d` with the parameters and geometry of
    ``m`` (an ``nn.Conv1d`` or ``nn.Conv2d``)."""
    if isinstance(m, nn.Conv2d):
        return conv2d(x, m.weight, m.bias, dtype, m.stride, m.padding,
                      m.dilation)
    return conv1d(x, m.weight, m.bias, dtype, m.padding[0], m.dilation[0])


def dense(m: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense``: as :func:`conv1d`, for ``m``'s product."""
    dt = dtype or torch.promote_types(x.dtype, m.weight.dtype)
    return F.linear(x.to(dt), m.weight.to(dt)) + m.bias.to(dt)


class BatchNorm(nn.Module):
    """BatchNorm over channel dim ``dim`` (default 1: (B, C), (B, C, T) and
    NCHW), computed in f32 and returned in ``dtype``, or with ``dtype``
    None in x's type promoted to at least f32 (as the JAX BatchNorm returns
    it). Eval mode normalizes with the running statistics: ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias``. State names match
    ``torch.nn.BatchNorm1d`` (weight, bias, running_mean, running_var);
    ``use_scale=False`` / ``use_bias=False`` drop the weight / the bias (the
    reference's ``BatchNorm2d(affine=False)`` keeps only the running
    statistics), which then act as ones / zeros. ``recompute`` routes the
    train-mode forward through ``ops/bn_relu_vjp.bn_train`` (the JAX
    BatchNorm's ``recompute``): the same values, lighter residuals, other
    rounding in the backward. Each model sets it as its JAX counterpart
    does: LCNN's BNs recompute; ECAPA's BNs outside a fused ReLU -> BN
    pair (bn5, bn7, the SE modules') take autograd's VJP, as JAX's
    autodiff does there, and its bf16 trajectory against JAX's depends on
    that rounding order (with ``bn_train`` the bf16 loss four steps on is
    2.5% from JAX's, past tests/test_torch_train_bf16.py's 2% bar).
    The attribute ``fused`` is the JAX model's ``fused_bn`` for the
    activation pairs (:meth:`relu_bn`, :meth:`bn_relu`,
    :meth:`bn_leaky_relu`): True (the default) routes each train-mode pair
    through its recompute VJP of ``ops/bn_relu_vjp.py``, False through the
    activation and :meth:`forward` under autograd (the JAX
    ``relu_bn``/``bn_relu`` with ``fused=False``: the statistics in f32,
    the output in the compute type, the activation after the BN in that
    type); :func:`set_fused_bn` sets it on every BN of a model. Inside
    ``ops/bn_relu_vjp.batch_norm_group`` every train-mode path normalizes
    with the moments across the group's ranks."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM,
                 dtype: Optional[torch.dtype] = None, use_scale: bool = True,
                 use_bias: bool = True, recompute: bool = False):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.recompute, self.fused = recompute, True
        for name, use, fill in (("weight", use_scale, 1.0),
                                ("bias", use_bias, 0.0)):
            if use:
                setattr(self, name,
                        nn.Parameter(torch.full((num_features,), fill)))
            else:
                self.register_buffer(name, torch.full((num_features,), fill),
                                     persistent=False)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _out(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))

    def _update(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mu)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _eval(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The running-statistics normalization of x, in f32."""
        _dims, shape = channel_layout(x, dim)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))

    def forward(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if not self.training:
            return self._out(self._eval(x, dim), x)
        if self.recompute:
            y, mu, var = bn_train(x, self.weight, self.bias, self.eps, dim)
            self._update(mu.detach(), var.detach())
            return self._out(y, x)
        dims, shape = channel_layout(x, dim)
        xf = x.float()
        group = current_group()
        if group is None:
            mu = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mu * mu, min=0.0)
        else:
            # the moments across the group, through a differentiable
            # all-reduce (ops/bn_relu_vjp.batch_norm_group)
            n = xf.numel() // xf.shape[dim] * dist.get_world_size(group)
            s = AllReduceSum.apply(
                torch.cat([xf.sum(dims), (xf * xf).sum(dims)]), group)
            mu, ms = (s / n).chunk(2)
            var = torch.clamp(ms - mu * mu, min=0.0)
        self._update(mu.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return self._out(y, x)

    def relu_bn(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``self(relu(x))``; in train mode with ``fused`` through the
        recompute VJP of ``ops/bn_relu_vjp.py`` (same values, lighter
        residuals)."""
        if not (self.training and self.fused):
            return self(torch.relu(x), dim)
        y, mu, var = relu_bn_train(x, self.weight, self.bias, self.eps, dim)
        self._update(mu.detach(), var.detach())
        return self._out(y, x)

    def bn_relu(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``relu(self(x))``, the pre-activation order (the JAX
        ``bn_relu``); in train mode through ``ops/bn_relu_vjp.bn_relu_train``
        (the JAX model's ``fused_bn``), or without ``fused`` as
        ``relu(self(x))`` under autograd."""
        if self.training and not self.fused:
            return torch.relu(self(x, dim))
        if not self.training:
            return self._out(torch.relu(self._eval(x, dim)), x)
        y, mu, var = bn_relu_train(x, self.weight, self.bias, self.eps, dim)
        self._update(mu.detach(), var.detach())
        return self._out(y, x)

    def bn_leaky_relu(self, x: torch.Tensor, slope: float,
                      dim: int = 1) -> torch.Tensor:
        """``leaky_relu(self(x), slope)`` (flax's: y where y >= 0, else
        slope y), the JAX BatchNorm's ``relu_after`` with ``leaky_slope``;
        in train mode through ``ops/bn_relu_vjp.bn_leaky_relu_train`` (the
        JAX ConvNet's ``fused_bn``), or without ``fused`` as the leaky ReLU
        of ``self(x)`` under autograd."""
        if self.training and not self.fused:
            y = self(x, dim)
            return torch.where(y >= 0, y, slope * y)
        if not self.training:
            y = self._eval(x, dim)
            return self._out(torch.where(y >= 0, y, slope * y), x)
        y, mu, var = bn_leaky_relu_train(x, self.weight, self.bias, self.eps,
                                         slope, dim)
        self._update(mu.detach(), var.detach())
        return self._out(y, x)


BatchNorm1d = BatchNorm     # the name ECAPA's modules use


def set_fused_bn(module: nn.Module, fused: bool) -> None:
    """Every :class:`BatchNorm` of ``module`` takes its train-mode
    activation pairs through the recompute VJPs (``fused``, the JAX
    models' ``fused_bn=True``) or through plain autograd."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.fused = fused


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


class SELayer2D(nn.Module):
    """Squeeze-excitation over NCHW: the mean over (H, W), ``fc.0`` (C ->
    C // reduction, no bias), ReLU, ``fc.2`` (back to C, no bias), sigmoid
    gates per channel (the JAX ``SELayer2D``, f32; the reference's
    ``se.fc`` names)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1, _, fc2, _ = self.fc
        y = torch.sigmoid(fc2(torch.relu(fc1(x.mean((2, 3))))))
        return x * y[:, :, None, None]


class MaxFeatureMap(nn.Module):
    """Max-feature-map over channel dim ``dim``: the elementwise max of the
    first and second halves (the JAX ``MaxFeatureMap`` on its last axis)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[self.dim] % 2:
            raise ValueError("MaxFeatureMap needs an even channel count")
        a, b = torch.chunk(x, 2, dim=self.dim)
        return torch.maximum(a, b)


class SelfAttentionPooling(nn.Module):
    """Attentive statistics over time of x (B, T, H) in f32: per-frame
    logits x @ att_weights^T, softmax over T of their tanh, the weighted
    sum and the unbiased (ddof 1) std of the weighted frames, [mean || std]
    (B, 2H). In train mode 1e-5 times ``noise`` (B, T, H), standard-normal
    draws, is added to the weighted frames before the std, as the JAX
    module adds its ``noise`` stream's draws; eval mode adds none.
    ``att_weights`` is (1, H), the reference's layout."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.att_weights = nn.Parameter(torch.zeros(1, hidden_size))

    def forward(self, x: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = (x @ self.att_weights.t())[..., 0]
        attn = torch.softmax(torch.tanh(logits), dim=1)
        weighted = x * attn[..., None]
        mean = weighted.sum(dim=1)
        if noise is not None:
            weighted = weighted + 1e-5 * noise
        std = torch.std(weighted, dim=1, correction=1)
        return torch.cat([mean, std], dim=1)


def to_2d_input(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F) features -> (B, 1, F, T) NCHW with H the frequency axis
    (the reference's 2-D layout; the JAX models' (B, F, T, 1) NHWC)."""
    if x.dim() == 4:
        return x
    return x.transpose(1, 2)[:, None]


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal``: a normal truncated to +-2 standard
    deviations, scaled to variance 1 / fan_in. ``fan_in`` is the input
    width times the kernel taps, ``weight[0].numel()`` in torch's (out, in,
    k...) and (out, in) layouts."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)


def conv_kaiming_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """The JAX ``conv_kaiming_init``, ``variance_scaling(2.0, "fan_out",
    "truncated_normal")``: fan_out is the output width times the kernel
    taps, ``numel / in`` in torch's (out, in, kh, kw) layout."""
    fan_out = weight.numel() // weight.shape[1]
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)


def linear_kaiming_(weight: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> None:
    """The JAX ``linear_kaiming_init``, ``variance_scaling(2.0, "fan_in",
    "uniform")``: U(-b, b) with b = sqrt(6 / fan_in), fan_in =
    ``weight[0].numel()``."""
    bound = math.sqrt(6.0 / weight[0].numel())
    with torch.no_grad():
        weight.copy_((torch.rand(weight.shape, generator=generator) * 2 - 1)
                     * bound)


def init_flax_like_(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Re-initialize ``module`` as flax initializes the JAX model by
    default: lecun-normal kernels and zero biases for every conv and
    linear layer, scale 1, bias 0, mean 0 and var 1 for every BatchNorm.
    Equal in law to the JAX init, not bit for bit (the two generators
    differ)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0),
                         (m.running_mean, 0.0), (m.running_var, 1.0)):
                nn.init.constant_(t, v)
