"""Recompute-VJP train-mode BatchNorm: ReLU -> BN, BN -> ReLU, BN ->
leaky ReLU and BN alone.

Counterparts of the JAX package's ``ops/bn_relu_vjp.py`` ``relu_bn_train``
(ECAPA's ``bn(relu(x))``), ``bn_relu_train`` (the pre-activation
``relu(bn(x))`` of the ResNet and SE-Res2Net50 blocks),
``bn_leaky_relu_train`` (ConvNet's ``leaky_relu(bn(x), slope)``) and
``bn_train`` (every other train-mode BN), each a ``jax.custom_vjp`` in
plain jnp, no Pallas kernel.
All four are one :class:`torch.autograd.Function` in four modes, whose
only residuals are the input and the per-channel batch statistics
(mu, var); the backward rebuilds the normalized activation and the ReLU
mask from the input, which the layer before it keeps anyway.

Forward, per channel over every other axis (N reduced elements),
r = relu(x) (``relu_bn``) or x, in f32:
    mu = E[r],  var = max(0, E[r^2] - mu^2),  y = (r - mu) rsqrt(var + eps) g + b
    (``bn_relu``: y = relu(y); ``bn_leaky_relu``: y where y >= 0, else
    slope y)
Backward, xhat = (r - mu) rsqrt(var + eps), gy masked where
z = xhat g + b <= 0 for ``bn_relu``, scaled by slope where z < 0 for
``bn_leaky_relu``:
    db = sum gy,  dg = sum gy xhat,  dxhat = gy g
    dr = rsqrt(var + eps) (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
         + gmu / N + 2 gvar (r - mu) / N
    dx = dr [x > 0] (``relu_bn``), else dr
The (mu, var) outputs feed the running-statistics update; their
cotangents are zero there, and the rule adds their analytic terms so it
stays a correct VJP anyway.
"""

from __future__ import annotations

from typing import Tuple

import torch


def channel_layout(x: torch.Tensor, dim: int):
    """(the dims a statistic of channel dim ``dim`` reduces over, the
    shape that broadcasts a per-channel vector against x)."""
    dim %= x.dim()
    dims = tuple(d for d in range(x.dim()) if d != dim)
    shape = [1] * x.dim()
    shape[dim] = -1
    return dims, shape


class BNTrainVJP(torch.autograd.Function):
    """(y, mu, var) of train-mode BN over channel dim ``dim``, y in f32,
    in ``mode`` ``"relu_bn"`` (bn(relu(x))), ``"bn_relu"`` (relu(bn(x))),
    ``"bn_leaky_relu"`` (leaky_relu(bn(x), slope)) or ``"bn"``; residuals
    (x, mu, var) and the affine. ``eps``, ``dim``, ``mode`` and ``slope``
    take no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dim: int, mode: str,
                slope: float = 0.0):
        dims, shape = channel_layout(x, dim)
        r = (torch.relu(x) if mode == "relu_bn" else x).float()
        mu = r.mean(dims)
        var = torch.clamp((r * r).mean(dims) - mu * mu, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (r - mu.view(shape)) * (inv * scale).view(shape) + bias.view(shape)
        if mode == "bn_relu":
            y = torch.relu(y)
        elif mode == "bn_leaky_relu":
            y = torch.where(y >= 0, y, slope * y)
        ctx.save_for_backward(x, mu, var, scale, bias)
        ctx.eps, ctx.dim, ctx.mode, ctx.slope = eps, dim, mode, slope
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, gmu, gvar):
        x, mu, var, scale, bias = ctx.saved_tensors
        dims, shape = channel_layout(x, ctx.dim)
        n = x.numel() // x.shape[ctx.dim]
        zero = torch.zeros((), device=x.device)
        r = (torch.relu(x) if ctx.mode == "relu_bn" else x).float()
        inv = torch.rsqrt(var + ctx.eps).view(shape)
        centered = r - mu.view(shape)
        xhat = centered * inv
        g = gy.float()
        if ctx.mode == "bn_relu":
            g = torch.where(xhat * scale.view(shape) + bias.view(shape) > 0,
                            g, zero)
        elif ctx.mode == "bn_leaky_relu":
            g = torch.where(xhat * scale.view(shape) + bias.view(shape) >= 0,
                            g, ctx.slope * g)
        dbeta = g.sum(dims)
        dgamma = (g * xhat).sum(dims)
        dxhat = g * scale.view(shape)
        m1 = dxhat.mean(dims).view(shape)
        m2 = (dxhat * xhat).mean(dims).view(shape)
        dr = inv * (dxhat - m1 - xhat * m2)
        dr = dr + gmu.view(shape) / n + (2.0 / n) * gvar.view(shape) * centered
        if ctx.mode == "relu_bn":
            dr = torch.where(x > 0, dr, zero)
        return dr.to(x.dtype), dgamma, dbeta, None, None, None, None


def relu_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = batchnorm_train(relu(x)) with recompute residuals;
    ``dim`` is the channel dimension (1 for (B, C, T), -1 channels-last)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "relu_bn")


def bn_relu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = relu(batchnorm_train(x)) with recompute residuals;
    ``dim`` is the channel dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn_relu")


def bn_leaky_relu_train(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float, slope: float,
                        dim: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = leaky_relu(batchnorm_train(x), slope) with recompute
    residuals (ConvNet's blocks, slope 0.1); ``dim`` is the channel
    dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn_leaky_relu", slope)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, dim: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = batchnorm_train(x) with recompute residuals; ``dim``
    is the channel dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn")
