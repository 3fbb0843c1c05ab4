"""Recompute-VJP ReLU -> train-mode BatchNorm.

Counterpart of the JAX package's ``ops/bn_relu_vjp.py`` ``relu_bn_train``
(a ``jax.custom_vjp`` in plain jnp, no Pallas kernel). One ReLU + BN pair
is a :class:`torch.autograd.Function` whose only residuals are the pre-ReLU
input and the per-channel batch statistics (mu, var); the backward rebuilds
the normalized activation and the ReLU mask from the input, which the
convolution before it keeps anyway.

Forward, per channel over every other axis (N reduced elements),
r = relu(x) in f32:
    mu = E[r],  var = max(0, E[r^2] - mu^2),  y = (r - mu) rsqrt(var + eps) g + b
Backward, xhat = (r - mu) rsqrt(var + eps):
    db = sum gy,  dg = sum gy xhat,  dxhat = gy g
    dr = rsqrt(var + eps) (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
         + gmu / N + 2 gvar (r - mu) / N
    dx = dr [x > 0]
The (mu, var) outputs feed the running-statistics update; their
cotangents are zero there, and the rule adds their analytic terms so it
stays a correct VJP anyway. ``bn_relu_train``, ``bn_train`` and
``bn_leaky_relu_train`` serve other model families and are not ported yet.
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


class ReluBNTrain(torch.autograd.Function):
    """(y, mu, var) = batchnorm_train(relu(x)) over channel dim ``dim``;
    y in f32."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dim: int):
        dims, shape = channel_layout(x, dim)
        r = torch.relu(x).float()
        mu = r.mean(dims)
        var = torch.clamp((r * r).mean(dims) - mu * mu, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (r - mu.view(shape)) * (inv * scale).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, mu, var, scale)
        ctx.eps, ctx.dim = eps, dim
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, gmu, gvar):
        x, mu, var, scale = ctx.saved_tensors
        dims, shape = channel_layout(x, ctx.dim)
        n = x.numel() // x.shape[ctx.dim]
        r = torch.relu(x).float()
        inv = torch.rsqrt(var + ctx.eps).view(shape)
        centered = r - mu.view(shape)
        xhat = centered * inv
        g = gy.float()
        dbeta = g.sum(dims)
        dgamma = (g * xhat).sum(dims)
        dxhat = g * scale.view(shape)
        m1 = dxhat.mean(dims).view(shape)
        m2 = (dxhat * xhat).mean(dims).view(shape)
        dr = inv * (dxhat - m1 - xhat * m2)
        dr = dr + gmu.view(shape) / n + (2.0 / n) * gvar.view(shape) * centered
        dx = torch.where(x > 0, dr, torch.zeros((), device=x.device)).to(x.dtype)
        return dx, dgamma, dbeta, None, None


def relu_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = batchnorm_train(relu(x)) with recompute residuals;
    ``dim`` is the channel dimension (1 for (B, C, T), -1 channels-last)."""
    return ReluBNTrain.apply(x, scale, bias, eps, dim)
