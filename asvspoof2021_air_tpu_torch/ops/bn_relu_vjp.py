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

Cross-replica statistics (plain data parallel over ``torch.distributed``,
the JAX package's GSPMD step, whose BN moments are the global batch's):
inside :func:`batch_norm_group` every train-mode BN of the port (these four
modes and ``models/common.BatchNorm``'s autograd path) normalizes with the
moments of the batch split across the group's W ranks. The forward
all-reduces the per-channel sums of r and r^2 in one buffer and divides by
the global N = W n (equal shards: the sharding helpers refuse others); the
backward all-reduces, again in one buffer, the sums behind mean(dxhat) and
mean(dxhat xhat) and the (mu, var) cotangents, and uses the global N in the
gmu and gvar terms. Each rank's loss is the mean over its own rows and the
gradients are then averaged over the ranks (``TrainState.apply_gradients``):
the backward on rank r gives d(sum_s L_s)/dx_r, whose parameter gradients
averaged over the W ranks are those of (1/W) sum_s L_s, the mean loss of
the global batch, as SyncBatchNorm argues. dgamma and dbeta stay the
rank's own sums; the gradient average joins them. The running statistics
then update from the same global moments on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch.utils import profiling

_GROUP: list = [None]


@contextlib.contextmanager
def batch_norm_group(group):
    """Within the block, train-mode BN normalizes with the moments of the
    batch across ``group`` (a ``torch.distributed`` process group; None:
    this process's rows alone). The group is read when a forward runs; its
    backward uses the group of its forward."""
    prev, _GROUP[0] = _GROUP[0], group
    try:
        yield
    finally:
        _GROUP[0] = prev


def current_group():
    """The group of :func:`batch_norm_group`, None outside it."""
    return _GROUP[0]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``, differentiable: the
    cotangent of the sum is every rank's, so the backward sums the
    cotangents over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


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
    (x, mu, var) and the affine. ``eps``, ``dim``, ``mode``, ``slope`` and
    ``group`` take no gradient; with a ``group`` the moments are the
    batch's across it (the module docstring)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dim: int, mode: str,
                slope: float = 0.0, group=None):
        dims, shape = channel_layout(x, dim)
        r = (torch.relu(x) if mode == "relu_bn" else x).float()
        n = x.numel() // x.shape[dim]
        if group is None:
            mu = r.mean(dims)
            var = torch.clamp((r * r).mean(dims) - mu * mu, min=0.0)
        else:
            n *= dist.get_world_size(group)
            s = _all_reduce(torch.cat([r.sum(dims), (r * r).sum(dims)]),
                            group)
            mu, ms = (s / n).chunk(2)
            var = torch.clamp(ms - mu * mu, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (r - mu.view(shape)) * (inv * scale).view(shape) + bias.view(shape)
        if mode == "bn_relu":
            y = torch.relu(y)
        elif mode == "bn_leaky_relu":
            y = torch.where(y >= 0, y, slope * y)
        ctx.save_for_backward(x, mu, var, scale, bias)
        ctx.eps, ctx.dim, ctx.mode, ctx.slope = eps, dim, mode, slope
        ctx.group, ctx.n = group, n
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, gmu, gvar):
        with profiling.span("asv.bn:bwd"):
            x, mu, var, scale, bias = ctx.saved_tensors
            dims, shape = channel_layout(x, ctx.dim)
            n = ctx.n
            zero = torch.zeros((), device=x.device)
            r = (torch.relu(x) if ctx.mode == "relu_bn" else x).float()
            inv = torch.rsqrt(var + ctx.eps).view(shape)
            centered = r - mu.view(shape)
            xhat = centered * inv
            g = gy.float()
            if ctx.mode in ("bn_relu", "bn_leaky_relu"):
                y = xhat * scale.view(shape) + bias.view(shape)
                g = (torch.where(y > 0, g, zero) if ctx.mode == "bn_relu"
                     else torch.where(y >= 0, g, ctx.slope * g))
            dbeta = g.sum(dims)
            dgamma = (g * xhat).sum(dims)
            dxhat = g * scale.view(shape)
            if ctx.group is None:
                m1 = dxhat.mean(dims).view(shape)
                m2 = (dxhat * xhat).mean(dims).view(shape)
            else:
                s = _all_reduce(torch.cat([dxhat.sum(dims),
                                           (dxhat * xhat).sum(dims),
                                           gmu.float(), gvar.float()]),
                                ctx.group)
                m1, m2, gmu, gvar = s.chunk(4)
                m1, m2 = (m1 / n).view(shape), (m2 / n).view(shape)
            dr = inv * (dxhat - m1 - xhat * m2)
            dr = (dr + gmu.view(shape) / n
                  + (2.0 / n) * gvar.view(shape) * centered)
            if ctx.mode == "relu_bn":
                dr = torch.where(x > 0, dr, zero)
            return (dr.to(x.dtype), dgamma, dbeta, None, None, None, None,
                    None)


def relu_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = batchnorm_train(relu(x)) with recompute residuals;
    ``dim`` is the channel dimension (1 for (B, C, T), -1 channels-last)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "relu_bn",
                            0.0, current_group())


def bn_relu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = relu(batchnorm_train(x)) with recompute residuals;
    ``dim`` is the channel dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn_relu",
                            0.0, current_group())


def bn_leaky_relu_train(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float, slope: float,
                        dim: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = leaky_relu(batchnorm_train(x), slope) with recompute
    residuals (ConvNet's blocks, slope 0.1); ``dim`` is the channel
    dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn_leaky_relu", slope,
                            current_group())


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, dim: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y32, mu, var = batchnorm_train(x) with recompute residuals; ``dim``
    is the channel dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn",
                            0.0, current_group())
