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
y is returned in the layer's output type (``dtype``; f32 by default), cast
from the f32 values above, so its gradient arrives in that type.
Backward, with inv = rsqrt(var + eps), a = inv g, d = r - mu, the gradient
gy masked where z = d a + b <= 0 for ``bn_relu``, scaled by slope where
z < 0 for ``bn_leaky_relu`` (z the forward's own expression):
    S1 = sum gy = db,  S2 = sum gy d,  dg = inv S2
    m1 = g S1 / N = mean(dxhat),  m2 = g inv S2 / N = mean(dxhat xhat)
    dr = rsqrt(var + eps) (dxhat - m1 - xhat m2) + gmu / N + 2 gvar d / N
       = A gy + B d + C,  A = a,  B = 2 gvar / N - inv^2 m2,
         C = gmu / N - inv m1
    dx = dr [x > 0] (``relu_bn``), else dr, in x's type
that is, two per-channel sums, then per-channel coefficients, then one
affine pass: on CUDA tensors the two passes of ``csrc/bn_bwd.cu``
(:func:`bn_backward_kernel`, counted as ``bn_bwd``), on CPU tensors
:func:`bn_backward_plain` in the same arithmetic. The (mu, var) outputs
feed the running-statistics update; their cotangents are zero there (None
reaches the backward, which reads them as zeros), and the rule adds their
analytic terms so it stays a correct VJP anyway.

Cross-replica statistics (plain data parallel over ``torch.distributed``,
the JAX package's GSPMD step, whose BN moments are the global batch's):
inside :func:`batch_norm_group` every train-mode BN of the port (these four
modes and ``models/common.BatchNorm``'s autograd path) normalizes with the
moments of the batch split across the group's W ranks. The forward
all-reduces the per-channel sums of r and r^2 in one buffer and divides by
the global N = W n (equal shards: the sharding helpers refuse others); the
backward all-reduces, again in one buffer, the sums S1 and S2 behind m1
and m2 and the (mu, var) cotangents, and uses the global N in the
coefficients. Each rank's loss is the mean over its own rows and the
gradients are then averaged over the ranks (``TrainState.apply_gradients``):
the backward on rank r gives d(sum_s L_s)/dx_r, whose parameter gradients
averaged over the W ranks are those of (1/W) sum_s L_s, the mean loss of
the global batch, as SyncBatchNorm argues. dgamma and dbeta stay the
rank's own sums; the gradient average joins them. The running statistics
then update from the same global moments on every rank.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.distributed as dist

from asvspoof2021_air_tpu_torch.ops import _build
from asvspoof2021_air_tpu_torch.utils import profiling

_GROUP: list = [None]
MODES = ("relu_bn", "bn_relu", "bn_leaky_relu", "bn")   # csrc/bn_bwd.cu Mode
WARPS = 8             # warps a block of csrc/bn_bwd.cu
MAX_SPLITS = 128      # blocks a channel (a channel tile, channels last)


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


def _masked(gy, d, a, bias, mode: str, slope: float, shape):
    """gy in f32, masked by the activation after the BN: its input is the
    forward's own expression d a + bias (each step rounded as the forward
    rounds it), so the mask is the one the forward applied."""
    g = gy.float()
    if mode in ("bn_relu", "bn_leaky_relu"):
        z = d * a.view(shape) + bias.view(shape)
        g = (torch.where(z > 0, g, 0.0) if mode == "bn_relu"
             else torch.where(z >= 0, g, slope * g))
    return g


def _coefficients(sums, inv, scale, a, gmu, gvar, n):
    """(A, B, C) of dr = A g + B d + C from the summed (S1, S2), (2, C)."""
    m1 = scale * sums[0] / n
    m2 = scale * inv * sums[1] / n
    b = 2.0 * gvar / n - inv * inv * m2
    return a, b, gmu / n - inv * m1


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


def _across(sums, gmu, gvar, group):
    """The per-channel (S1, S2), (2, C), and the (mu, var) cotangents
    (zeros where None) summed over ``group``'s ranks in one all-reduce:
    ((S1, S2) as one split (2, 1, C), gmu, gvar)."""
    C = sums.shape[1]
    s = _all_reduce(torch.cat([sums.reshape(-1), _zeros_if_none(gmu, sums[0]),
                               _zeros_if_none(gvar, sums[0])]), group)
    return s[:2 * C].view(2, 1, C), s[2 * C:3 * C], s[3 * C:]


def bn_backward_plain(x, gy, res, gmu, gvar, n: int, mode: str,
                      slope: float, dim: int, group=None):
    """(dx, dgamma, dbeta) of :class:`BNTrainVJP`'s backward in PyTorch, in
    the kernels' arithmetic (the module docstring): the sums, the
    coefficients, one affine pass. ``res`` is (mu, inv, a, scale, bias);
    ``gmu``/``gvar`` may be None (zeros). With a ``group`` the
    coefficients take the sums over its ranks; dgamma and dbeta stay the
    rank's own."""
    mu, inv, a, scale, bias = res
    dims, shape = channel_layout(x, dim)
    r = (torch.relu(x) if mode == "relu_bn" else x).float()
    d = r - mu.view(shape)
    g = _masked(gy, d, a, bias, mode, slope, shape)
    own = torch.stack([g.sum(dims), (g * d).sum(dims)])
    sums = own
    if group is not None:
        sums, gmu, gvar = _across(own, gmu, gvar, group)
        sums = sums[:, 0]
    A, B, C = _coefficients(sums, inv, scale, a, _zeros_if_none(gmu, mu),
                            _zeros_if_none(gvar, mu), n)
    dr = A.view(shape) * g + B.view(shape) * d + C.view(shape)
    if mode == "relu_bn":
        dr = torch.where(x > 0, dr, 0.0)
    return dr.to(x.dtype), inv * own[1], own[0]


def _vector(extent: int, tensors, widths) -> int:
    """The widest vector (elements a load) that divides ``extent`` and at
    which every tensor starts aligned."""
    for v in widths:
        if extent % v == 0 and all(
                t.data_ptr() % (v * t.element_size()) == 0 for t in tensors):
            return v
    return 1


def bn_vjp_plan(outer: int, channels: int, inner: int, vec: int, sms: int):
    """(splits, pieces, per_block), the grid of both passes for x viewed as
    (outer, channels, inner) on a card of ``sms`` SMs. Channels last
    (inner 1): blocks of 32 vec channels take ``per_block`` rows each,
    ``splits`` of them, about 8 blocks an SM in all. Otherwise each row of
    a channel is cut into ``pieces`` of at most 512 vectors (at least 64
    where that gives the card about 64 warps an SM), and a block takes
    ``per_block`` of its channel's outer x pieces items, one or more a
    warp, at most ``MAX_SPLITS`` blocks a channel."""
    cdiv = lambda a, b: -(-a // b)
    if inner == 1:
        tiles = cdiv(channels, 32 * vec)
        splits = max(1, min(MAX_SPLITS, cdiv(8 * sms, tiles),
                            cdiv(outer, WARPS)))
        per_block = cdiv(outer, splits)
        return cdiv(outer, per_block), 1, per_block
    sv = inner // vec
    want = cdiv(64 * sms, channels * outer)
    pieces = max(cdiv(sv, 512), min(want, cdiv(sv, 64)))
    items = outer * pieces
    per_block = cdiv(items, min(MAX_SPLITS, cdiv(items, WARPS)))
    return cdiv(items, per_block), pieces, per_block


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bn_backward_kernel(x, gy, res, gmu, gvar, n: int, mode: str,
                       slope: float, dim: int, group=None):
    """Launch the two passes of ``csrc/bn_bwd.cu`` (one call, counted once
    as ``bn_bwd``): (dx in x's type, dgamma, dbeta), the function of
    :func:`bn_backward_plain`. x and gy share a type (f32 or bf16) and a
    shape and are contiguous CUDA tensors; ``res`` and the cotangents are
    f32 (C,) vectors. With a ``group`` the partials' sums (taken in the
    apply pass's order, so a group of one changes no bit) are all-reduced
    between the passes; dgamma and dbeta stay the rank's own."""
    name = "bn_backward_kernel"
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {MODES}, got {mode!r}")
    if x.dtype not in _build.DTYPE_CODES or gy.dtype != x.dtype:
        raise ValueError(f"{name}: x and gy must share a dtype of "
                         f"{sorted(map(str, _build.DTYPE_CODES))}, got "
                         f"{x.dtype} and {gy.dtype}")
    if gy.shape != x.shape:
        raise ValueError(f"{name}: gy's shape {tuple(gy.shape)} is not x's "
                         f"{tuple(x.shape)}")
    vecs = [t for t in (*res, gmu, gvar) if t is not None]
    if any(t.dtype != torch.float32 for t in vecs):
        raise ValueError(f"{name}: the statistics, the affine and the "
                         f"cotangents of (mu, var) must be float32")
    dim %= x.dim()
    C = x.shape[dim]
    _build.check_args(name, (x, None), (gy, x.shape),
                      *((t, (C,)) for t in vecs))
    outer = math.prod(x.shape[:dim])
    inner = math.prod(x.shape[dim + 1:])
    if inner == 1:
        vec = _vector(C, (x, gy), (2, 1))
    else:
        vec = _vector(inner, (x, gy), (4, 2, 1))
    if inner > 1 and C > 65535:
        raise ValueError(f"{name}: at most 65535 channels, got {C}")
    splits, pieces, per_block = bn_vjp_plan(outer, C, inner, vec,
                                            _sms(x.device))
    mu, inv, a, scale, bias = res
    part = torch.empty((2, splits, C), device=x.device, dtype=torch.float32)
    code, m = _build.DTYPE_CODES[x.dtype], MODES.index(mode)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch("bn_bwd_reduce", x.device, x.data_ptr(), gy.data_ptr(),
                  mu.data_ptr(), a.data_ptr(), bias.data_ptr(), outer, C,
                  inner, pieces, per_block, splits, m, slope, code, vec,
                  part.data_ptr())
    dx = torch.empty_like(x)
    if group is None:
        sums = part
        dgamma, dbeta = (torch.empty((C,), device=x.device,
                                     dtype=torch.float32) for _ in range(2))
        out = (dgamma.data_ptr(), dbeta.data_ptr())
    else:
        own = torch.empty((2, C), device=x.device, dtype=torch.float32)
        _build.launch("bn_bwd_sums", x.device, part.data_ptr(), splits, C,
                      own.data_ptr())
        sums, gmu, gvar = _across(own, gmu, gvar, group)
        dgamma, dbeta = inv * own[1], own[0]
        out = (None, None)
    _build.launch("bn_bwd_apply", x.device, x.data_ptr(), gy.data_ptr(),
                  mu.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                  a.data_ptr(), bias.data_ptr(), sums.data_ptr(),
                  sums.shape[1], ptr(gmu), ptr(gvar), float(n), outer, C,
                  inner, pieces, per_block, splits, m, slope, code, vec,
                  dx.data_ptr(), *out)
    profiling.count("bn_bwd")
    return dx, dgamma, dbeta


class BNTrainVJP(torch.autograd.Function):
    """(y, mu, var) of train-mode BN over channel dim ``dim``, y in
    ``dtype`` (None: f32), in ``mode`` ``"relu_bn"`` (bn(relu(x))),
    ``"bn_relu"`` (relu(bn(x))), ``"bn_leaky_relu"``
    (leaky_relu(bn(x), slope)) or ``"bn"``; residuals (x, mu,
    rsqrt(var + eps)) and the affine. ``eps``, ``dim``, ``mode``,
    ``slope``, ``group`` and ``dtype`` take no gradient; with a ``group``
    the moments are the batch's across it (the module docstring). The
    backward launches :func:`bn_backward_kernel` on CUDA tensors and runs
    :func:`bn_backward_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dim: int, mode: str,
                slope: float = 0.0, group=None, dtype=None):
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
        a = inv * scale
        y = (r - mu.view(shape)) * a.view(shape) + bias.view(shape)
        if mode == "bn_relu":
            y = torch.relu(y)
        elif mode == "bn_leaky_relu":
            y = torch.where(y >= 0, y, slope * y)
        ctx.save_for_backward(x, mu, inv, a, scale, bias)
        ctx.set_materialize_grads(False)
        ctx.dim, ctx.mode, ctx.slope = dim, mode, slope
        ctx.group, ctx.n = group, n
        return y.to(dtype or torch.float32), mu, var

    @staticmethod
    def backward(ctx, gy, gmu, gvar):
        with profiling.span("asv.bn:bwd"):
            x, mu, inv, a, scale, bias = ctx.saved_tensors
            res = (mu, inv, a.float(), scale.float(), bias.float())
            gmu, gvar = (None if t is None else t.float().contiguous()
                         for t in (gmu, gvar))
            dtype = x.dtype
            if gy is None:
                gy = torch.zeros_like(x)
            elif gy.dtype != x.dtype:
                # one type for both: f32, which holds either exactly
                x, gy = x.float(), gy.float()
            if x.is_cuda:
                dx, dgamma, dbeta = bn_backward_kernel(
                    x.contiguous(), gy.contiguous(), res, gmu, gvar, ctx.n,
                    ctx.mode, ctx.slope, ctx.dim, ctx.group)
            else:
                dx, dgamma, dbeta = bn_backward_plain(
                    x, gy, res, gmu, gvar, ctx.n, ctx.mode, ctx.slope,
                    ctx.dim, ctx.group)
            return (dx.to(dtype), dgamma, dbeta, None, None, None, None,
                    None, None)


def relu_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1, dtype=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y, mu, var = batchnorm_train(relu(x)) with recompute residuals, y in
    ``dtype`` (None: f32); ``dim`` is the channel dimension (1 for (B, C,
    T), -1 channels-last)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "relu_bn",
                            0.0, current_group(), dtype)


def bn_relu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, dim: int = 1, dtype=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y, mu, var = relu(batchnorm_train(x)) with recompute residuals, y in
    ``dtype`` (None: f32); ``dim`` is the channel dimension (1 for
    NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn_relu",
                            0.0, current_group(), dtype)


def bn_leaky_relu_train(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float, slope: float,
                        dim: int = 1, dtype=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y, mu, var = leaky_relu(batchnorm_train(x), slope) with recompute
    residuals (ConvNet's blocks, slope 0.1), y in ``dtype`` (None: f32);
    ``dim`` is the channel dimension (1 for NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn_leaky_relu", slope,
                            current_group(), dtype)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, dim: int = 1, dtype=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y, mu, var = batchnorm_train(x) with recompute residuals, y in
    ``dtype`` (None: f32); ``dim`` is the channel dimension (1 for
    NCHW)."""
    return BNTrainVJP.apply(x, scale, bias, eps, dim, "bn",
                            0.0, current_group(), dtype)
