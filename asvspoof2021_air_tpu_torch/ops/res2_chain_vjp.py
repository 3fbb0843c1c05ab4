"""Train-mode Res2 hierarchical conv chain with a hand-written backward.

Counterpart of the JAX package's ``ops/res2_chain_vjp.py``
``res2_chain_train`` (a ``jax.custom_vjp`` in plain jnp, no Pallas kernel;
this is plain PyTorch, and kernel B2 stays the serving chain). An ECAPA
Bottle2neck's chain is scale - 1 = G SEQUENTIAL width-w dilated k=3 convs,
each followed by ReLU -> train-mode BatchNorm; the group sum feeding conv
i is the previous output plus the block's i-th input group.

The forward stays sequential (the data dependency is real) and computes
what the unfused chain of ``models/ecapa.Bottle2neck`` computes, op for op
(``models/common.conv1d``, then ``ops/bn_relu_vjp``'s f32 statistics), so
its values and batch statistics are those of the unfused path bit for bit.
It saves only the pre-ReLU conv outputs ys and the batch (mu, var). The
backward:

- recomputes the normalized outputs and each conv's input ELEMENTWISE from
  ys and the statistics (no conv is recomputed);
- runs the BN/ReLU backward of ``ops/bn_relu_vjp.py`` inline in the
  reverse loop, the data gradient of each dilated conv (a transposed conv)
  sequential, as the dependency demands;
- takes all G weight gradients as ONE batched product over the stacked
  three-tap inputs, accumulated in f32.

Layout is the port's, channels-first: x (B, C, T), kernels (G, w, w, 3) as
``nn.Conv1d`` stores them (the JAX op takes (B, T, C) and (G, 3, w, w)).

Inside ``ops/bn_relu_vjp.batch_norm_group`` (data-parallel training) the
chain's BN moments are the global batch's, as under JAX's GSPMD step,
where the op's batch means are global: the forward all-reduces each BN's
sums of r and r^2 over n = B T x the group's size, as
``ops/bn_relu_vjp.BNTrainVJP`` does, and the backward the sums behind its
two means (of dxhat and of dxhat xhat) with the cotangents of the
statistics. The weight gradients stay this rank's; the step's gradient
all-reduce averages them with the rest.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

import torch.distributed as dist

from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import (
    _all_reduce, current_group)


def _conv(sp: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dt: torch.dtype, d: int) -> torch.Tensor:
    """``models/common.conv1d`` of one dilated k=3 conv: the product in
    ``dt``, then the bias added in ``dt``."""
    return (F.conv1d(sp.to(dt), w.to(dt), None, 1, d, d)
            + b.to(dt)[:, None])


def _bn_stats(y: torch.Tensor, eps: float, group, n: int):
    """(r, mu, var, inv) of ReLU -> train BN over (B, T) in f32, as
    ``ops/bn_relu_vjp.BNTrainVJP`` computes them: over ``group``'s ranks
    (``n`` rows in all) where given."""
    r = torch.relu(y).float()
    if group is None:
        mu = r.mean((0, 2))
        var = torch.clamp((r * r).mean((0, 2)) - mu * mu, min=0.0)
    else:
        s = _all_reduce(torch.cat([r.sum((0, 2)), (r * r).sum((0, 2))]),
                        group)
        mu, ms = (s / n).chunk(2)
        var = torch.clamp(ms - mu * mu, min=0.0)
    return r, mu, var, torch.rsqrt(var + eps)


def _taps(sp: torch.Tensor, d: int) -> torch.Tensor:
    """(..., w, T) -> (..., 3, w, T): the inputs of the three dilated taps
    (x[t - d], x[t], x[t + d], zero outside), nn.Conv1d's kernel order."""
    z = torch.zeros_like(sp[..., :d])
    return torch.stack([torch.cat([z, sp[..., :-d]], -1), sp,
                        torch.cat([sp[..., d:], z], -1)], dim=-3)


class Res2ChainTrain(torch.autograd.Function):
    """(out, mus, vars) of the train-mode chain; residuals x, the kernels,
    the BN affines, ys and the statistics. ``group`` (no gradient) is the
    data-parallel BN group, or None."""

    @staticmethod
    def forward(ctx, x, W, CB, S, Bb, dilation: int, eps: float,
                group=None):
        G = W.shape[0]
        w = x.shape[1] // (G + 1)
        dt = x.dtype
        n = x.shape[0] * x.shape[2]
        if group is not None:
            n *= dist.get_world_size(group)
        outs, ys, mus, vrs = [], [], [], []
        sp = None
        for i in range(G):
            g = x[:, i * w:(i + 1) * w]
            sp = g if i == 0 else (sp + g).to(dt)
            y = _conv(sp, W[i], CB[i], dt, dilation)
            r, mu, var, inv = _bn_stats(y, eps, group, n)
            sp = ((r - mu[:, None]) * (inv * S[i])[:, None]
                  + Bb[i][:, None]).to(dt)
            outs.append(sp)
            ys.append(y)
            mus.append(mu)
            vrs.append(var)
        out = torch.cat(outs + [x[:, G * w:]], dim=1)
        mus, vrs = torch.stack(mus), torch.stack(vrs)
        ctx.save_for_backward(x, W, S, Bb, torch.stack(ys), mus, vrs)
        ctx.dilation, ctx.eps, ctx.group, ctx.n = dilation, eps, group, n
        return out, mus, vrs

    @staticmethod
    def backward(ctx, g_out, g_mus, g_vrs):
        x, W, S, Bb, ys, mus, vrs = ctx.saved_tensors
        d, eps, group, n = ctx.dilation, ctx.eps, ctx.group, ctx.n
        G = W.shape[0]
        C = x.shape[1]
        w = C // (G + 1)
        dt = x.dtype
        zero = torch.zeros((), device=x.device)

        # elementwise recompute: each conv's input and its BN's xhat
        sp_ins, rs, invs, xhats = [], [], [], []
        sp = None
        for i in range(G):
            g = x[:, i * w:(i + 1) * w]
            sp = g if i == 0 else (sp + g).to(dt)
            sp_ins.append(sp)
            r = torch.relu(ys[i]).float()
            inv = torch.rsqrt(vrs[i] + eps)
            xhat = (r - mus[i][:, None]) * inv[:, None]
            rs.append(r)
            invs.append(inv)
            xhats.append(xhat)
            sp = (xhat * S[i][:, None] + Bb[i][:, None]).to(dt)

        dys = [None] * G
        dS, dBb = [None] * G, [None] * G
        dX = [None] * G + [g_out[:, G * w:].float()]
        carry = None
        for i in reversed(range(G)):
            gz = g_out[:, i * w:(i + 1) * w].float()
            if carry is not None:
                gz = gz + carry
            dBb[i] = gz.sum((0, 2))
            dS[i] = (gz * xhats[i]).sum((0, 2))
            dxhat = gz * S[i][:, None]
            g_mu, g_var = g_mus[i], g_vrs[i]
            if group is None:
                m1 = dxhat.mean((0, 2))[:, None]
                m2 = (dxhat * xhats[i]).mean((0, 2))[:, None]
            else:
                # the group's means, and the statistics' cotangents of
                # every rank (each rank's loss reads the global moments)
                s = _all_reduce(torch.cat([
                    dxhat.sum((0, 2)), (dxhat * xhats[i]).sum((0, 2)),
                    g_mu.float(), g_var.float()]), group)
                m1, m2, g_mu, g_var = s.chunk(4)
                m1, m2 = (m1 / n)[:, None], (m2 / n)[:, None]
            dr = invs[i][:, None] * (dxhat - m1 - xhats[i] * m2)
            dr = (dr + g_mu[:, None] / n
                  + (2.0 / n) * g_var[:, None] * (rs[i] - mus[i][:, None]))
            dy = torch.where(ys[i] > 0, dr, zero).to(dt)
            dys[i] = dy
            # the dilated conv's data gradient: the transposed conv
            dsp = F.conv_transpose1d(dy, W[i].to(dt), None, 1, d, 0, 1,
                                     d).float()
            dX[i] = dsp
            carry = dsp   # into z_{i-1}, through sp_i = z_{i-1} + g_i

        # ONE batched product for every weight gradient, f32 accumulation
        X3 = _taps(torch.stack(sp_ins), d).float()        # (G, B, 3, w, T)
        DY = torch.stack(dys).float()                     # (G, B, w, T)
        dW = torch.einsum("gbot,gbkit->goik", DY, X3).to(W.dtype)
        dCB = DY.sum((1, 3))
        return (torch.cat(dX, dim=1).to(dt), dW, dCB, torch.stack(dS),
                torch.stack(dBb), None, None, None)


def res2_chain_train(x: torch.Tensor, W: torch.Tensor, CB: torch.Tensor,
                     S: torch.Tensor, Bb: torch.Tensor, dilation: int,
                     eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode Res2 chain: x (B, C, T), the block's post-1x1
    activation -> (out (B, C, T), mus (G, w), vars (G, w)).

    W (G, w, w, 3) conv kernels, CB (G, w) conv biases, S and Bb (G, w)
    the BN scales and biases (all f32). Groups 0..G-1 are convolved, the
    last passes through. Inside ``ops/bn_relu_vjp.batch_norm_group`` the
    statistics are the group's (the module docstring)."""
    return Res2ChainTrain.apply(x, W, CB, S, Bb, dilation, eps,
                                current_group())


def chain_params(convs, bns) -> Tuple[torch.Tensor, ...]:
    """(W, CB, S, Bb) stacked from a Bottle2neck's ``convs`` and ``bns``,
    differentiable back to each module's parameters."""
    return (torch.stack([c.weight for c in convs]),
            torch.stack([c.bias for c in convs]),
            torch.stack([b.weight for b in bns]),
            torch.stack([b.bias for b in bns]))


def update_running_stats(bns, mus: torch.Tensor, vrs: torch.Tensor) -> None:
    """Each BN's running-statistics update from the chain's batch stats."""
    for i, bn in enumerate(bns):
        bn._update(mus[i].detach(), vrs[i].detach())
