"""ECAPA-TDNN in eval and train mode with the reference's state_dict names.

Counterpart of the JAX package's ``models/ecapa.py`` ``ECAPA_TDNN`` and
``Bottle2neck`` (context attention, the "ECA" encoder, out-BN):

- stem conv k=5 F -> C, ReLU, BN (``conv1``, ``bn1``);
- three SE-Res2 Bottle2necks, kernel 3, dilations 2/3/4 (``layer1..3``);
- the MFA 1x1 conv over [x1 | x2 | x3] to 1536, ReLU (``layer4``);
- context attentive-statistics pooling (``attention.0/2/3``);
- BN -> embedding -> logits -> BN (``bn5``, ``fc6``, ``fc7``, ``bn7``).

The public forward takes (B, T, F) channels-last features, as the JAX model
does, and returns (embedding, logits) in f32.

Eval mode without ``fused_pool`` is the unfused plain path, the f32
reference on the card; the serving graph with the CUDA kernels is
``serving/ecapa_serving.py``. Train mode is the JAX model with
``fused_pool=True, fused_bn=True``: batch-statistics BN with the JAX
running-statistics rule, every ReLU -> BN pair through the recompute VJP
(``ops/bn_relu_vjp.py``), the Res2 chain as seven plain convs, and the
attention tail through :class:`~asvspoof2021_air_tpu_torch.ops.attn_pool_vjp.FusedSoftmaxStats`
(kernels B4a/B4b on the card). With ``fused_pool`` the eval forward also
pools through B4a, as the JAX eval step does. Weights start as flax
initializes them (lecun-normal kernels, zero biases).

``dtype`` (None or ``torch.bfloat16``) is the JAX model's compute dtype
(``models/ecapa.py:202-300`` there): the parameters stay f32, every conv
and dense computes in ``dtype`` (``models/common.py``), and so do the MFA
product (three products, one per block, summed in ``dtype``) and the
context term; the BatchNorms return ``dtype``; x and h2 reach B4a/B4b in
``dtype`` beside f32 W2 and b2; ``[mu || sigma]`` is cast to ``dtype``
before ``bn5``; embedding and logits leave the model in f32. It needs
``fused_pool`` (the unfused pooling is the f32 reference).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm1d, SEModule1D, conv, conv1d, dense, init_flax_like_)
from asvspoof2021_air_tpu_torch.ops.attn_pool_vjp import fused_softmax_stats


class Bottle2neck(nn.Module):
    """SE-Res2 block over (B, C, T)."""

    def __init__(self, planes: int, kernel_size: int = 3, dilation: int = 1,
                 scale: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        width = int(math.floor(planes / scale))
        self.width, self.scale, self.dtype = width, scale, dtype
        self.conv1 = nn.Conv1d(planes, width * scale, kernel_size=1)
        self.bn1 = BatchNorm1d(width * scale, dtype=dtype)
        pad = (kernel_size // 2) * dilation
        self.convs = nn.ModuleList(
            nn.Conv1d(width, width, kernel_size, dilation=dilation,
                      padding=pad) for _ in range(scale - 1))
        self.bns = nn.ModuleList(BatchNorm1d(width, dtype=dtype)
                                 for _ in range(scale - 1))
        self.conv3 = nn.Conv1d(width * scale, planes, kernel_size=1)
        self.bn3 = BatchNorm1d(planes, dtype=dtype)
        self.se = SEModule1D(planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = self.bn1.relu_bn(conv(self.conv1, x, dt))
        groups = torch.split(out, self.width, dim=1)
        outs, sp = [], None
        for i in range(self.scale - 1):
            sp = groups[i] if i == 0 else sp + groups[i]
            sp = self.bns[i].relu_bn(conv(self.convs[i], sp, dt))
            outs.append(sp)
        outs.append(groups[self.scale - 1])
        out = self.bn3.relu_bn(conv(self.conv3, torch.cat(outs, dim=1), dt))
        return self.se(out) + x


class ECAPA_TDNN(nn.Module):
    """Canonical instantiation: C=512, model_scale=8, n_out=2, n_feat=60,
    enc_dim=256. Built on ``device`` (the GPU unless the caller asks for
    the CPU), initialized from ``generator`` (a CPU generator; torch's
    global one when None); ``dtype`` is the compute dtype (None: f32)."""

    def __init__(self, C: int = 512, model_scale: int = 8, n_out: int = 2,
                 n_feat: int = 60, enc_dim: int = 256,
                 fused_pool: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        if dtype is not None and not fused_pool:
            raise ValueError("a compute dtype needs fused_pool=True (the "
                             "unfused pooling is the f32 reference)")
        self.fused_pool, self.dtype = fused_pool, dtype
        self.conv1 = nn.Conv1d(n_feat, C, kernel_size=5, padding=2)
        self.bn1 = BatchNorm1d(C, dtype=dtype)
        self.layer1 = Bottle2neck(C, 3, 2, model_scale, dtype)
        self.layer2 = Bottle2neck(C, 3, 3, model_scale, dtype)
        self.layer3 = Bottle2neck(C, 3, 4, model_scale, dtype)
        self.layer4 = nn.Conv1d(3 * C, 1536, kernel_size=1)
        self.attention = nn.Sequential(
            nn.Conv1d(3 * 1536, 128, kernel_size=1),
            nn.ReLU(),
            BatchNorm1d(128, dtype=dtype),
            nn.Conv1d(128, 1536, kernel_size=1),
            nn.Softmax(dim=2),
        )
        self.bn5 = BatchNorm1d(3072, dtype=dtype)
        self.fc6 = nn.Linear(3072, enc_dim)
        self.fc7 = nn.Linear(enc_dim, n_out)
        self.bn7 = BatchNorm1d(n_out, dtype=dtype)
        init_flax_like_(self, generator)
        self.to(dev)

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        if dt is None:
            disable_tf32()
        x = self.bn1.relu_bn(conv(self.conv1, feats.transpose(1, 2), dt))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        # The MFA 1x1 conv over [x1 | x2 | x3] as the JAX model computes
        # it: one product per block, summed (in dtype), then the bias.
        C, w4 = x1.shape[1], self.layer4.weight
        x = (conv1d(x1, w4[:, :C], None, dt)
             + conv1d(x2, w4[:, C:2 * C], None, dt)
             + conv1d(x3, w4[:, 2 * C:], None, dt))
        x = F.relu(x + self.layer4.bias.to(x.dtype)[:, None])
        if self.training or self.fused_pool:
            mu, sg = self._fused_pooling(x)
        else:
            mu, sg = self._pooling(x)
        x = torch.cat([mu, sg], dim=1)
        x = self.bn5(x if dt is None else x.to(dt))
        feat = dense(self.fc6, x, dt)
        out = self.bn7(dense(self.fc7, feat, dt))
        return feat.float(), out.float()

    def _pooling(self, x: torch.Tensor):
        """The unfused attentive statistics of x (B, D, T): (mu, sigma)."""
        T = x.shape[-1]
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp(x.var(dim=2, keepdim=True), min=1e-4))
        ctx = torch.cat([x, mean.expand(-1, -1, T), std.expand(-1, -1, T)],
                        dim=1)
        w = self.attention(ctx)
        mu = torch.sum(x * w, dim=2)
        sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu,
                                    min=1e-4))
        return mu, sg

    def _fused_pooling(self, x: torch.Tensor):
        """The attentive statistics of x (B, D, T) as the JAX model's fused
        tail computes them (the JAX package's ``models/ecapa.py:251-281``),
        channels-last: the context conv as one product over x plus a
        per-utterance term from (mean, std), ReLU -> BN, then (mu, e2)
        through FusedSoftmaxStats and sigma outside it."""
        xt = x.transpose(1, 2).contiguous()             # (B, T, D)
        D, dt = xt.shape[-1], xt.dtype
        wa = self.attention[0].weight[:, :, 0].to(dt)    # (128, 3 D)
        # jnp.mean / jnp.var: f32 sums, returned in x's type
        xf = xt.float()
        mean = xf.mean(dim=1).to(dt)
        std = torch.sqrt(torch.clamp(xf.var(dim=1).to(dt), min=1e-4))
        const = mean @ wa[:, D:2 * D].t() + std @ wa[:, 2 * D:].t()
        h = ((xt @ wa[:, :D].t()) + const[:, None, :]
             + self.attention[0].bias.to(dt))
        h2 = self.attention[2].relu_bn(h, dim=-1)
        w2 = self.attention[3].weight[:, :, 0].t().contiguous()   # (128, D)
        mu, e2 = fused_softmax_stats(xt, h2, w2, self.attention[3].bias)
        return mu, torch.sqrt(torch.clamp(e2 - mu * mu, min=1e-4))
