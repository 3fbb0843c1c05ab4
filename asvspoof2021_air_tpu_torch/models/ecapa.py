"""ECAPA-TDNN in eval and train mode with the reference's state_dict names.

Counterpart of the JAX package's ``models/ecapa.py`` ``ECAPA_TDNN`` and
``Bottle2neck`` (by default context attention, the "ECA" encoder,
out-BN):

- stem conv k=5 F -> C, ReLU, BN (``conv1``, ``bn1``);
- three SE-Res2 Bottle2necks, kernel 3, dilations 2/3/4 (``layer1..3``);
- the MFA 1x1 conv over [x1 | x2 | x3] to 1536, ReLU (``layer4``);
- context attentive-statistics pooling (``attention.0/2/3``);
- BN -> embedding -> logits -> BN (``bn5``, ``fc6``, ``fc7``, ``bn7``).

The public forward takes (B, T, F) channels-last features, as the JAX model
does, and returns (embedding, logits) in f32.

Train mode is the JAX model's: batch-statistics BN with the JAX
running-statistics rule, the Res2 chain as seven plain convs (or, with
``fused_chain``, through ``ops/res2_chain_vjp.py``), every ReLU -> BN pair
through the recompute VJP (``ops/bn_relu_vjp.py``) with ``fused_bn`` (the
default) or through plain autograd without it, and the attention tail
through :class:`~asvspoof2021_air_tpu_torch.ops.attn_pool_vjp.FusedSoftmaxStats`
(kernels B4a/B4b on the card) or, with ``fused_pool=False``, as the JAX
model's unfused tail: the 1x1 conv ``attention.3`` in the compute type,
the softmax over T in f32, the statistics summed in f32. ``fused_pool``
None (the default) pools through B4a/B4b in train mode and through that
unfused tail in eval mode, the plain reference on the card (the serving
graph with the CUDA kernels is ``serving/ecapa_serving.py``); True pools
through B4a in eval mode too, as the JAX eval step does; False never
reaches B4a/B4b. ``attention``'s ReLU and Softmax entries only keep the
reference's state_dict indices. Weights start as flax initializes them
(lecun-normal kernels, zero biases).

The JAX model's variant fields are here with its defaults: ``context``
(False: the attention reads x alone, ``attention.0`` is 1536 -> 128),
``summed`` (the blocks read x + x1 and x + x1 + x2), ``encoder_type`` (any
value but "ECA" gives one attention channel, ``attention.3`` 128 -> 1,
whose weights every channel shares) and ``out_bn`` (False: no ``bn7``).
As in the JAX model (``models/ecapa.py:270`` there), a one-channel
attention never pools through B4a/B4b, whatever ``fused_pool`` says.

``dtype`` (None or ``torch.bfloat16``) is the JAX model's compute dtype
(``models/ecapa.py:202-300`` there): the parameters stay f32, every conv
and dense computes in ``dtype`` (``models/common.py``), and so do the MFA
product (three products, one per block, summed in ``dtype``) and the
context term; the BatchNorms return ``dtype``; x and h2 reach B4a/B4b in
``dtype`` beside f32 W2 and b2; ``[mu || sigma]`` is cast to ``dtype``
before ``bn5``; embedding and logits leave the model in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm1d, SEModule1D, conv, conv1d, dense, init_flax_like_,
    set_fused_bn)
from asvspoof2021_air_tpu_torch.ops.attn_pool_vjp import fused_softmax_stats
from asvspoof2021_air_tpu_torch.ops.res2_chain_vjp import (
    chain_params, res2_chain_train, update_running_stats)
from asvspoof2021_air_tpu_torch.utils.profiling import span


class Bottle2neck(nn.Module):
    """SE-Res2 block over (B, C, T); ``fused_chain`` runs the train-mode
    conv chain through ``ops/res2_chain_vjp.res2_chain_train``;
    ``fused_bn`` is its BNs' ``BatchNorm.fused`` (its ReLU -> BN
    pairs')."""

    def __init__(self, planes: int, kernel_size: int = 3, dilation: int = 1,
                 scale: int = 8, dtype: Optional[torch.dtype] = None,
                 fused_chain: bool = False, fused_bn: bool = True):
        super().__init__()
        width = int(math.floor(planes / scale))
        self.width, self.scale, self.dtype = width, scale, dtype
        self.fused_chain = fused_chain and kernel_size == 3
        self.dilation = dilation
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
        set_fused_bn(self, fused_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = self.bn1.relu_bn(conv(self.conv1, x, dt))
        if self.fused_chain and self.training:
            out, mus, vrs = res2_chain_train(
                out, *chain_params(self.convs, self.bns), self.dilation,
                self.bns[0].eps)
            update_running_stats(self.bns, mus, vrs)
        else:
            groups = torch.split(out, self.width, dim=1)
            outs, sp = [], None
            for i in range(self.scale - 1):
                sp = groups[i] if i == 0 else sp + groups[i]
                sp = self.bns[i].relu_bn(conv(self.convs[i], sp, dt))
                outs.append(sp)
            outs.append(groups[self.scale - 1])
            out = torch.cat(outs, dim=1)
        out = self.bn3.relu_bn(conv(self.conv3, out, dt))
        return self.se(out) + x


class ECAPA_TDNN(nn.Module):
    """Canonical instantiation: C=512, model_scale=8, n_out=2, n_feat=60,
    enc_dim=256. Built on ``device`` (the GPU unless the caller asks for
    the CPU), initialized from ``generator`` (a CPU generator; torch's
    global one when None); ``dtype`` is the compute dtype (None: f32);
    ``fused_pool`` and ``fused_bn`` pick the train-mode paths of the
    module docstring; ``context``, ``summed``, ``encoder_type`` and
    ``out_bn`` are the JAX model's variant fields. ``fused_chain`` (the
    JAX model's flag) runs each block's train-mode
    Res2 chain through ``ops/res2_chain_vjp`` (the same values and
    statistics; eval mode is unchanged). It is kept for parity with the
    JAX model's API, set by no CLI flag or ``TrainConfig`` field, and
    loses on time: one f32 step at B = 64, T = 750 takes 4-9% longer for
    a 6% lower peak (3.46 GiB against 3.68; ``chip_smoke.py`` phase 8c
    on an NVIDIA H100 80GB HBM3 at 700 W)."""

    def __init__(self, C: int = 512, model_scale: int = 8, n_out: int = 2,
                 n_feat: int = 60, enc_dim: int = 256,
                 fused_pool: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 fused_chain: bool = False, fused_bn: bool = True,
                 context: bool = True, summed: bool = False,
                 encoder_type: str = "ECA", out_bn: bool = True):
        super().__init__()
        dev = resolve_device(device)
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        self.fused_pool, self.dtype = fused_pool, dtype
        self.context, self.summed, self.out_bn = context, summed, out_bn
        self.attn_output = 1536 if encoder_type == "ECA" else 1
        self.conv1 = nn.Conv1d(n_feat, C, kernel_size=5, padding=2)
        self.bn1 = BatchNorm1d(C, dtype=dtype)
        block = lambda d: Bottle2neck(C, 3, d, model_scale, dtype,
                                      fused_chain, fused_bn)
        self.layer1, self.layer2, self.layer3 = block(2), block(3), block(4)
        self.layer4 = nn.Conv1d(3 * C, 1536, kernel_size=1)
        self.attention = nn.Sequential(
            nn.Conv1d(3 * 1536 if context else 1536, 128, kernel_size=1),
            nn.ReLU(),
            BatchNorm1d(128, dtype=dtype),
            nn.Conv1d(128, self.attn_output, kernel_size=1),
            nn.Softmax(dim=2),
        )
        self.bn5 = BatchNorm1d(3072, dtype=dtype)
        self.fc6 = nn.Linear(3072, enc_dim)
        self.fc7 = nn.Linear(enc_dim, n_out)
        if out_bn:
            self.bn7 = BatchNorm1d(n_out, dtype=dtype)
        init_flax_like_(self, generator)
        set_fused_bn(self, fused_bn)
        self.to(dev)

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        if dt is None:
            disable_tf32()
        with span("asv.trunk", feats) as s:
            x = self.bn1.relu_bn(conv(self.conv1, feats.transpose(1, 2), dt))
            x1 = self.layer1(x)
            if self.summed:
                x2 = self.layer2(x + x1)
                x3 = self.layer3(x + x1 + x2)
            else:
                x2 = self.layer2(x1)
                x3 = self.layer3(x2)
            # The MFA 1x1 conv over [x1 | x2 | x3] as the JAX model
            # computes it: one product per block, summed (in dtype), then
            # the bias.
            C, w4 = x1.shape[1], self.layer4.weight
            x = (conv1d(x1, w4[:, :C], None, dt)
                 + conv1d(x2, w4[:, C:2 * C], None, dt)
                 + conv1d(x3, w4[:, 2 * C:], None, dt))
            x = s.out(F.relu(x + self.layer4.bias.to(x.dtype)[:, None]))
        fused = (self.fused_pool
                 or (self.fused_pool is None and self.training))
        with span("asv.pool", x) as s:
            if fused and self.attn_output == 1536:
                mu, sg = s.out(self._fused_pooling(x))
            else:
                mu, sg = s.out(self._unfused_pooling(x))
        x = torch.cat([mu, sg], dim=1)
        x = self.bn5(x if dt is None else x.to(dt))
        feat = dense(self.fc6, x, dt)
        out = dense(self.fc7, feat, dt)
        if self.out_bn:
            out = self.bn7(out)
        return feat.float(), out.float()

    def _attention_hidden(self, xt: torch.Tensor) -> torch.Tensor:
        """h2 of x (B, T, D) as the JAX model computes it (the JAX
        package's ``models/ecapa.py:245-269``), channels-last: the context
        conv as one product over x plus a per-utterance term from (mean,
        std) (with ``context``), the bias, then ReLU -> BN."""
        D, dt = xt.shape[-1], xt.dtype
        wa = self.attention[0].weight[:, :, 0].to(dt)    # (128, 3 D or D)
        bias = self.attention[0].bias.to(dt)
        if self.context:
            # jnp.mean / jnp.var: f32 sums, returned in x's type
            xf = xt.float()
            mean = xf.mean(dim=1).to(dt)
            std = torch.sqrt(torch.clamp(xf.var(dim=1).to(dt), min=1e-4))
            const = mean @ wa[:, D:2 * D].t() + std @ wa[:, 2 * D:].t()
            h = (xt @ wa[:, :D].t()) + const[:, None, :] + bias
        else:
            h = (xt @ wa.t()) + bias
        return self.attention[2].relu_bn(h, dim=-1)

    def _fused_pooling(self, x: torch.Tensor):
        """The attentive statistics of x (B, D, T) as the JAX model's fused
        tail computes them (``models/ecapa.py:251-281`` there): h2, then
        (mu, e2) through FusedSoftmaxStats and sigma outside it."""
        xt = x.transpose(1, 2).contiguous()             # (B, T, D)
        h2 = self._attention_hidden(xt)
        w2 = self.attention[3].weight[:, :, 0].t().contiguous()   # (128, D)
        mu, e2 = fused_softmax_stats(xt, h2, w2, self.attention[3].bias)
        return mu, torch.sqrt(torch.clamp(e2 - mu * mu, min=1e-4))

    def _unfused_pooling(self, x: torch.Tensor):
        """The attentive statistics of x (B, D, T) as the JAX model's
        unfused tail computes them (``models/ecapa.py:270-289`` there):
        h2, the 1x1 conv ``attention.3`` in the compute type, the softmax
        over T in f32 cast back, then mu and sigma summed in f32."""
        xt = x.transpose(1, 2)                          # (B, T, D)
        h2 = self._attention_hidden(xt)
        dt = h2.dtype
        conv2 = self.attention[3]
        w = (h2 @ conv2.weight[:, :, 0].t().to(dt)) + conv2.bias.to(dt)
        w = torch.softmax(w.float(), dim=1).to(dt)
        xf, wf = xt.float(), w.float()
        mu = torch.sum(xf * wf, dim=1)
        sg = torch.sqrt(torch.clamp(torch.sum(xf * xf * wf, dim=1) - mu * mu,
                                    min=1e-4))
        return mu, sg
