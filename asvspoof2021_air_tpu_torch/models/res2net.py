"""SE-Res2Net50 over the (frequency x time) plane, in eval and train mode.

Counterpart of the JAX package's ``models/res2net.py`` (``SEBottle2neck``,
``SERes2Net50``) with the reference's state_dict names (the JAX package's
``interop/torch_port.port_se_res2net50``):

- the stem ``conv1`` = [``conv1.0`` 3x3 to 16, ``conv1.1`` BN, ReLU,
  ``conv1.3`` 3x3, ``conv1.4`` BN, ReLU, ``conv1.6`` 3x3], then ``bn1``,
  ReLU;
- four stages ``layer{1..4}`` of 3/4/6/3 SE bottlenecks at planes
  16/32/64/128 (expansion 2), strides 1/2/2/2, scale 4, base width 26:
  ``conv1`` (1x1) -> ``bn1`` -> ReLU, split into 4 groups, three chained
  3x3 ``convs.j`` -> ``bns.j`` -> ReLU (a stage's first block convolves
  each group on its own, at the stage's stride, and average-pools the
  last one 3x3 with padding 1 counted in the mean, as ``flax.linen.
  avg_pool``), ``conv3`` (1x1) -> ``bn3`` -> ``se`` (``SELayer2D``,
  ``se.fc.{0,2}``), plus x or ``downsample`` = [average pool of
  stride x stride in ceil mode over the valid window only, ``.1`` 1x1
  conv, ``.2`` BN], then ReLU;
- the mean over (frequency, time) is the 256-dim embedding; ``cls_layer``
  gives the logits, returned as log-probabilities.

Every conv is bias-free. The BN -> ReLU pairs run through
``ops/bn_relu_vjp.bn_relu_train`` in train mode with ``fused_bn`` (the
default; the JAX model's flag), or through plain autograd without it;
``bn3`` and the downsample BN take autograd's VJP, as the
JAX ``batch_norm(train)`` takes autodiff there. The model computes in f32:
the JAX registry builds it without a compute dtype. Weights start as flax
initializes the JAX model (``conv_kaiming_init`` convs, lecun-normal dense
kernels, zero biases).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm, SELayer2D, conv, conv_kaiming_, dense, lecun_normal_,
    set_fused_bn, to_2d_input)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class SEBottle2neck(nn.Module):
    """One SE-Res2 bottleneck of ``planes`` (output 2 x planes);
    ``stype`` "stage" for a stage's first block, else "normal"."""

    expansion = 2

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 26, scale: int = 4,
                 stype: str = "normal"):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        out_planes = planes * self.expansion
        self.width, self.scale, self.stride, self.stype = (width, scale,
                                                           stride, stype)
        self.nums = 1 if scale == 1 else scale - 1
        self.conv1 = _conv(in_planes, width * scale, 1)
        self.bn1 = BatchNorm(width * scale)
        self.convs = nn.ModuleList(_conv(width, width, 3, stride)
                                   for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(self.nums))
        self.conv3 = _conv(width * scale, out_planes, 1)
        self.bn3 = BatchNorm(out_planes)
        self.se = SELayer2D(out_planes, reduction=16)
        self.downsample = None
        if stride != 1 or in_planes != out_planes:
            self.downsample = nn.Sequential(
                nn.AvgPool2d(stride, stride, ceil_mode=True,
                             count_include_pad=False),
                _conv(in_planes, out_planes, 1), BatchNorm(out_planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1.bn_relu(conv(self.conv1, x, None))
        groups = torch.split(out, self.width, dim=1)
        outs, sp = [], None
        for i in range(self.nums):
            sp = groups[i] if i == 0 or self.stype == "stage" \
                else sp + groups[i]
            sp = self.bns[i].bn_relu(conv(self.convs[i], sp, None))
            outs.append(sp)
        if self.scale != 1:
            last = groups[-1]
            if self.stype == "stage":
                last = F.avg_pool2d(last, 3, self.stride, 1,
                                    count_include_pad=True)
            outs.append(last)
        out = self.bn3(conv(self.conv3, torch.cat(outs, dim=1), None))
        out = self.se(out)
        if self.downsample is None:
            return torch.relu(out + x)
        pool, proj, bn = self.downsample
        residual = pool(x) if self.stride != 1 else x
        return torch.relu(out + bn(conv(proj, residual, None)))


class SERes2Net50(nn.Module):
    """``num_classes`` logits over the 256-dim embedding; built on
    ``device`` (the GPU unless the caller asks for the CPU), initialized
    from ``generator`` (a CPU generator; torch's global one when None)."""

    def __init__(self, num_classes: int = 2, base_width: int = 26,
                 scale: int = 4, layers: Sequence[int] = (3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None, device="cuda",
                 fused_bn: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = nn.Sequential(
            _conv(1, 16, 3), BatchNorm(16), nn.ReLU(), _conv(16, 16, 3),
            BatchNorm(16), nn.ReLU(), _conv(16, 16, 3))
        self.bn1 = BatchNorm(16)
        in_planes = 16
        for i, (planes, n, stride) in enumerate(zip((16, 32, 64, 128),
                                                    layers, (1, 2, 2, 2))):
            blocks = [SEBottle2neck(in_planes, planes, stride, base_width,
                                    scale, stype="stage")]
            in_planes = planes * SEBottle2neck.expansion
            blocks += [SEBottle2neck(in_planes, planes, 1, base_width, scale)
                       for _ in range(1, n)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.cls_layer = nn.Linear(in_planes, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_kaiming_(m.weight, generator)
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        set_fused_bn(self, fused_bn)
        self.to(dev)

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding (B, 256), log-probabilities (B, num_classes)) of
        (B, T, F) features, in f32."""
        disable_tf32()
        c0, bn0, _, c3, bn4, _, c6 = self.conv1
        x = to_2d_input(feats.float())
        x = bn4.bn_relu(conv(c3, bn0.bn_relu(conv(c0, x, None)), None))
        x = self.bn1.bn_relu(conv(c6, x, None))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        feat = x.mean((2, 3))
        out = dense(self.cls_layer, feat, None)
        return feat, torch.log_softmax(out, dim=-1)
