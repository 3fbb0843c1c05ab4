"""Pre-activation ResNet over the (frequency x time) plane, with
self-attentive statistics pooling, in eval and train mode.

Counterpart of the JAX package's ``models/resnet.py`` (``PreActBlock``,
``PreActBottleneck``, ``RESNET_CONFIGS``, ``ResNet``) with the reference's
state_dict names (``conv1``, ``bn1``, ``layer{1..4}.{b}.{bn1, conv1, bn2,
conv2, shortcut.0}``, ``conv5``, ``bn5``, ``attention.att_weights``, ``fc``,
``fc_mu``; the JAX package's ``interop/torch_port.port_resnet``):

- a (9, 3) / (3, 1) stem to 16 channels, BN -> ReLU;
- four stages of pre-activation blocks at 64/128/256/512 channels, strides
  1/2/2/2 (ResNet18: two basic blocks a stage);
- conv5, (num_nodes, 3) with padding (0, 1), collapsing the frequency
  axis (60 -> 18 -> 18 -> 9 -> 5 -> 3 -> 1 for 60-dim LFCC), BN -> ReLU;
- ``SelfAttentionPooling(256)`` over time, then ``fc`` (embedding) and
  ``fc_mu`` (logits), all three in f32.

The forward takes (B, T, F) features and returns (embedding, logits) in
f32. Every BN -> ReLU pair runs through ``ops/bn_relu_vjp.bn_relu_train``
in train mode with ``fused_bn`` (the default; the JAX model's flag), or
through plain autograd without it. In train mode the pooling
adds 1e-5 times standard-normal ``draws`` (B, T', 256) to its weighted
frames, the JAX model's ``noise`` stream; :meth:`ResNet.draw` makes them
from a generator (the train step draws them eagerly, outside a CUDA
graph). ``dtype`` (None or ``torch.bfloat16``) is the JAX model's compute
dtype: the convs and BNs return it, the pooling and the two dense layers
run in f32. Weights start as flax initializes the JAX model
(``conv_kaiming_init`` convs, ``linear_kaiming_init`` dense kernels and
attention weights, zero biases).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm, SelfAttentionPooling, conv, conv_kaiming_, dense,
    linear_kaiming_, set_fused_bn, to_2d_input)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)


def _shortcut(cin: int, cout: int, stride: int) -> Optional[nn.Sequential]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False))


class PreActBlock(nn.Module):
    """relu(bn1(x)) -> conv1 (3x3, stride) -> relu(bn2) -> conv2 (3x3),
    plus x or, where the shape changes, ``shortcut.0`` (1x1, stride) of
    relu(bn1(x))."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.bn1 = BatchNorm(in_planes, dtype=dtype)
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv2 = _conv3x3(planes, planes)
        self.shortcut = _shortcut(in_planes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = self.bn1.bn_relu(x)
        short = x if self.shortcut is None else conv(self.shortcut[0], out,
                                                     dt)
        out = conv(self.conv1, out, dt)
        return conv(self.conv2, self.bn2.bn_relu(out), dt) + short


class PreActBottleneck(nn.Module):
    """relu(bn1(x)) -> conv1 (1x1) -> relu(bn2) -> conv2 (3x3, stride) ->
    relu(bn3) -> conv3 (1x1, 4 x planes), plus x or ``shortcut.0`` of
    relu(bn1(x)). No configuration the port builds uses it ("50" and "101"
    would)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.bn1 = BatchNorm(in_planes, dtype=dtype)
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn3 = BatchNorm(planes, dtype=dtype)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.shortcut = _shortcut(in_planes, 4 * planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = self.bn1.bn_relu(x)
        short = x if self.shortcut is None else conv(self.shortcut[0], out,
                                                     dt)
        out = conv(self.conv1, out, dt)
        out = conv(self.conv2, self.bn2.bn_relu(out), dt)
        return conv(self.conv3, self.bn3.bn_relu(out), dt) + short


RESNET_CONFIGS = {
    "18": ([2, 2, 2, 2], PreActBlock),
    "28": ([3, 4, 6, 3], PreActBlock),
    "34": ([3, 4, 6, 3], PreActBlock),
    "50": ([3, 4, 6, 3], PreActBottleneck),
    "101": ([3, 4, 23, 3], PreActBottleneck),
}

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))   # (planes, stride)


def pooled_frames(frames: int) -> int:
    """T' of the pooling for T input frames: three stride-2 stages of
    (t - 1) // 2 + 1; the stem and conv5 keep T."""
    for _ in range(3):
        frames = (frames - 1) // 2 + 1
    return frames


class ResNet(nn.Module):
    """``num_nodes`` is the frequency extent entering conv5 (3 for 60-dim
    LFCC). Built on ``device`` (the GPU unless the caller asks for the
    CPU), initialized from ``generator`` (a CPU generator; torch's global
    one when None)."""

    def __init__(self, num_nodes: int = 3, enc_dim: int = 256,
                 resnet_type: str = "18", nclasses: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 fused_bn: bool = True):
        super().__init__()
        dev = resolve_device(device)
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        self.dtype = dtype
        layers, block = RESNET_CONFIGS[resnet_type]
        self.conv1 = nn.Conv2d(1, 16, (9, 3), (3, 1), padding=(1, 1),
                               bias=False)
        self.bn1 = BatchNorm(16, dtype=dtype)
        in_planes = 16
        for i, ((planes, stride), n) in enumerate(zip(STAGES, layers)):
            blocks = []
            for b in range(n):
                blocks.append(block(in_planes, planes, stride if b == 0
                                    else 1, dtype))
                in_planes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.conv5 = nn.Conv2d(in_planes, 256, (num_nodes, 3),
                               padding=(0, 1), bias=False)
        self.bn5 = BatchNorm(256, dtype=dtype)
        self.attention = SelfAttentionPooling(256)
        self.fc = nn.Linear(512, enc_dim)
        self.fc_mu = nn.Linear(enc_dim, nclasses if nclasses >= 2 else 1)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_kaiming_(m.weight, generator)
            elif isinstance(m, nn.Linear):
                linear_kaiming_(m.weight, generator)
                nn.init.zeros_(m.bias)
        linear_kaiming_(self.attention.att_weights, generator)
        set_fused_bn(self, fused_bn)
        self.to(dev)

    def draw(self, batch: int, frames: int,
             generator: Optional[torch.Generator] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pooling noise of one train-mode forward of ``batch``
        utterances of ``frames`` frames: (batch, T', 256) standard-normal
        f32 draws on the model's device, written into ``out`` where given."""
        dev = self.fc.weight.device
        noise = torch.randn((batch, pooled_frames(frames), 256),
                            generator=generator, device=dev)
        return noise if out is None else out.copy_(noise)

    def forward(self, feats: torch.Tensor,
                draws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding, logits) of (B, T, F) features; in train mode the
        pooling noise is ``draws`` (drawn here from torch's generator when
        None)."""
        dt = self.dtype
        if dt is None:
            disable_tf32()
        x = to_2d_input(feats)
        x = self.bn1.bn_relu(conv(self.conv1, x, dt))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.bn5.bn_relu(conv(self.conv5, x, dt))
        x = x.squeeze(2).transpose(1, 2).float()        # (B, T', 256)
        if self.training and draws is None:
            draws = torch.randn_like(x)
        stats = self.attention(x, draws if self.training else None)
        feat = dense(self.fc, stats, None)
        return feat, dense(self.fc_mu, feat, None)
