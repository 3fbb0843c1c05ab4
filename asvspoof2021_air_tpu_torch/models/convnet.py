"""The plain CNN baseline (ConvNet), in eval and train mode.

Counterpart of the JAX package's ``models/convnet.py`` ``ConvNet`` with
the reference's state_dict names (the JAX package's
``interop/torch_port.port_convnet``): four blocks ``layer{1..4}``, each a
bias-free ``layer{i}.0`` convolution (5x5 strided and dilated, then 3x3)
and a ``layer{i}.1`` BN followed by leaky ReLU 0.1; then either
``fc1`` over the flattened maps (to 256), ``fc2`` (to ``enc_dim``, the
embedding) and ``fc3`` (the logits), or, ``subband_attention``, a fifth
block ``layer5`` collapsing the ``num_nodes`` frequency rows, attentive
statistics pooling over time (``attention.att_weights``), ``fc2`` and
``fc3``.

The forward takes (B, T, F) features, NCHW inside with H the frequency
axis, and returns (embedding, logits) in f32: the JAX registry builds the
model without a compute dtype. The flatten before ``fc1`` is C-major (c,
h, w), the reference's; the JAX model's NHWC flatten is C-minor, and
``interop/flax_weights`` permutes ``fc1``'s columns. ``fc1`` is sized from
``feat_dim`` x ``feat_len`` (:func:`convnet_extent`; 60 x 750 LFCC reach
layer 4 at 6 x 123, so 47232 -> 256). The BN -> leaky ReLU pairs run
through ``ops/bn_relu_vjp.bn_leaky_relu_train`` in train mode (the JAX
model's ``fused_bn``). With ``subband_attention`` the train-mode pooling
adds 1e-5 times standard-normal ``draws`` (B, T', 128) to its weighted
frames, the JAX model's ``noise`` stream; :meth:`ConvNet.draw` makes them.
Weights start as flax initializes the JAX model (lecun-normal kernels,
zero biases, ``linear_kaiming_init`` attention weights).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm, SelfAttentionPooling, conv, dense, init_flax_like_,
    linear_kaiming_, to_2d_input)

# (output channels, kernel, padding, dilation, stride) of layer1..layer4,
# each a (frequency, time) pair
LAYERS = ((8, (5, 5), (1, 2), (1, 2), (2, 3)),
          (16, (5, 5), (1, 2), (1, 2), (2, 2)),
          (32, (5, 5), (1, 2), (1, 1), (2, 1)),
          (64, (3, 3), (1, 1), (1, 1), (1, 1)))
LEAKY = 0.1


def convnet_extent(feat_dim: int, frames: int) -> Tuple[int, int]:
    """(H, W): the frequency rows and time columns leaving layer 4 for
    ``feat_dim``-dim features of ``frames`` frames."""
    hw = [feat_dim, frames]
    for _c, k, pad, dil, stride in LAYERS:
        hw = [(n + 2 * p - d * (kk - 1) - 1) // s + 1
              for n, kk, p, d, s in zip(hw, k, pad, dil, stride)]
    return hw[0], hw[1]


class ConvNet(nn.Module):
    """``num_nodes`` is the frequency extent ``layer5`` collapses (with
    ``subband_attention``; 6 for 60-dim features); ``fc1`` is sized for
    ``feat_dim`` x ``feat_len`` inputs, or has ``flat`` inputs where given
    (a checkpoint's). Built on ``device`` (the GPU unless the caller asks
    for the CPU), initialized from ``generator`` (a CPU generator; torch's
    global one when None)."""

    def __init__(self, num_classes: int = 2, num_nodes: int = 512,
                 enc_dim: int = 2, subband_attention: bool = False,
                 feat_dim: int = 60, feat_len: int = 750,
                 flat: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.subband_attention = subband_attention
        cin = 1
        for i, (cout, k, pad, dil, stride) in enumerate(LAYERS):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                nn.Conv2d(cin, cout, k, stride, pad, dil, bias=False),
                BatchNorm(cout), nn.LeakyReLU(LEAKY)))
            cin = cout
        if subband_attention:
            self.layer5 = nn.Sequential(
                nn.Conv2d(cin, 128, (num_nodes, 3), padding=(0, 1),
                          bias=False),
                BatchNorm(128), nn.LeakyReLU(LEAKY))
            self.attention = SelfAttentionPooling(128)
            self.fc2 = nn.Linear(256, enc_dim)
        else:
            h, w = convnet_extent(feat_dim, feat_len)
            self.flat = flat or cin * h * w
            self.fc1 = nn.Linear(self.flat, 256)
            self.fc2 = nn.Linear(256, enc_dim)
            self.draw = None        # the train step's mark: nothing to draw
        self.fc3 = nn.Linear(enc_dim, num_classes)
        init_flax_like_(self, generator)
        if subband_attention:
            linear_kaiming_(self.attention.att_weights, generator)
        self.to(dev)

    def draw(self, batch: int, frames: int,
             generator: Optional[torch.Generator] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pooling noise of one train-mode forward of ``batch``
        utterances of ``frames`` frames (``subband_attention`` only):
        (batch, T', 128) standard-normal f32 draws on the model's device,
        written into ``out`` where given."""
        dev = self.fc3.weight.device
        shape = (batch, convnet_extent(1, frames)[1], 128)
        noise = torch.randn(shape, generator=generator, device=dev)
        return noise if out is None else out.copy_(noise)

    def forward(self, feats: torch.Tensor,
                draws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding, logits) of (B, T, F) features, in f32; in train mode
        with ``subband_attention`` the pooling noise is ``draws`` (drawn
        here from torch's generator when None)."""
        disable_tf32()
        x = to_2d_input(feats.float())
        blocks = [getattr(self, f"layer{i + 1}") for i in range(len(LAYERS))]
        if self.subband_attention:
            blocks.append(self.layer5)
        for block in blocks:
            x = block[1].bn_leaky_relu(conv(block[0], x, None), LEAKY)
        if self.subband_attention:
            x = x.squeeze(2).transpose(1, 2)            # (B, T', 128)
            if self.training and draws is None:
                draws = torch.randn_like(x)
            out = self.attention(x, draws if self.training else None)
        else:
            out = dense(self.fc1, x.reshape(x.shape[0], -1), None)
        out1 = dense(self.fc2, out, None)
        return out1, dense(self.fc3, out1, None)
