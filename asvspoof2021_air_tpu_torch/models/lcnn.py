"""Light CNN (LCNN) with max-feature-map activations, in eval and train
mode.

Counterpart of the JAX package's ``models/lcnn.py`` ``LCNN``, with the
reference's state_dict names (the JAX package's
``interop/torch_port.port_lcnn``): nine blocks ``conv{1..9}``, each an
``nn.Sequential`` whose index 0 is the convolution ("SAME", with bias) and
whose later indices hold the MFM, the 2x2 max-pool and the affine-free
BatchNorm where the block has them (BNs at ``conv2.2``, ``conv3.3``,
``conv4.2``, ``conv6.2``, ``conv7.2``, ``conv8.2``); then ``out`` =
[dropout 0.7, ``out.1`` dense to 160, MFM, ``out.3`` dense to ``enc_dim``]
and ``fc_mu``.

The forward takes (B, T, F) features, NCHW inside with H the frequency
axis, and returns (embedding, logits) in f32. The flatten before the head
is C-major (the reference's; the JAX model's NHWC flatten is C-minor, and
``interop/flax_weights`` permutes ``Dense_0``'s rows). The head needs
T = ``feat_len`` frames: it is sized for 32 x (F // 16) x (feat_len // 16)
inputs. The BNs run through ``ops/bn_relu_vjp.bn_train`` in train mode
with ``fused_bn`` (the default; the JAX model's flag, its BNs'
``recompute``), or through plain autograd without it. In train mode the
dropout keeps the inputs where the boolean ``draws`` (B, 32 x (F // 16) x
(feat_len // 16)) hold, scaled by 1 / 0.3, the JAX model's ``dropout``
stream; :meth:`LCNN.draw` makes them from a generator. ``dtype`` (None or
``torch.bfloat16``) is the compute dtype of the convs, the MFMs and the
pools, which the BNs return; the flatten and the head run in f32. Weights
start as flax initializes the JAX model (lecun-normal kernels, zero
biases).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm, MaxFeatureMap, conv, dense, init_flax_like_, to_2d_input)

# (output channels before the MFM, kernel, pool, norm) of conv1..conv9
BLOCKS = ((64, 5, True, False), (64, 1, False, True), (96, 3, True, True),
          (96, 1, False, True), (128, 3, True, False), (128, 1, False, True),
          (64, 3, False, True), (64, 1, False, True), (64, 3, True, False))


class LCNN(nn.Module):
    """``num_nodes`` is the frequency dim of the input (60 for LFCC); the
    head is sized for ``feat_len`` frames (750, as the reference). Built on
    ``device`` (the GPU unless the caller asks for the CPU), initialized
    from ``generator`` (a CPU generator; torch's global one when None)."""

    def __init__(self, num_nodes: int = 60, enc_dim: int = 256,
                 nclasses: int = 2, feat_len: int = 750,
                 dropout_rate: float = 0.7,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 fused_bn: bool = True):
        super().__init__()
        dev = resolve_device(device)
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        self.dtype, self.dropout_rate = dtype, dropout_rate
        cin = 1
        for i, (cout, k, pool, norm) in enumerate(BLOCKS):
            layers = [nn.Conv2d(cin, cout, k, padding=k // 2),
                      MaxFeatureMap()]
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            if norm:
                layers.append(BatchNorm(cout // 2, dtype=dtype,
                                        use_scale=False, use_bias=False,
                                        recompute=fused_bn))
            setattr(self, f"conv{i + 1}", nn.Sequential(*layers))
            cin = cout // 2
        self.flat = cin * (num_nodes // 16) * (feat_len // 16)
        self.out = nn.Sequential(nn.Dropout(dropout_rate),
                                 nn.Linear(self.flat, 160), MaxFeatureMap(),
                                 nn.Linear(80, enc_dim))
        self.fc_mu = nn.Linear(enc_dim, nclasses if nclasses >= 2 else 1)
        init_flax_like_(self, generator)
        self.to(dev)

    def draw(self, batch: int, frames: int = 0,
             generator: Optional[torch.Generator] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The dropout mask of one train-mode forward of ``batch``
        utterances: (batch, ``self.flat``) booleans on the model's device,
        True with probability 1 - rate (``frames`` is unused: the head fixes
        the shape), written into ``out`` where given."""
        dev = self.fc_mu.weight.device
        keep = torch.rand((batch, self.flat), generator=generator,
                          device=dev) < 1.0 - self.dropout_rate
        return keep if out is None else out.copy_(keep)

    def forward(self, feats: torch.Tensor,
                draws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding, logits) of (B, T, F) features; in train mode the
        dropout mask is ``draws`` (drawn here from torch's generator when
        None)."""
        dt = self.dtype
        if dt is None:
            disable_tf32()
        x = to_2d_input(feats)
        for i in range(len(BLOCKS)):
            block = getattr(self, f"conv{i + 1}")
            x = conv(block[0], x, dt)
            for layer in block[1:]:
                x = layer(x)
        feat = x.reshape(x.shape[0], -1).float()
        if self.training:
            if draws is None:
                draws = self.draw(feat.shape[0])
            keep = 1.0 - self.dropout_rate
            feat = torch.where(draws, feat / keep, torch.zeros_like(feat))
        _drop, fc1, mfm, fc2 = self.out
        feat = dense(fc2, mfm(dense(fc1, feat, None)), None)
        return feat, dense(self.fc_mu, feat, None)
