"""Subband ensemble: the frequency axis split into bands, an LCNN per band,
the band embeddings returned as a list.

Counterpart of the JAX package's ``models/subband.py`` ``Subband`` with the
reference's state_dict names (the JAX package's
``interop/torch_port.port_subband``): the band LCNNs are ``sub1`` ..
``sub{subband_num}``, each over ``num_nodes // subband_num`` frequency
rows with its head sized for ``feat_len`` frames; the first band's
embedding takes the remainder of ``enc_dim``. The model registry does not
list it, as the JAX registry does not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.models.lcnn import LCNN


class Subband(nn.Module):
    """Built on ``device`` (the GPU unless the caller asks for the CPU),
    initialized from ``generator``."""

    def __init__(self, num_nodes: int = 60, enc_dim: int = 256,
                 num_classes: int = 2, subband_num: int = 4,
                 feat_len: int = 750,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.band, self.subband_num = num_nodes // subband_num, subband_num
        for i in range(subband_num):
            enc = enc_dim // subband_num
            if i == 0:
                enc += enc_dim % subband_num
            setattr(self, f"sub{i + 1}", LCNN(
                num_nodes=self.band, enc_dim=enc, nclasses=num_classes,
                feat_len=feat_len, generator=generator, device=dev))

    def forward(self, feats: torch.Tensor,
                draws: Optional[Sequence[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """The band embeddings of (B, T, F) features; in train mode band
        i's dropout mask is ``draws[i]`` (``LCNN.draw`` of ``sub{i+1}``;
        drawn from torch's generator when None)."""
        out = []
        for i in range(self.subband_num):
            sub = feats[..., i * self.band:(i + 1) * self.band]
            emb, _logits = getattr(self, f"sub{i + 1}")(
                sub, None if draws is None else draws[i])
            out.append(emb)
        return out
