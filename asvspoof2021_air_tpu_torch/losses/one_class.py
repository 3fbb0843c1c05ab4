"""One-class softmax (OC-Softmax) loss and score.

Counterpart of the JAX package's ``losses/one_class.py`` ``OCSoftmax`` and
its alias ``AngularIsoLoss``: cosine similarity of the L2-normalized
embedding to a learned, L2-normalized center; loss = mean softplus(alpha *
margin) with margin r_real - cos for bona fide (label 0) and cos - r_fake
for spoof (label 1). ``forward`` returns (loss, -cos), the negated cosine
score, as the reference does. The center lives on ``device`` (the GPU
unless the caller asks for the CPU); ``generator`` is a CPU generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import resolve_device


class OCSoftmax(nn.Module):
    def __init__(self, feat_dim: int = 2, r_real: float = 0.9,
                 r_fake: float = 0.5, alpha: float = 20.0,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.r_real, self.r_fake, self.alpha = r_real, r_fake, alpha
        # variance_scaling(2 / (1 + 0.25^2), fan_in, uniform) on a (1, D)
        # parameter: fan_in = 1, bound = sqrt(3 * scale).
        bound = math.sqrt(3.0 * 2.0 / (1.0 + 0.25 ** 2))
        self.center = nn.Parameter(
            ((torch.rand((1, feat_dim), generator=generator) * 2.0 - 1.0)
             * bound).to(dev))

    def forward(self, x: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = F.normalize(self.center, p=2, dim=1)
        xn = F.normalize(x, p=2, dim=1)
        scores = (xn @ w.t())[:, 0]
        margins = torch.where(labels == 0, self.r_real - scores,
                              scores - self.r_fake)
        loss = F.softplus(self.alpha * margins).mean()
        return loss, -scores


AngularIsoLoss = OCSoftmax
