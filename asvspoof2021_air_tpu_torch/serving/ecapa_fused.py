"""Post-pooling head of the ECAPA serving graph.

Counterpart of the JAX package's ``serving/ecapa_fused.py`` ``_Head``:
BN -> embedding (``fc6``) -> logits (``fc7``) -> BN, in the compute type,
returning (embedding, logits) in f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from asvspoof2021_air_tpu_torch.models.common import BN_EPS


def bn_affine(sd: Dict[str, torch.Tensor], name: str, x: torch.Tensor
              ) -> torch.Tensor:
    """Inference BatchNorm over the last axis in f32, cast back to x's type:
    (x - mean) * (rsqrt(var + eps) * weight) + bias."""
    mul = torch.rsqrt(sd[name + ".running_var"] + BN_EPS) * sd[name + ".weight"]
    y = (x.float() - sd[name + ".running_mean"]) * mul + sd[name + ".bias"]
    return y.to(x.dtype)


class Head:
    """``bn5`` -> ``fc6`` -> ``fc7`` -> ``bn7`` on (B, 3072) pooled stats."""

    def __init__(self, sd: Dict[str, torch.Tensor], dtype: torch.dtype):
        self.sd, self.dtype = sd, dtype
        self.w6 = sd["fc6.weight"].t().to(dtype)
        self.b6 = sd["fc6.bias"].to(dtype)
        self.w7 = sd["fc7.weight"].t().to(dtype)
        self.b7 = sd["fc7.bias"].to(dtype)

    def __call__(self, pooled: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = bn_affine(self.sd, "bn5", pooled.to(self.dtype))
        feat = x @ self.w6 + self.b6
        out = bn_affine(self.sd, "bn7", feat @ self.w7 + self.b7)
        return feat.float(), out.float()
