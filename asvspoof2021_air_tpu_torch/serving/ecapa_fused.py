"""Post-pooling head of the ECAPA serving graph.

Counterpart of the JAX package's ``serving/ecapa_fused.py`` ``_Head``:
BN -> embedding (``fc6``) -> logits (``fc7``) -> BN, in the compute type,
returning (embedding, logits) in f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from asvspoof2021_air_tpu_torch.models.common import BN_EPS

BN_FIELDS = ("running_mean", "running_var", "weight", "bias")


class Head(torch.nn.Module):
    """``bn5`` -> ``fc6`` -> ``fc7`` -> ``bn7`` on (B, 3072) pooled stats;
    its weights are buffers."""

    def __init__(self, sd: Dict[str, torch.Tensor], dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        for bn in ("bn5", "bn7"):
            for f in BN_FIELDS:
                self.register_buffer(f"{bn}_{f}", sd[f"{bn}.{f}"])
        self.register_buffer("w6", sd["fc6.weight"].t().to(dtype))
        self.register_buffer("b6", sd["fc6.bias"].to(dtype))
        self.register_buffer("w7", sd["fc7.weight"].t().to(dtype))
        self.register_buffer("b7", sd["fc7.bias"].to(dtype))

    def bn_affine(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Inference BatchNorm ``name`` over the last axis in f32, cast back
        to x's type: (x - mean) * (rsqrt(var + eps) * weight) + bias."""
        mean, var, weight, bias = (getattr(self, f"{name}_{f}")
                                   for f in BN_FIELDS)
        mul = torch.rsqrt(var + BN_EPS) * weight
        return ((x.float() - mean) * mul + bias).to(x.dtype)

    def forward(self, pooled: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.bn_affine("bn5", pooled.to(self.dtype))
        feat = x @ self.w6 + self.b6
        out = self.bn_affine("bn7", feat @ self.w7 + self.b7)
        return feat.float(), out.float()
