"""ECAPA serving forward with the fused CUDA kernels.

Counterpart of the JAX package's
``serving/ecapa_int8.ecapa_apply_int8(quantize=False, fused_chain=True)``,
the bf16 serving tier: in the compute type,

- the stem conv k=5, ReLU, inference BN;
- three Bottle2necks, each: 1x1 conv, ReLU, BN; the Res2 chain as kernel
  B2 (``ops/res2_chain_cuda.py``); 1x1 conv, ReLU, BN; the SE gate, whose
  mean over T counts only the first ``valid_len`` rows; the residual;
- the MFA as three products summed, + bias, ReLU;
- the attention pooling as kernel B3 (``ops/attn_pool_cuda.py``), in f32;
- the head (``serving/ecapa_fused.py``).

The stem, 1x1 and MFA products are plain large matrix products (XLA's in
JAX) and run as ``F.conv1d`` / ``torch.matmul``. The JAX graph pads T to a
multiple of 8 for the TPU's sublanes; the port runs at T as given.
``valid_len`` marks alignment padding when the caller has some: rows at
and past it are zeroed at the input and masked by every cross-time
statistic, so the result equals the unpadded forward.

The int8 tiers (``quantize=True`` and ``"mfa"``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import BN_EPS
from asvspoof2021_air_tpu_torch.ops.attn_pool_cuda import (
    attention_pooling, pack_pool_params)
from asvspoof2021_air_tpu_torch.ops.res2_chain_cuda import (
    pack_chain_params, res2_chain_infer)
from asvspoof2021_air_tpu_torch.serving.ecapa_fused import Head

DILATIONS = (2, 3, 4)


class ServingECAPA:
    """Weights laid out once for the serving graph; call with (B, T, F)
    features to get (embedding, logits) in f32."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], *,
                 dtype: torch.dtype = torch.bfloat16, model_scale: int = 8,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype, self.scale = dtype, model_scale
        sd = {k: v.to(self.device, torch.float32)
              for k, v in state_dict.items()}
        self.sd = sd
        self.affine = {}
        for name in ["bn1"] + [f"layer{i}.{n}" for i in (1, 2, 3)
                               for n in ("bn1", "bn3", "se.se.3")]:
            inv = sd[name + ".weight"] / torch.sqrt(
                sd[name + ".running_var"] + BN_EPS)
            self.affine[name] = (
                inv.to(dtype),
                (sd[name + ".bias"] - sd[name + ".running_mean"] * inv
                 ).to(dtype))
        self.stem_w = sd["conv1.weight"].to(dtype)
        self.stem_b = sd["conv1.bias"].to(dtype)
        pw = lambda n: sd[n + ".weight"][:, :, 0].t().contiguous().to(dtype)
        self.blocks = []
        for i, d in enumerate(DILATIONS):
            t = f"layer{i + 1}"
            # B2 takes its conv weights in the compute type, its bias and
            # BN affine in f32.
            w, cb, a, b = pack_chain_params(sd, t, model_scale)
            self.blocks.append(dict(
                name=t, dilation=d,
                w1=pw(t + ".conv1"), b1=sd[t + ".conv1.bias"].to(dtype),
                chain=(w.to(dtype), cb, a, b),
                w3=pw(t + ".conv3"), b3=sd[t + ".conv3.bias"].to(dtype),
                se_w1=pw(t + ".se.se.1"),
                se_b1=sd[t + ".se.se.1.bias"].to(dtype),
                se_w4=pw(t + ".se.se.4"),
                se_b4=sd[t + ".se.se.4.bias"].to(dtype)))
        self.mfa_w = pw("layer4")
        self.mfa_b = sd["layer4.bias"].to(dtype)
        self.pool = pack_pool_params(sd)
        self.head = Head(sd, dtype)

    def _bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        a, b = self.affine[name]
        return x * a + b

    def _block(self, blk, x: torch.Tensor, t_sem: int) -> torch.Tensor:
        t = blk["name"]
        out = self._bn(t + ".bn1", torch.relu(x @ blk["w1"] + blk["b1"]))
        out = res2_chain_infer(out, *blk["chain"], dilation=blk["dilation"],
                               scale=self.scale, valid_len=t_sem)
        out = self._bn(t + ".bn3", torch.relu(out @ blk["w3"] + blk["b3"]))
        y = out[:, :t_sem].sum(dim=1) / t_sem
        y = self._bn(t + ".se.se.3", torch.relu(y @ blk["se_w1"]
                                                 + blk["se_b1"]))
        y = torch.sigmoid(y @ blk["se_w4"] + blk["se_b4"])
        return out * y[:, None, :] + x

    def __call__(self, feats: torch.Tensor, valid_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.dtype == torch.float32:
            disable_tf32()
        x = feats.to(self.device, self.dtype)
        T = x.shape[1]
        t_sem = T if valid_len is None else int(valid_len)
        if t_sem != T:
            keep = torch.arange(T, device=self.device) < t_sem
            x = x * keep[None, :, None].to(self.dtype)
        x = F.conv1d(x.transpose(1, 2), self.stem_w, padding=2).transpose(1, 2)
        x = self._bn("bn1", torch.relu(x + self.stem_b)).contiguous()
        xs = []
        for blk in self.blocks:
            x = self._block(blk, x, t_sem)
            xs.append(x)
        C = x.shape[-1]
        acc = None
        for i, xi in enumerate(xs):
            term = xi @ self.mfa_w[i * C:(i + 1) * C]
            acc = term if acc is None else acc + term
        x = torch.relu(acc + self.mfa_b)
        pooled = attention_pooling(x, self.pool, valid_len=t_sem)
        return self.head(pooled)


def ecapa_apply_serving(state_dict: Dict[str, torch.Tensor],
                        feats: torch.Tensor, *,
                        dtype: torch.dtype = torch.bfloat16,
                        valid_len: Optional[int] = None, model_scale: int = 8,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(embedding, logits) for ECAPA inference through the fused kernels,
    from the port's ECAPA state_dict. For repeated calls build
    :class:`ServingECAPA` once."""
    model = ServingECAPA(state_dict, dtype=dtype, model_scale=model_scale,
                         device=device)
    return model(feats, valid_len=valid_len)
