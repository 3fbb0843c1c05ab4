"""The model registry: the ``-m/--model`` name -> the model.

Counterpart of the JAX package's ``models/registry.py``, all six names:
``ecapa`` (ECAPA-TDNN, its width ``C`` and ``model_scale`` being the
port's own knobs, 512 and 8 in the JAX package; ``fused_pool`` pools
through kernels B4a/B4b), ``resnet`` (ResNet18, ``num_nodes`` 3 for 60-dim
features), ``lcnn`` (its head sized for ``feat_len``), ``res2net``
(SE-Res2Net50), ``cnn`` (ConvNet, ``fc1`` sized for ``feat_dim`` x
``feat_len``) and ``rawnet`` (RawNet2 at ``rawnet_args``, the default
arguments when None). As in the JAX registry, ``res2net``, ``cnn`` and
``rawnet`` drop ``dtype`` (they compute in f32 under any compute dtype)
and ``rawnet`` its ``nclasses`` (``rawnet_args["nb_classes"]`` holds).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from asvspoof2021_air_tpu_torch.models.convnet import ConvNet
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.models.lcnn import LCNN
from asvspoof2021_air_tpu_torch.models.rawnet import RawNet
from asvspoof2021_air_tpu_torch.models.res2net import SERes2Net50
from asvspoof2021_air_tpu_torch.models.resnet import ResNet


def resnet_nodes(feat_dim: int) -> int:
    """The frequency extent entering ResNet's conv5 for ``feat_dim``-dim
    features (the JAX registry's rule)."""
    return {60: 3}.get(feat_dim, max(feat_dim // 20, 1))


def _build_resnet(enc_dim: int = 256, nclasses: int = 2, feat_dim: int = 60,
                  dtype: Optional[torch.dtype] = None, generator=None,
                  device="cuda", **kw) -> nn.Module:
    return ResNet(num_nodes=resnet_nodes(feat_dim), enc_dim=enc_dim,
                  resnet_type="18", nclasses=nclasses, dtype=dtype,
                  generator=generator, device=device)


def _build_lcnn(enc_dim: int = 256, nclasses: int = 2, feat_dim: int = 60,
                feat_len: int = 750, dtype: Optional[torch.dtype] = None,
                generator=None, device="cuda", **kw) -> nn.Module:
    return LCNN(num_nodes=feat_dim, enc_dim=enc_dim, nclasses=nclasses,
                feat_len=feat_len, dtype=dtype, generator=generator,
                device=device)


def _build_ecapa(enc_dim: int = 256, nclasses: int = 2, feat_dim: int = 60,
                 dtype: Optional[torch.dtype] = None, generator=None,
                 device="cuda", C: int = 512, model_scale: int = 8,
                 fused_pool: bool = True, **kw) -> nn.Module:
    return ECAPA_TDNN(C=C, model_scale=model_scale, n_out=nclasses,
                      n_feat=feat_dim, enc_dim=enc_dim, fused_pool=fused_pool,
                      generator=generator, device=device, dtype=dtype)


def _build_res2net(nclasses: int = 2, generator=None, device="cuda",
                   **kw) -> nn.Module:
    return SERes2Net50(num_classes=nclasses, generator=generator,
                       device=device)


def _build_cnn(enc_dim: int = 256, nclasses: int = 2, feat_dim: int = 60,
               feat_len: int = 750, generator=None, device="cuda",
               **kw) -> nn.Module:
    return ConvNet(num_classes=nclasses, enc_dim=enc_dim, feat_dim=feat_dim,
                   feat_len=feat_len, generator=generator, device=device)


def _build_rawnet(rawnet_args: Optional[dict] = None, generator=None,
                  device="cuda", **kw) -> nn.Module:
    return RawNet(d_args=rawnet_args, generator=generator, device=device)


MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "cnn": _build_cnn,
    "resnet": _build_resnet,
    "lcnn": _build_lcnn,
    "res2net": _build_res2net,
    "ecapa": _build_ecapa,
    "rawnet": _build_rawnet,
}


def build_model(name: str, **kwargs: Any) -> nn.Module:
    """Build a model by CLI name (cnn|resnet|lcnn|res2net|ecapa|rawnet)."""
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model '{name}'; choices: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
