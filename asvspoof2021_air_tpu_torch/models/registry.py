"""The model registry: the ``-m/--model`` name -> the model.

Counterpart of the JAX package's ``models/registry.py`` for the families
the port holds: ``ecapa`` (ECAPA-TDNN, its width ``C`` and ``model_scale``
being the port's own knobs, 512 and 8 in the JAX package; ``fused_pool``
pools through kernels B4a/B4b), ``resnet`` (ResNet18, ``num_nodes`` 3 for
60-dim features) and ``lcnn`` (its head sized for ``feat_len``). ``cnn``,
``res2net`` and ``rawnet`` raise NotImplementedError: they are ROADMAP
Queue A's next families.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.models.lcnn import LCNN
from asvspoof2021_air_tpu_torch.models.resnet import ResNet

NOT_PORTED = ("cnn", "res2net", "rawnet")


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


MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "resnet": _build_resnet,
    "lcnn": _build_lcnn,
    "ecapa": _build_ecapa,
}


def build_model(name: str, **kwargs: Any) -> nn.Module:
    """Build a model by CLI name (ecapa|resnet|lcnn)."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue A, the model "
            "families item)")
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model '{name}'; choices: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
