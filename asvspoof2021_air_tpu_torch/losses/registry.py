"""The add-loss registry: the ``--add_loss`` name -> the loss module.

Counterpart of the JAX package's ``losses/registry.py``: ``ang_iso`` and
its alias ``ocsoftmax`` build OC-Softmax, ``isolate`` and ``iso_sq`` the
Isolate losses (radii ``r_real``, ``r_fake``), ``p2sgrad`` P2SGrad without
label smoothing, ``amsoftmax`` the AMSoftmax head; None (or "None") is
plain CE training. The module's parameters are drawn from ``generator``
and live on ``device``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from asvspoof2021_air_tpu_torch.losses.one_class import (
    AMSoftmax, AngularIsoLoss, IsolateLoss, IsolateSquareLoss, P2SGradLoss)


def build_loss(name: Optional[str], enc_dim: int = 256, r_real: float = 0.9,
               r_fake: float = 0.2, alpha: float = 20.0, nclasses: int = 2,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> Optional[nn.Module]:
    """The add-loss module named ``name``; None for plain CE training."""
    if name is None or name == "None":
        return None
    kw = dict(generator=generator, device=device)
    if name in ("ang_iso", "ocsoftmax"):
        return AngularIsoLoss(feat_dim=enc_dim, r_real=r_real, r_fake=r_fake,
                              alpha=alpha, **kw)
    if name == "isolate":
        return IsolateLoss(feat_dim=enc_dim, r_real=r_real, r_fake=r_fake,
                           **kw)
    if name == "iso_sq":
        return IsolateSquareLoss(feat_dim=enc_dim, r_real=r_real,
                                 r_fake=r_fake, **kw)
    if name == "p2sgrad":
        return P2SGradLoss(in_dim=enc_dim, out_dim=nclasses, smooth=0.0,
                           **kw)
    if name == "amsoftmax":
        return AMSoftmax(num_classes=nclasses, enc_dim=enc_dim, **kw)
    raise ValueError(f"unknown add_loss '{name}'")


LOSS_REGISTRY: Dict[str, Callable[..., Any]] = {
    name: (lambda name=name, **kw: build_loss(name, **kw))
    for name in ("ang_iso", "ocsoftmax", "isolate", "iso_sq", "p2sgrad",
                 "amsoftmax")
}
