"""The int8 serving tiers of ECAPA and their calibration.

Counterpart of the JAX package's ``serving/ecapa_int8.py``:
:func:`ecapa_apply_int8` (``quantize`` True, "mfa" or False, dynamic or
static ``act_scales``, ``observer``, ``fused_chain``),
:func:`calibrate_act_scales`, and the int8 products :func:`quant_w` and
:func:`qdot` (``ops/quantize.py``; JAX's ``_quant_w`` and ``_qdot``). The
graph is :class:`~asvspoof2021_air_tpu_torch.serving.ecapa_serving.
ServingECAPA` with ``quantize=`` and ``act_scales=``; its int8 weights
are packed once, where JAX quantizes them inside its jitted graph (the
same codes).

The Res2 chain always runs as kernel B2 on the card (its plain version on
the CPU): B2 computes the function of JAX's ``lax`` chain too. So
``fused_chain`` decides only what JAX's flag does to the shapes: with it,
T is padded with zero frames to a multiple of 8 and the graph runs with
``valid_len`` = T, so each dynamic activation scale reads the padded rows
as JAX's does (they hold values after the stem's bias).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from asvspoof2021_air_tpu_torch.ops.quantize import qdot, quant_w
from asvspoof2021_air_tpu_torch.serving.ecapa_serving import (
    SITES, ServingECAPA)

__all__ = ["SITES", "calibrate_act_scales", "ecapa_apply_int8",
           "pad_time", "qdot", "quant_w"]


def pad_time(feats: torch.Tensor, multiple: int = 8
             ) -> Tuple[torch.Tensor, Optional[int]]:
    """(feats padded with zero frames to a multiple of ``multiple`` along
    T, the original T or None when no padding was needed): the fused-chain
    alignment of the JAX ``ecapa_apply_int8``."""
    T = feats.shape[1]
    t_phys = -(-T // multiple) * multiple
    if t_phys == T:
        return feats, None
    return torch.nn.functional.pad(feats, (0, 0, 0, t_phys - T)), T


def ecapa_apply_int8(state_dict: Dict[str, torch.Tensor], feats, *,
                     model_scale: int = 8,
                     dtype: torch.dtype = torch.bfloat16,
                     act_scales: Optional[Dict[str, float]] = None,
                     observer: Optional[Callable] = None,
                     fused_chain: bool = False, quantize=True,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(embedding, logits) in f32 of ECAPA with the int8 tier ``quantize``
    (True: the 1x1 convs and the MFA; "mfa": the MFA only; False: none),
    from the port's ECAPA state_dict. ``act_scales`` from
    :func:`calibrate_act_scales` replace the dynamic per-tensor scales;
    ``observer(site, activation)`` sees each site's input (the 1x1 sites
    only when ``quantize is True``, the MFA's always). For repeated calls
    build ``ServingECAPA(..., quantize=, act_scales=)`` once and pad with
    :func:`pad_time`."""
    model = ServingECAPA(state_dict, dtype=dtype, model_scale=model_scale,
                         quantize=quantize, act_scales=act_scales,
                         device=device)
    x = torch.as_tensor(feats).to(model.device)
    valid_len = None
    if fused_chain:
        x, valid_len = pad_time(x)
    return model(x, valid_len=valid_len, observer=observer)


def calibrate_act_scales(state_dict: Dict[str, torch.Tensor],
                         feats_batches: Iterable, *, model_scale: int = 8,
                         dtype: torch.dtype = torch.float32,
                         headroom: float = 1.0,
                         device="cuda") -> Dict[str, float]:
    """Static per-site activation scales for the int8 tiers: the dynamic
    int8 forward (``quantize=True``, no padding, as JAX calibrates) over
    ``feats_batches``, recording max |activation| at every site;
    returns {site: max(max_abs, 1e-12) * headroom / 127} for the nine
    :data:`SITES`. Activations past the calibrated range saturate at
    +-127 (headroom > 1 leaves slack)."""
    model = ServingECAPA(state_dict, dtype=dtype, model_scale=model_scale,
                         quantize=True, device=device)
    maxima: Dict[str, float] = {}

    def observer(site, v):
        m = float(v.float().abs().amax())
        maxima[site] = max(maxima.get(site, 0.0), m)

    with torch.no_grad():
        for feats in feats_batches:
            model(torch.as_tensor(feats).to(model.device), observer=observer)
    return {site: max(m, 1e-12) * headroom / 127.0
            for site, m in maxima.items()}
