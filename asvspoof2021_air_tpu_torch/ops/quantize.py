"""Int8 quantization: weights-only for serving export, and the int8
products of the int8 serving tiers.

:func:`quantize_state_dict_int8`, :func:`dequantize_state_dict` and
:func:`quantized_bytes` are the counterparts of the JAX package's
``ops/quantize.py`` (``quantize_tree_int8``, ``dequantize_tree``,
``quantized_bytes``) over the port's state_dicts. The scheme is JAX's: symmetric int8 with one scale
per output channel,

    s = max |w over the channel| / 127  (1 where that max is 0),
    q = clip(round(w / s), -127, 127),

in f32, rounding half to even, for every floating entry with ndim >= 2
and at least 1024 elements; the others (biases, BN statistics) stay f32.
JAX's flax kernels keep the output channel last ((K, I, O) convs, (I, O)
dense layers), so its scale runs over the last axis; the port's weights
keep it first ((O, I, K), (O, I)), so here the scale runs over dim 0 and
the maximum over every other dim. After the interop map
(``interop/flax_weights.from_flax_variables``) the codes and scales are
JAX's, bit for bit, and :func:`quantized_bytes` gives JAX's two numbers.

:func:`quant_w` and :func:`qdot` are the JAX ``serving/ecapa_int8``'s
``_quant_w`` and ``_qdot``, the int8 x int8 -> int32 products of
``serving/ecapa_serving.ServingECAPA``'s quantized tiers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MIN_ELEMENTS = 1024


def _eligible(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.dim() >= 2 and t.numel() >= MIN_ELEMENTS


def quantize_state_dict_int8(state_dict: Dict[str, torch.Tensor]
                             ) -> Dict[str, tuple]:
    """``{name: ("q", int8 codes, f32 scale (O, 1, ...)) | ("f", f32)}`` in
    the state_dict's order, on the state_dict's devices."""
    out = {}
    for name, t in state_dict.items():
        w = t.detach().float()
        if _eligible(t):
            s = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True) / 127.0
            s = torch.where(s == 0, torch.ones_like(s), s)
            q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
            out[name] = ("q", q, s)
        else:
            out[name] = ("f", w)
    return out


def dequantize_state_dict(qsd: Dict[str, tuple],
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """The state_dict back in ``dtype``: q * s for each quantized entry."""
    out = {}
    for name, rec in qsd.items():
        if rec[0] == "q":
            out[name] = rec[1].to(dtype) * rec[2].to(dtype)
        else:
            out[name] = rec[1].to(dtype)
    return out


def quantized_bytes(qsd: Dict[str, tuple]) -> Tuple[int, int]:
    """(bytes with int8 weights and f32 scales, bytes at full f32)."""
    qb = fb = 0
    for rec in qsd.values():
        n = rec[1].numel()
        qb += n + rec[2].numel() * 4 if rec[0] == "q" else n * 4
        fb += n * 4
    return qb, fb



def quant_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weights for :func:`qdot`: w (K, N)
    float -> (int8 (K, N), f32 scale (N,)), scale = max(max |w[:, n]|,
    1e-12) / 127 (the JAX ``serving/ecapa_int8._quant_w``)."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s


def qdot(x: torch.Tensor, w8: torch.Tensor, ws: torch.Tensor,
         dtype: torch.dtype, act_scale=None) -> torch.Tensor:
    """x (..., K) float @ int8 weights w8 (K, N) with scales ws (N,) ->
    (..., N) in ``dtype``, accumulated in int32 (``torch._int_mm``: cuBLASLt
    on the card, which wants the rows of x more than 16 and K and N
    multiples of 8). In the JAX ``_qdot``'s order: the activation scale in
    f32 from x in f32, per tensor and dynamic (``amax`` on the device) or
    the static ``act_scale``; codes clip(round(x / s), -127, 127); then the
    int32 sum cast to ``dtype`` times (s * ws) cast to ``dtype``, which in
    bf16 rounds where JAX does."""
    xf = x.float()
    if act_scale is None:
        s = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    else:
        s = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    x8 = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    acc = torch._int_mm(x8.reshape(-1, x8.shape[-1]), w8)
    acc = acc.reshape(*x.shape[:-1], w8.shape[1])
    return acc.to(dtype) * (s * ws).to(dtype)
