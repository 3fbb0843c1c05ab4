"""Fused context attentive-statistics pooling: kernel B3
(``csrc/attn_pool.cu``) and its plain version.

Counterpart of the JAX package's ``ops/attn_pool_pallas.py``
(``_kernel`` via ``fused_attention_pooling``): per utterance, masked mean
and std over T, the context bias mean @ Wm + std @ Ws, the hidden
relu(x @ Wx + const + ba) with the folded BatchNorm, logits = h @ Wb + bb,
a softmax over T per channel, and the attentive [mu || sigma] in f32.
Frames at and past ``valid_len`` are excluded from every statistic.

On a CUDA tensor :func:`attention_pooling` launches the kernel; on a CPU
tensor it runs :func:`attention_pooling_plain` (both through the custom op
``asv_torch::attention_pooling`` of ``ops/custom_ops.py``, which
``torch.export`` keeps in an exported graph), which follows the kernel's
formulas (variance as (E[x^2] - m^2) * n / (n - 1)). The kernel runs both
products on the tensor cores; for bf16 x it takes Wx as bf16 planes
(:func:`split_bf16`), split once when the weights are packed.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from asvspoof2021_air_tpu_torch.models.common import BN_EPS
from asvspoof2021_air_tpu_torch.ops import _build
from asvspoof2021_air_tpu_torch.utils import profiling

HIDDEN = 128
WX_PLANES = 2              # bf16 planes of Wx that the kernel takes for bf16 x


class PoolParams(NamedTuple):
    """The attention's weights split as the kernel takes them (f32): wx, wm,
    ws (D, 128) act on x, mean and std; ba (128,); s, bias (128,) the folded
    BatchNorm; wb (128, D), bb (D,). wx_planes (WX_PLANES, D, 128) bf16 is
    wx split by :func:`split_bf16`, which the kernel needs for bf16 x."""
    wx: torch.Tensor
    wm: torch.Tensor
    ws: torch.Tensor
    ba: torch.Tensor
    s: torch.Tensor
    bias: torch.Tensor
    wb: torch.Tensor
    bb: torch.Tensor
    wx_planes: Optional[torch.Tensor] = None


def split_bf16(w: torch.Tensor, planes: int = WX_PLANES) -> torch.Tensor:
    """(planes, *w.shape) bf16: hi = bf16(w), then each plane the bf16 of
    what the planes before it leave of w (each remainder is exact in f32).
    Their sum holds w to 2^-17 |w| with two planes and exactly with three;
    one keeps 2^-8."""
    out, rest = [], w.float()
    for _ in range(planes):
        out.append(rest.bfloat16())
        rest = rest - out[-1].float()
    return torch.stack(out)


def pack_pool_params(sd: Dict[str, torch.Tensor],
                     prefix: str = "attention") -> PoolParams:
    """PoolParams from the port's state_dict: ``attention.0`` (the context
    conv over [x | mean | std]), ``attention.2`` (BatchNorm) and
    ``attention.3`` (the 128 -> D conv)."""
    wa = sd[f"{prefix}.0.weight"][:, :, 0].t().float()    # (3 D, 128)
    D = wa.shape[0] // 3
    s = sd[f"{prefix}.2.weight"] * torch.rsqrt(
        sd[f"{prefix}.2.running_var"] + BN_EPS)
    bias = sd[f"{prefix}.2.bias"] - sd[f"{prefix}.2.running_mean"] * s
    wb = sd[f"{prefix}.3.weight"][:, :, 0].t()             # (128, D)
    c = lambda t: t.float().contiguous()
    wx = c(wa[:D])
    return PoolParams(wx, c(wa[D:2 * D]), c(wa[2 * D:]),
                      c(sd[f"{prefix}.0.bias"]), c(s), c(bias), c(wb),
                      c(sd[f"{prefix}.3.bias"]), split_bf16(wx))


def attention_pooling_plain(x: torch.Tensor, p: PoolParams,
                            valid_len: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in PyTorch: x (B, T, D) -> (B, 2 D) f32."""
    xf = x.float()
    T = xf.shape[1]
    n = T if valid_len is None else valid_len
    valid = (torch.arange(T, device=x.device) < n).float()[None, :, None]
    xv = xf * valid
    mean = xv.sum(1) / n
    ex2 = (xv * xv).sum(1) / n
    var = (ex2 - mean * mean) * (n / (n - 1.0))
    std = torch.sqrt(torch.clamp(var, min=1e-4))
    const = mean @ p.wm + std @ p.ws                          # (B, 128)
    a = torch.relu(xf @ p.wx + const[:, None, :] + p.ba)
    a = a * p.s + p.bias
    logits = a @ p.wb + p.bb
    logits = torch.where(valid > 0, logits, torch.full((), -1e30,
                                                        device=x.device))
    m = logits.amax(dim=1, keepdim=True)
    e = torch.exp(logits - m) * valid
    w = e / e.sum(dim=1, keepdim=True)
    mu = (xv * w).sum(1)
    sg = torch.sqrt(torch.clamp((xv * xv * w).sum(1) - mu * mu, min=1e-4))
    return torch.cat([mu, sg], dim=-1)


def attention_pooling_kernel(x: torch.Tensor, p: PoolParams,
                             valid_len: Optional[int] = None) -> torch.Tensor:
    """Launch B3 on CUDA tensors (three passes, one call)."""
    name = "attention_pooling_kernel"
    if x.dim() != 3 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: x must be (B, T, D) of "
                         f"{sorted(map(str, _build.DTYPE_CODES))}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, T, D = x.shape
    if D % 128:
        raise ValueError(f"{name}: D must be a multiple of 128")
    n = T if valid_len is None else int(valid_len)
    if not 2 <= n <= T:
        raise ValueError(f"{name}: valid_len {n} not in [2, {T}]")
    H = HIDDEN
    x = x.contiguous()
    w = PoolParams(*(t.float().contiguous() for t in p[:8]))
    planes = None
    if x.dtype == torch.bfloat16:
        planes = p.wx_planes
        if (planes is None or planes.dtype != torch.bfloat16
                or tuple(planes.shape) != (WX_PLANES, D, H)):
            raise ValueError(
                f"{name}: bf16 x needs wx_planes, Wx as ({WX_PLANES}, {D}, "
                f"{H}) bf16 planes split once (pack_pool_params, split_bf16)")
    pairs = [(x, None), (w.wx, (D, H)), (w.wm, (D, H)), (w.ws, (D, H)),
             (w.ba, (H,)), (w.s, (H,)), (w.bias, (H,)), (w.wb, (H, D)),
             (w.bb, (D,))]
    if planes is not None:
        pairs.append((planes, (WX_PLANES, D, H)))
    if any(t.data_ptr() % 16 for t, _ in pairs):
        raise ValueError(f"{name}: x and every weight must start on a 16-byte "
                         f"boundary (the kernel copies with 16-byte cp.async)")
    _build.check_args(name, *pairs)
    f32 = dict(device=x.device, dtype=torch.float32)
    work = torch.empty(_build.library().attn_pool_workspace(B, T, D, n), **f32)
    out = torch.empty((B, 2 * D), **f32)
    planes_ptr = None if planes is None else planes.data_ptr()
    _build.launch("attn_pool_forward", x.device, x.data_ptr(), B, T, D, n,
                  w.wx.data_ptr(), planes_ptr, WX_PLANES,
                  *(t.data_ptr() for t in w[1:8]), work.data_ptr(),
                  out.data_ptr(), _build.DTYPE_CODES[x.dtype])
    profiling.count("B3")
    return out


def attention_pooling(x: torch.Tensor, p: PoolParams,
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """B3 on CUDA tensors, its plain version on CPU tensors (the custom op
    ``asv_torch::attention_pooling``)."""
    from asvspoof2021_air_tpu_torch.ops import custom_ops

    return custom_ops.attention_pooling(x, *p, valid_len)
