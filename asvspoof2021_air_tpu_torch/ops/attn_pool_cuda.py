"""Fused context attentive-statistics pooling: kernel B3
(``csrc/attn_pool.cu``) and its plain version.

Counterpart of the JAX package's ``ops/attn_pool_pallas.py``
(``_kernel`` via ``fused_attention_pooling``): per utterance, masked mean
and std over T, the context bias mean @ Wm + std @ Ws, the hidden
relu(x @ Wx + const + ba) with the folded BatchNorm, logits = h @ Wb + bb,
a softmax over T per channel, and the attentive [mu || sigma] in f32.
Frames at and past ``valid_len`` are excluded from every statistic.

On a CUDA tensor :func:`attention_pooling` launches the kernel; on a CPU
tensor it runs :func:`attention_pooling_plain`, which follows the kernel's
formulas (variance as (E[x^2] - m^2) * n / (n - 1)).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from asvspoof2021_air_tpu_torch.models.common import BN_EPS
from asvspoof2021_air_tpu_torch.ops import _build

HIDDEN = 128

launches = 0               # kernel launches since the last reset


class PoolParams(NamedTuple):
    """The attention's weights split as the kernel takes them (all f32):
    wx, wm, ws (D, 128) act on x, mean and std; ba (128,); s, bias (128,)
    the folded BatchNorm; wb (128, D), bb (D,)."""
    wx: torch.Tensor
    wm: torch.Tensor
    ws: torch.Tensor
    ba: torch.Tensor
    s: torch.Tensor
    bias: torch.Tensor
    wb: torch.Tensor
    bb: torch.Tensor


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
    return PoolParams(c(wa[:D]), c(wa[D:2 * D]), c(wa[2 * D:]),
                      c(sd[f"{prefix}.0.bias"]), c(s), c(bias), c(wb),
                      c(sd[f"{prefix}.3.bias"]))


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
    """Launch B3 on CUDA tensors (four passes, one call)."""
    global launches
    B, T, D = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"attention_pooling_kernel: unsupported dtype "
                         f"{x.dtype}")
    if D % 128:
        raise ValueError("attention_pooling_kernel: D must be a multiple of "
                         "128")
    n = T if valid_len is None else int(valid_len)
    if not 2 <= n <= T:
        raise ValueError(f"attention_pooling_kernel: valid_len {n} not in "
                         f"[2, {T}]")
    x = x.contiguous()
    p = PoolParams(*(t.float().contiguous() for t in p))
    H = HIDDEN
    _build.check_args("attention_pooling_kernel", (x, None), (p.wx, (D, H)),
                      (p.wm, (D, H)), (p.ws, (D, H)), (p.ba, (H,)),
                      (p.s, (H,)), (p.bias, (H,)), (p.wb, (H, D)),
                      (p.bb, (D,)))
    f32 = dict(device=x.device, dtype=torch.float32)
    mean, std = torch.empty((B, D), **f32), torch.empty((B, D), **f32)
    const = torch.empty((B, HIDDEN), **f32)
    hidden = torch.empty((B, T, HIDDEN), **f32)
    out = torch.empty((B, 2 * D), **f32)
    _build.launch("attn_pool_forward", x.device, x.data_ptr(), B, T, D, n,
                  *(t.data_ptr() for t in p), mean.data_ptr(),
                  std.data_ptr(), const.data_ptr(), hidden.data_ptr(),
                  out.data_ptr(), _build.DTYPE_CODES[x.dtype])
    launches += 1
    return out


def attention_pooling(x: torch.Tensor, p: PoolParams,
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """B3 on CUDA tensors, its plain version on CPU tensors."""
    fn = attention_pooling_kernel if x.is_cuda else attention_pooling_plain
    return fn(x, p, valid_len)
