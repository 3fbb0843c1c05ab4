"""Fused inference Res2 chain: kernel B2 (``csrc/res2_chain.cu``) and its
plain version.

Counterpart of the JAX package's ``ops/res2_chain_pallas.py``
(``_chain_kernel`` via ``res2_chain_infer``): the seven sequential
width-64 dilated k=3 convs of one Bottle2neck, each followed by ReLU and the
folded inference BatchNorm, with the last group passed through. Rows at and
past ``valid_len`` read as zeros before every conv and are zero in the
output. The I/O type follows ``x`` (bf16 or f32); accumulation and the BN
affine are f32. The kernel runs the convs on the tensor cores
(``mma.sync``): in bf16 as they are, in f32 in 3xTF32 (each operand split
into two TF32 parts, three products), which keeps f32's accuracy.

On a CUDA tensor :func:`res2_chain_infer` launches the kernel; on a CPU
tensor it runs :func:`res2_chain_plain`. It goes through the custom op
``asv_torch::res2_chain`` (``ops/custom_ops.py``), so ``torch.export``
keeps the kernel in an exported graph.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from asvspoof2021_air_tpu_torch.models.common import BN_EPS
from asvspoof2021_air_tpu_torch.ops import _build
from asvspoof2021_air_tpu_torch.utils import profiling

KERNEL_WIDTH = 64


def fold_bn_inference(sd: Dict[str, torch.Tensor], prefix: str):
    """(a, b) of the inference BatchNorm ``prefix`` as y = a * x + b."""
    a = sd[prefix + ".weight"] / torch.sqrt(sd[prefix + ".running_var"]
                                            + BN_EPS)
    return a, sd[prefix + ".bias"] - sd[prefix + ".running_mean"] * a


def pack_chain_params(sd: Dict[str, torch.Tensor], block: str,
                      scale: int = 8):
    """Stacked chain parameters of Bottle2neck ``block`` (e.g. "layer1") of
    the port's state_dict: w (scale-1, 3 width, width) with the taps
    ordered t-d, t, t+d, and cb, a, b (scale-1, width), all f32. The kernel
    takes w in x's type: cast it once before the calls."""
    ws, cbs, as_, bs = [], [], [], []
    for j in range(scale - 1):
        k = sd[f"{block}.convs.{j}.weight"]                 # (O, I, 3)
        ws.append(k.permute(2, 1, 0).reshape(-1, k.shape[0]))
        cbs.append(sd[f"{block}.convs.{j}.bias"])
        a, b = fold_bn_inference(sd, f"{block}.bns.{j}")
        as_.append(a)
        bs.append(b)
    return (torch.stack(ws).float().contiguous(),
            torch.stack(cbs).float().contiguous(),
            torch.stack(as_).float().contiguous(),
            torch.stack(bs).float().contiguous())


def _shift_rows(x: torch.Tensor, shift: int) -> torch.Tensor:
    """y[:, t] = x[:, t - shift], zero-filled."""
    T = x.shape[1]
    if shift >= 0:
        return torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :T]
    return torch.nn.functional.pad(x, (0, 0, 0, -shift))[:, -shift:]


def res2_chain_plain(x, w, cb, a, b, *, dilation: int, scale: int = 8,
                     valid_len: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in PyTorch: x (B, T, width * scale) -> same
    shape and type."""
    B, T, C = x.shape
    width = C // scale
    dt = x.dtype
    valid = T if valid_len is None else valid_len
    rows = (torch.arange(T, device=x.device) < valid)[None, :, None]
    X = torch.where(rows, x, torch.zeros((), dtype=dt, device=x.device))
    wf = w.to(dt).float()
    outs, sp = [], None
    for i in range(scale - 1):
        g = X[..., i * width:(i + 1) * width]
        sp = g if i == 0 else (sp.float() + g.float()).to(dt)
        s = sp.float()
        x3 = torch.cat([_shift_rows(s, dilation), s,
                        _shift_rows(s, -dilation)], dim=-1)
        y = x3 @ wf[i] + cb[i]
        spf = a[i] * torch.relu(y) + b[i]
        sp = torch.where(rows, spf, torch.zeros((), device=x.device)).to(dt)
        outs.append(sp)
    outs.append(X[..., (scale - 1) * width:])
    return torch.cat(outs, dim=-1)


def res2_chain_kernel(x, w, cb, a, b, *, dilation: int, scale: int = 8,
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """Launch B2 on CUDA tensors."""
    B, T, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"res2_chain_kernel: unsupported dtype {x.dtype}")
    if C != KERNEL_WIDTH * scale:
        raise ValueError(f"res2_chain_kernel: width {C // scale} != "
                         f"{KERNEL_WIDTH}")
    valid = T if valid_len is None else int(valid_len)
    if not 1 <= valid <= T:
        raise ValueError(f"res2_chain_kernel: valid_len {valid} not in "
                         f"[1, {T}]")
    if w.dtype != x.dtype:
        raise ValueError(f"res2_chain_kernel: w is {w.dtype} and x is "
                         f"{x.dtype}; cast w to x's type once, ahead of the "
                         "calls (as ServingECAPA does)")
    if any(t.dtype != torch.float32 for t in (cb, a, b)):
        raise ValueError("res2_chain_kernel: cb, a, b must be float32")
    x, w, cb, a, b = (t.contiguous() for t in (x, w, cb, a, b))
    n, k = scale - 1, KERNEL_WIDTH
    _build.check_args("res2_chain_kernel", (x, None), (w, (n, 3 * k, k)),
                      (cb, (n, k)), (a, (n, k)), (b, (n, k)))
    if any(t.data_ptr() % 16 for t in (x, w)):
        raise ValueError("res2_chain_kernel: x and w must start on a "
                         "16-byte boundary (the kernel copies them with "
                         "16-byte cp.async)")
    out = torch.empty_like(x)
    _build.launch("res2_chain_forward", x.device, x.data_ptr(), w.data_ptr(),
                  cb.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  B, T, valid, dilation, scale, _build.DTYPE_CODES[x.dtype])
    profiling.count("B2")
    return out


def res2_chain_infer(x, w, cb, a, b, *, dilation: int, scale: int = 8,
                     valid_len: Optional[int] = None) -> torch.Tensor:
    """B2 on CUDA tensors, its plain version on CPU tensors (the custom op
    ``asv_torch::res2_chain``)."""
    from asvspoof2021_air_tpu_torch.ops import custom_ops

    return custom_ops.res2_chain(x, w, cb, a, b, dilation, scale, valid_len)
