"""Differentiable softmax-weighted statistics pooling: kernels B4a (forward)
and B4b (backward) in ``csrc/attn_pool_vjp.cu``, and their plain versions.

Counterpart of the JAX package's ``ops/attn_pool_vjp.py``
``fused_softmax_stats``, the ``jax.custom_vjp`` whose forward and backward
are Pallas kernels (``_fwd_kernel``, ``_bwd_kernel``). For x (B, T, D),
the attention hidden h2 (B, T, 128), W2 (128, D) and b2 (D,) in f32:

    logits = h2 @ W2 + b2;  w = softmax over T per (b, d)
    mu = sum_t w x,  e2 = sum_t w x^2                 -> (B, D) f32 each

and, for cotangents g_mu, g_e2:

    q = g_mu x + g_e2 x^2,  S = sum_t w q,  dlog = w (q - S)
    dx = w (g_mu + 2 g_e2 x)   in x's type
    dh2 = dlog @ W2^T          in h2's type
    dW2 = sum_b h2^T dlog      in f32
    db2 = 0                    exactly: softmax over T cancels the bias

sigma = sqrt(clip(e2 - mu^2, 1e-4)) belongs to the caller, so its autodiff
stays standard. :class:`FusedSoftmaxStats` launches B4a and B4b on CUDA
tensors and runs the plain versions on CPU tensors; the kernels never
store the (B, T, D) logits or weights, and recompute them from h2 in the
backward. Every product of both kernels runs on the tensor cores in
3xTF32 (each f32 operand split into two TF32 parts, three TF32 products
summed in f32), which keeps f32's accuracy; B4a forms its logits with the
same tiles and summation order as B4b, so the backward recomputes the
forward's logits exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from asvspoof2021_air_tpu_torch.ops import _build
from asvspoof2021_air_tpu_torch.utils import profiling

HIDDEN = 128
TILE = 128                 # the kernels' channel tile: D % TILE == 0


def _softmax_over_t(h2: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor):
    """(w, max, normalizer) of softmax_T(h2 @ W2 + b2), as the JAX kernels
    form it: e = exp(logits - max), w = e / sum e."""
    logits = h2.float() @ w2 + b2
    m = logits.amax(dim=1)
    e = torch.exp(logits - m[:, None])
    l = e.sum(dim=1)
    return e / l[:, None], m, l


def softmax_stats_fwd_plain(x, h2, w2, b2):
    """B4a's function in PyTorch: (mu, e2, max, normalizer), (B, D) f32."""
    w, m, l = _softmax_over_t(h2, w2, b2)
    xf = x.float()
    return (xf * w).sum(dim=1), (xf * xf * w).sum(dim=1), m, l


def fused_softmax_stats_plain(x, h2, w2, b2) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(mu, e2), the function of ``fused_softmax_stats``, in PyTorch."""
    return softmax_stats_fwd_plain(x, h2, w2, b2)[:2]


def softmax_stats_bwd_plain(x, h2, w2, b2, res: Sequence[torch.Tensor],
                            gmu, ge2):
    """B4b's function in PyTorch: (dx, dh2, dW2) by the formulas above,
    recomputed from (x, h2, W2, b2); ``res`` (the kernel's residuals) is not
    read."""
    w, _, _ = _softmax_over_t(h2, w2, b2)
    xf = x.float()
    gm, g2 = gmu.float()[:, None], ge2.float()[:, None]
    q = gm * xf + g2 * (xf * xf)
    s = (w * q).sum(dim=1, keepdim=True)
    dlog = w * (q - s)
    dx = (w * (gm + 2.0 * g2 * xf)).to(x.dtype)
    dh2 = (dlog @ w2.t()).to(h2.dtype)
    dw2 = torch.einsum("btj,btd->jd", h2.float(), dlog)
    return dx, dh2, dw2


def _check(name: str, x, h2, w2, b2, *more):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, D)")
    B, T, D = x.shape
    if x.dtype not in _build.DTYPE_CODES or h2.dtype != x.dtype:
        raise ValueError(f"{name}: x and h2 must share a type of "
                         f"{sorted(map(str, _build.DTYPE_CODES))}, got "
                         f"{x.dtype} and {h2.dtype}")
    if D % TILE or T < 1:
        raise ValueError(f"{name}: D must be a multiple of {TILE} and T >= 1")
    if any(t.dtype != torch.float32 for t in (w2, b2, *more)):
        raise ValueError(f"{name}: W2, b2 and the (B, D) operands must be "
                         f"float32")
    _build.check_args(name, (x, None), (h2, (B, T, HIDDEN)),
                      (w2, (HIDDEN, D)), (b2, (D,)),
                      *((t, (B, D)) for t in more))
    if any(t.data_ptr() % 16 for t in (x, h2, w2)):
        raise ValueError(f"{name}: x, h2 and W2 must start on a 16-byte "
                         f"boundary (the kernels copy them with 16-byte "
                         f"cp.async)")


def softmax_stats_fwd_kernel(x, h2, w2, b2):
    """Launch B4a: (mu, e2, max, normalizer), (B, D) f32 each."""
    _check("softmax_stats_fwd_kernel", x, h2, w2, b2)
    B, T, D = x.shape
    out = [torch.empty((B, D), device=x.device, dtype=torch.float32)
           for _ in range(4)]
    _build.launch("attn_pool_vjp_forward", x.device, x.data_ptr(),
                  h2.data_ptr(), w2.data_ptr(), b2.data_ptr(), B, T, D,
                  *(t.data_ptr() for t in out), _build.DTYPE_CODES[x.dtype])
    profiling.count("B4a")
    return tuple(out)


def softmax_stats_bwd_kernel(x, h2, w2, b2, res: Sequence[torch.Tensor],
                             gmu, ge2):
    """Launch B4b (three passes, one call): (dx, dh2, dW2). ``res`` is
    B4a's (mu, e2, max, normalizer)."""
    mu, e2, m, l = res
    _check("softmax_stats_bwd_kernel", x, h2, w2, b2, mu, e2, m, l, gmu, ge2)
    B, T, D = x.shape
    dx = torch.empty_like(x)
    dh2 = torch.empty_like(h2)
    part = torch.empty((B, HIDDEN, D), device=x.device, dtype=torch.float32)
    dw2 = torch.empty((HIDDEN, D), device=x.device, dtype=torch.float32)
    _build.launch("attn_pool_vjp_backward", x.device, x.data_ptr(),
                  h2.data_ptr(), w2.data_ptr(), b2.data_ptr(), m.data_ptr(),
                  l.data_ptr(), mu.data_ptr(), e2.data_ptr(), gmu.data_ptr(),
                  ge2.data_ptr(), B, T, D, dx.data_ptr(), dh2.data_ptr(),
                  part.data_ptr(), dw2.data_ptr(), _build.DTYPE_CODES[x.dtype])
    profiling.count("B4b")
    return dx, dh2, dw2


class FusedSoftmaxStats(torch.autograd.Function):
    """(mu, e2) = fused_softmax_stats(x, h2, W2, b2), differentiable in all
    four inputs: B4a/B4b on CUDA tensors, the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, x, h2, w2, b2):
        fwd = softmax_stats_fwd_kernel if x.is_cuda else softmax_stats_fwd_plain
        res = fwd(x, h2, w2, b2)
        ctx.save_for_backward(x, h2, w2, b2, *res)
        return res[0], res[1]

    @staticmethod
    def backward(ctx, gmu, ge2):
        x, h2, w2, b2, *res = ctx.saved_tensors
        bwd = softmax_stats_bwd_kernel if x.is_cuda else softmax_stats_bwd_plain
        with profiling.span("asv.pool:bwd"):
            dx, dh2, dw2 = bwd(x, h2, w2, b2, res, gmu.float().contiguous(),
                               ge2.float().contiguous())
            return dx, dh2, dw2, torch.zeros_like(b2)


def fused_softmax_stats(x, h2, w2, b2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, e2) attentive statistics through :class:`FusedSoftmaxStats`."""
    return FusedSoftmaxStats.apply(x, h2, w2, b2)
