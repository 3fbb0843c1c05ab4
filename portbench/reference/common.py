"""Plain PyTorch pieces shared by the references: the products in a
chosen precision, batch norm, LFCC, OC-Softmax, and the dual optimizer.

Nothing here imports the program under test. Every function computes in
float32 with TF32 off (:func:`full_f32`), unless a precision is named:
``prec="fp8"`` computes every convolution and matrix product in float8
as the float8 training recipes do: its operands and its output rounded
to e4m3 going forward and their gradients to e5m2 coming back, each with
one scale per tensor (the largest magnitude mapped to the format's
largest), the step below bfloat16 that a port could be tempted to take;
``prec="bf16"`` rounds the same tensors to bfloat16 both ways, a witness
of what bfloat16 products do. The backward's products read the rounded
operands that the forward saved.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
BN_EPS = 1e-5


def full_f32() -> None:
    """Float32 products in full float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 ``dtype`` under one per-tensor scale that
    maps its largest magnitude to ``top``, in x's type."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Rounded(torch.autograd.Function):
    """A tensor rounded as the float8 recipes round it: to e4m3 going
    forward, its gradient to e5m2 coming back; or both ways to bfloat16."""

    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        if prec == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        return _scaled_round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.prec == "bf16":
            return g.to(torch.bfloat16).to(g.dtype), None
        return _scaled_round(g, torch.float8_e5m2, E5M2_MAX), None


def operand(x: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    if prec is None:
        return x
    if prec not in ("fp8", "bf16"):
        raise ValueError(f"unknown precision {prec!r}")
    return _Rounded.apply(x, prec)


def conv1d(x, w, b=None, prec=None, padding=0, dilation=1):
    return operand(F.conv1d(operand(x, prec), operand(w, prec), b, 1,
                            padding, dilation), prec)


def conv2d(x, w, b=None, prec=None, stride=1, padding=0):
    return operand(F.conv2d(operand(x, prec), operand(w, prec), b, stride,
                            padding), prec)


def linear(x, w, b=None, prec=None):
    return operand(F.linear(operand(x, prec), operand(w, prec), b), prec)


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
               train: bool, channel_dim: int = 1) -> torch.Tensor:
    """BatchNorm ``name`` over every axis but ``channel_dim``: in train mode
    with the batch's biased moments, in eval mode with the running ones."""
    dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
    shape = [1] * x.dim()
    shape[channel_dim] = x.shape[channel_dim]
    if train:
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
    else:
        mean = p[name + ".running_mean"].view(shape)
        var = p[name + ".running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * p[name + ".weight"].view(
        shape) + p[name + ".bias"].view(shape))


# ---- LFCC -----------------------------------------------------------------

def _trimf(x: np.ndarray, a: float, b: float, c: float) -> np.ndarray:
    y = np.zeros_like(x)
    up = (a < x) & (x < b)
    y[up] = (x[up] - a) / (b - a)
    down = (b < x) & (x < c)
    y[down] = (c - x[down]) / (c - b)
    y[x == b] = 1.0
    return y


def lfcc(wave: torch.Tensor, lengths: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, L) waveforms with their lengths -> (B, 1 + L // hop, 3 n) LFCC:
    pre-emphasis (zero past each length), frames of ``win`` samples every
    ``hop`` centred in an ``n_fft`` frame whose centre is sample t hop,
    a periodic Hamming window, the power spectrum, ``n`` linear triangular
    filters, log10 (+ float32 eps), the orthonormal DCT-II, then the deltas
    and delta-deltas with each utterance's last frame repeated."""
    win, hop, n_fft, n = cfg["win"], cfg["hop"], cfg["n_fft"], cfg["n_filters"]
    sr, coef = cfg["sample_rate"], cfg["preemphasis"]
    dev = wave.device
    x = wave.float()
    x = torch.cat([x[:, :1], x[:, 1:] - coef * x[:, :-1]], dim=1)
    keep = torch.arange(x.shape[1], device=dev)[None, :] < lengths[:, None]
    x = x * keep
    B, L = x.shape
    T = 1 + L // hop
    left = n_fft // 2 - (n_fft - win) // 2            # samples before frame 0
    right = max(0, (T - 1) * hop - left + win - L)
    frames = F.pad(x, (left, right)).unfold(1, win, hop)[:, :T]
    k = torch.arange(win, dtype=torch.float64)
    window = (0.54 - 0.46 * torch.cos(2 * math.pi * k / win)).float()
    spec = torch.fft.rfft(frames * window.to(dev), n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    f = (sr / 2.0) * np.linspace(0.0, 1.0, n_fft // 2 + 1)
    edges = np.linspace(f.min(), f.max(), n + 2)
    fb = np.stack([_trimf(f, edges[i], edges[i + 1], edges[i + 2])
                   for i in range(n)], axis=1)
    fb = torch.from_numpy(fb.astype(np.float32)).to(dev)
    i = np.arange(n)
    dct = np.cos(np.pi * (2 * i[:, None] + 1) * i[None, :] / (2 * n))
    dct *= np.where(i == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))[None, :]
    dct = torch.from_numpy(dct.astype(np.float32)).to(dev)
    eps = float(np.finfo(np.float32).eps)
    c = torch.log10(power @ fb + eps) @ dct                  # (B, T, n)
    last = (lengths // hop).long()                           # last frame

    def delta(v):
        t = torch.arange(T, device=dev)[None, :]
        nxt = torch.minimum(t + 1, last[:, None])
        prv = torch.clamp(t - 1, min=0)
        rows = torch.arange(B, device=dev)[:, None]
        out = v[rows, nxt] - v[rows, prv]
        # past the last frame the next frame is the last one, as at it
        return out

    d1 = delta(c)
    return torch.cat([c, d1, delta(d1)], dim=-1)


def repeat_pad(feats: torch.Tensor, lengths: torch.Tensor, hop: int,
               frames: int) -> torch.Tensor:
    """Frame t of each utterance reads its frame t mod (1 + length // hop),
    for ``frames`` frames."""
    valid = torch.clamp(1 + lengths // hop, min=1)
    t = torch.arange(frames, device=feats.device)
    rows = torch.arange(feats.shape[0], device=feats.device)[:, None]
    return feats[rows, t[None, :] % valid[:, None]]


# ---- OC-Softmax and the optimizers -----------------------------------------

def oc_softmax(emb: torch.Tensor, center: torch.Tensor, labels: torch.Tensor,
               r_real: float, r_fake: float, alpha: float):
    """(mean softplus(alpha * margin), -cos) of the embeddings to the
    centre: margin r_real - cos for bona fide (label 0), cos - r_fake for
    spoof."""
    cos = (F.normalize(emb, dim=1) @ F.normalize(center, dim=1).t())[:, 0]
    margin = torch.where(labels == 0, r_real - cos, cos - r_fake)
    return F.softplus(alpha * margin).mean(), -cos


class DualOptimizer:
    """Adam with L2 weight decay added to the gradient (``betas``, ``eps``)
    on the backbone's parameters, plain SGD on the loss's centre, both at
    ``lr``. A parameter without a gradient takes a zero one."""

    def __init__(self, backbone: Sequence[str], lr: float, betas, eps: float,
                 weight_decay: float):
        self.backbone = list(backbone)
        self.lr, self.b1, self.b2 = lr, betas[0], betas[1]
        self.eps, self.wd = eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def effective_grads(self, p, grads) -> Dict[str, torch.Tensor]:
        """The gradient each optimizer takes: the backbone's with the decay
        added, the centre's as it is."""
        out = {}
        for k in p:
            g = grads.get(k)
            g = torch.zeros_like(p[k]) if g is None else g
            out[k] = g + self.wd * p[k] if k in self.backbone else g
        return out

    def step(self, p, grads) -> Dict[str, torch.Tensor]:
        self.t += 1
        g_eff = self.effective_grads(p, grads)
        new = {}
        for k, g in g_eff.items():
            if k not in self.backbone:
                new[k] = p[k] - self.lr * g
                continue
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            new[k] = p[k] - self.lr * mh / (torch.sqrt(vh) + self.eps)
        return new


def losses_at(forward, params: Dict[str, torch.Tensor], batches: List[dict],
              loss_cfg: dict, noise=None):
    """(OC-Softmax's losses, the logits' mean cross-entropy on the labels)
    of the train-mode forward at ``params`` on each of ``batches``, each
    with the draw ``noise``."""
    oc, ce = [], []
    with torch.no_grad():
        for batch in batches:
            emb, logits = forward(params, batch["feat"], True, noise)
            loss, _ = oc_softmax(emb, params["loss.center"], batch["label"],
                                 loss_cfg["r_real"], loss_cfg["r_fake"],
                                 loss_cfg["alpha"])
            oc.append(float(loss))
            ce.append(float(F.cross_entropy(logits, batch["label"])))
    return oc, ce


def train_steps(forward, params: Dict[str, torch.Tensor],
                batches: List[dict], loss_cfg: dict, opt_cfg: dict,
                backbone: Sequence[str], noise=None) -> dict:
    """len(batches) training steps of the model ``forward(p, feats, train,
    noise)`` -> (embedding, logits) under OC-Softmax and the dual
    optimizer, from ``params``. Returns each step's loss, the first step's
    raw gradients, and Adam's first moments and the parameters after the
    last step. Only trained parameters are in
    ``params`` (BN's running statistics do not enter a train-mode
    forward)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = DualOptimizer(backbone, opt_cfg["lr"], opt_cfg["betas"],
                        opt_cfg["eps"], opt_cfg["weight_decay"])
    losses, first = [], None
    for i, batch in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        emb, _logits = forward(leaves, batch["feat"], True,
                               None if noise is None else noise[i])
        loss, _ = oc_softmax(emb, leaves["loss.center"], batch["label"],
                             loss_cfg["r_real"], loss_cfg["r_fake"],
                             loss_cfg["alpha"])
        names = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[k] for k in names],
                                 allow_unused=True)
        grads = {k: g for k, g in zip(names, gs) if g is not None}
        if i == 0:
            first = {k: grads.get(k, torch.zeros_like(p[k])) for k in p}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            p = opt.step(p, grads)
    return {"losses": losses, "grads": first, "moments": dict(opt.m),
            "params": p}
