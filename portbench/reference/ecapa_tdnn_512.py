"""Plain PyTorch ECAPA-TDNN (Desplanques et al., arXiv:2005.07143) as the
ASVspoof2021_AIR recipe builds it (``ecapa_tdnn.py``), in float32 with the
reference's state_dict names, as a function of a dict of tensors.

- stem: conv k=5 (``conv1``) -> ReLU -> BN (``bn1``);
- three SE-Res2 blocks (``layer1..3``), dilations 2/3/4: 1x1 conv ->
  ReLU -> BN; the input split in ``scale`` groups, group i (i < scale - 1)
  added to the previous group's output and passed through conv k=3 ->
  ReLU -> BN, the last group kept; 1x1 conv -> ReLU -> BN; the SE gate
  (mean over time, 1x1 conv to 128, ReLU, BN, 1x1 conv back, sigmoid);
  plus the block's input;
- the MFA: a 1x1 conv over the three blocks' outputs to 1536, ReLU;
- attentive statistics pooling with context: 1x1 conv over [x | mean |
  std] (std of the unbiased variance, at least 1e-4) to 128, ReLU, BN,
  1x1 conv to 1536, softmax over time; the weighted mean and the std
  sqrt(max(E_w[x^2] - mean^2, 1e-4));
- BN (``bn5``) -> embedding (``fc6``) -> logits (``fc7``) -> BN (``bn7``).

BN takes the batch's moments in train mode and the running ones in eval
mode. Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench.reference.common import batch_norm, conv1d, linear

BN_FIELDS = (("weight", "bn_weight"), ("bias", "bn_bias"),
             ("running_mean", "running_mean"), ("running_var", "running_var"))


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the state_dict; kind is
    "weight" (its fan-in is the product of all but the first axis), "bias",
    or a BN field."""
    C, F, s = cfg["channels"], cfg["feat_dim"], cfg["scale"]
    w, M, H = C // s, cfg["mfa_channels"], cfg["attention_hidden"]
    se, E, n_out = cfg["se_bottleneck"], cfg["embedding"], cfg["classes"]
    spec: List[Tuple[str, tuple, str]] = []

    def conv(name, shape, bias=True):
        spec.append((name + ".weight", shape, "weight"))
        if bias:
            spec.append((name + ".bias", (shape[0],), "bias"))

    def bn(name, n):
        spec.extend((f"{name}.{f}", (n,), kind) for f, kind in BN_FIELDS)

    conv("conv1", (C, F, 5))
    bn("bn1", C)
    for i in range(1, 4):
        t = f"layer{i}"
        conv(t + ".conv1", (C, C, 1))
        bn(t + ".bn1", C)
        for j in range(s - 1):
            conv(f"{t}.convs.{j}", (w, w, 3))
        for j in range(s - 1):
            bn(f"{t}.bns.{j}", w)
        conv(t + ".conv3", (C, C, 1))
        bn(t + ".bn3", C)
        conv(t + ".se.se.1", (se, C, 1))
        bn(t + ".se.se.3", se)
        conv(t + ".se.se.4", (C, se, 1))
    conv("layer4", (M, 3 * C, 1))
    conv("attention.0", (H, 3 * M, 1))
    bn("attention.2", H)
    conv("attention.3", (M, H, 1))
    bn("bn5", 2 * M)
    conv("fc6", (E, 2 * M))
    conv("fc7", (n_out, E))
    bn("bn7", n_out)
    return spec


def forward(p: Dict[str, torch.Tensor], feats: torch.Tensor, train: bool,
            noise=None, cfg: Optional[dict] = None,
            prec: Optional[str] = None):
    """(embedding, logits) of (B, T, F) features. ``noise`` is unused (the
    model draws nothing)."""
    s = cfg["scale"]
    relu = torch.relu

    def bn(x, name, dim=1):
        return batch_norm(x, p, name, train, dim)

    def c1(x, name, **kw):
        return conv1d(x, p[name + ".weight"], p.get(name + ".bias"), prec,
                      **kw)

    x = bn(relu(c1(feats.float().transpose(1, 2), "conv1", padding=2)), "bn1")
    outs = []
    for i, d in enumerate(cfg["dilations"]):
        t = f"layer{i + 1}"
        h = bn(relu(c1(x, t + ".conv1")), t + ".bn1")
        groups = torch.split(h, h.shape[1] // s, dim=1)
        chain, sp = [], None
        for j in range(s - 1):
            sp = groups[j] if j == 0 else sp + groups[j]
            sp = bn(relu(c1(sp, f"{t}.convs.{j}", padding=d, dilation=d)),
                    f"{t}.bns.{j}")
            chain.append(sp)
        chain.append(groups[s - 1])
        h = bn(relu(c1(torch.cat(chain, dim=1), t + ".conv3")), t + ".bn3")
        g = h.mean(dim=2, keepdim=True)
        g = bn(relu(c1(g, t + ".se.se.1")), t + ".se.se.3")
        g = torch.sigmoid(c1(g, t + ".se.se.4"))
        x = h * g + x
        outs.append(x)
    x = relu(c1(torch.cat(outs, dim=1), "layer4"))            # (B, M, T)
    T = x.shape[2]
    mean = x.mean(dim=2, keepdim=True)
    std = torch.sqrt(torch.clamp(x.var(dim=2, keepdim=True, correction=1),
                                 min=1e-4))
    ctx = torch.cat([x, mean.expand(-1, -1, T), std.expand(-1, -1, T)], dim=1)
    a = bn(relu(c1(ctx, "attention.0")), "attention.2")
    w = torch.softmax(c1(a, "attention.3"), dim=2)
    mu = torch.sum(x * w, dim=2)
    sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu,
                                min=1e-4))
    pooled = bn(torch.cat([mu, sg], dim=1), "bn5")
    emb = linear(pooled, p["fc6.weight"], p["fc6.bias"], prec)
    logits = bn(linear(emb, p["fc7.weight"], p["fc7.bias"], prec), "bn7")
    return emb, logits
