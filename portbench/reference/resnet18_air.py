"""Plain PyTorch ResNet18 of the one-class recipe (Zhang, Jiang and Duan,
arXiv:2010.13995; ASVspoof2021_AIR ``resnet.py``), in float32 with the
reference's state_dict names, as a function of a dict of tensors.

- input (B, T, F) features as a (B, 1, F, T) image;
- stem: conv (9, 3), stride (3, 1), padding (1, 1), to 16 channels, no
  bias -> BN -> ReLU;
- four stages of two pre-activation basic blocks, 64/128/256/512
  channels, strides 1/2/2/2: relu(bn1(x)) -> conv 3x3 (stride) ->
  relu(bn2) -> conv 3x3, plus x, or, where the shape changes, a 1x1 conv
  (stride) of relu(bn1(x)) (``shortcut.0``);
- conv5 (num_nodes, 3), padding (0, 1), to 256 -> BN -> ReLU, which
  leaves one row of frequency;
- self-attention pooling over time: softmax of tanh(x . att_weights),
  the weighted frames' sum and their unbiased std, with 1e-5 times the
  train-mode ``noise`` added to the weighted frames before the std;
- ``fc`` (embedding) and ``fc_mu`` (logits).

Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference.common import batch_norm, conv2d, linear

BN_FIELDS = (("weight", "bn_weight"), ("bias", "bn_bias"),
             ("running_mean", "running_mean"), ("running_var", "running_var"))


def blocks(cfg: dict):
    """(prefix, in_planes, planes, stride) of every basic block."""
    out, cin = [], cfg["stem_channels"]
    for i, (planes, stride) in enumerate(zip(cfg["stages"], cfg["strides"])):
        for b in range(cfg["blocks"][i]):
            out.append((f"layer{i + 1}.{b}", cin, planes,
                        stride if b == 0 else 1))
            cin = planes
    return out


def pooled_frames(cfg: dict, frames: int) -> int:
    """Frames left after the stages' strides (the stem keeps the time
    axis: stride 1 there)."""
    for s in cfg["strides"]:
        frames = (frames + 2 - 3) // s + 1
    return frames


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    spec: List[Tuple[str, tuple, str]] = []

    def bn(name, n):
        spec.extend((f"{name}.{f}", (n,), kind) for f, kind in BN_FIELDS)

    stem = cfg["stem_channels"]
    spec.append(("conv1.weight", (stem, 1, 9, 3), "weight"))
    bn("bn1", stem)
    for t, cin, planes, stride in blocks(cfg):
        bn(t + ".bn1", cin)
        spec.append((t + ".conv1.weight", (planes, cin, 3, 3), "weight"))
        bn(t + ".bn2", planes)
        spec.append((t + ".conv2.weight", (planes, planes, 3, 3), "weight"))
        if stride != 1 or cin != planes:
            spec.append((t + ".shortcut.0.weight", (planes, cin, 1, 1),
                         "weight"))
    last, P = cfg["stages"][-1], cfg["pool_channels"]
    spec.append(("conv5.weight", (P, last, cfg["num_nodes"], 3), "weight"))
    bn("bn5", P)
    spec.append(("attention.att_weights", (1, P), "weight"))
    E, n_out = cfg["embedding"], cfg["classes"]
    spec += [("fc.weight", (E, 2 * P), "weight"), ("fc.bias", (E,), "bias"),
             ("fc_mu.weight", (n_out, E), "weight"),
             ("fc_mu.bias", (n_out,), "bias")]
    return spec


def forward(p: Dict[str, torch.Tensor], feats: torch.Tensor, train: bool,
            noise: Optional[torch.Tensor] = None, cfg: Optional[dict] = None,
            prec: Optional[str] = None):
    """(embedding, logits) of (B, T, F) features; ``noise`` (B, T', P) is
    the train-mode pooling noise."""
    relu = torch.relu

    def bn_relu(x, name):
        return relu(batch_norm(x, p, name, train))

    x = feats.float().transpose(1, 2)[:, None]               # (B, 1, F, T)
    x = bn_relu(conv2d(x, p["conv1.weight"], None, prec, (3, 1), (1, 1)),
                "bn1")
    for t, cin, planes, stride in blocks(cfg):
        out = bn_relu(x, t + ".bn1")
        short = x
        if stride != 1 or cin != planes:
            short = conv2d(out, p[t + ".shortcut.0.weight"], None, prec,
                           stride, 0)
        out = conv2d(out, p[t + ".conv1.weight"], None, prec, stride, 1)
        out = conv2d(bn_relu(out, t + ".bn2"), p[t + ".conv2.weight"], None,
                     prec, 1, 1)
        x = out + short
    x = bn_relu(conv2d(x, p["conv5.weight"], None, prec, 1, (0, 1)), "bn5")
    x = x.squeeze(2).transpose(1, 2)                         # (B, T', P)
    att = linear(x, p["attention.att_weights"], None, prec)[..., 0]
    w = torch.softmax(torch.tanh(att), dim=1)
    weighted = x * w[..., None]
    mean = weighted.sum(dim=1)
    if train and noise is not None:
        weighted = weighted + 1e-5 * noise
    std = torch.std(weighted, dim=1, correction=1)
    emb = linear(torch.cat([mean, std], dim=1), p["fc.weight"], p["fc.bias"],
                 prec)
    return emb, linear(emb, p["fc_mu.weight"], p["fc_mu.bias"], prec)


def noise_stream(seed: int, step: int, shape, device) -> torch.Tensor:
    """The train-mode pooling noise of training step ``step`` of a run with
    base seed ``seed``: standard-normal draws from a generator on
    ``device`` seeded with numpy's SeedSequence([seed, step, 1]) (the
    model's stream, 1, after the front end's, 0), its first 64-bit word
    shifted right by one. The program under test draws its noise stream
    by this rule; the reference works it out again from the seed."""
    word = np.random.SeedSequence([seed, step, 1]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(word) >> 1)
    return torch.randn(tuple(shape), generator=gen, device=device)
