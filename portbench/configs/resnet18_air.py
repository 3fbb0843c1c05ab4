"""ResNet18 of the one-class recipe: its weights' names, its FLOP count, its
hand-written kernels' work (none: cuDNN runs its convolutions), and its
train-mode pooling noise."""

from __future__ import annotations

from portbench.reference import resnet18_air as reference


def param_spec(cfg: dict):
    return reference.param_spec(cfg) + [
        ("loss.center", (1, cfg["embedding"]), "center")]


def _conv(h, w, cin, cout, k, stride, pad):
    ho = (h + 2 * pad[0] - k[0]) // stride[0] + 1
    wo = (w + 2 * pad[1] - k[1]) // stride[1] + 1
    return ho, wo, 2.0 * ho * wo * cout * cin * k[0] * k[1]


def forward_flops(cfg: dict, frames: int) -> float:
    """Model FLOPs of one utterance's forward at ``frames`` frames, by the
    configuration's ``flops_convention``."""
    h, w, total = _conv(cfg["feat_dim"], frames, 1, cfg["stem_channels"],
                        (9, 3), (3, 1), (1, 1))
    for _t, cin, planes, stride in reference.blocks(cfg):
        h1, w1, f1 = _conv(h, w, cin, planes, (3, 3), (stride,) * 2, (1, 1))
        _, _, f2 = _conv(h1, w1, planes, planes, (3, 3), (1, 1), (1, 1))
        total += f1 + f2
        if stride != 1 or cin != planes:
            total += _conv(h, w, cin, planes, (1, 1), (stride,) * 2,
                           (0, 0))[2]
        h, w = h1, w1
    P, E = cfg["pool_channels"], cfg["embedding"]
    h, w, f5 = _conv(h, w, cfg["stages"][-1], P, (cfg["num_nodes"], 3),
                     (1, 1), (0, 1))
    total += f5 + 2.0 * w * P + 2.0 * 2 * P * E + 2.0 * E * cfg["classes"]
    return total


def kernel_work(cfg: dict, batch: int, train: bool) -> dict:
    return {}


def train_noise(cfg, seed, step, batch, frames, device):
    """The pooling noise of training step ``step`` (the model's stream)."""
    shape = (batch, reference.pooled_frames(cfg, frames),
             cfg["pool_channels"])
    return reference.noise_stream(seed, step, shape, device)
