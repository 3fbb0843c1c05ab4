"""ECAPA-TDNN-512: its weights' names, its FLOP count, its hand-written
kernels' work."""

from __future__ import annotations

from portbench.harness import kernels
from portbench.reference import ecapa_tdnn_512 as reference


def param_spec(cfg: dict):
    return reference.param_spec(cfg) + [
        ("loss.center", (1, cfg["embedding"]), "center")]


def forward_flops(cfg: dict, frames: int) -> float:
    """Model FLOPs of one utterance's forward at ``frames`` frames, by the
    configuration's ``flops_convention``."""
    T, C, F, s = frames, cfg["channels"], cfg["feat_dim"], cfg["scale"]
    w, M, H = C // s, cfg["mfa_channels"], cfg["attention_hidden"]
    se, E = cfg["se_bottleneck"], cfg["embedding"]
    stem = 2 * T * C * F * 5
    block = 2 * (2 * T * C * C) + (s - 1) * 2 * T * w * w * 3 + 2 * (
        2 * C * se)
    mfa = 2 * T * 3 * C * M
    attention = 2 * T * M * H + 2 * 2 * M * H + 2 * T * H * M
    head = 2 * 2 * M * E + 2 * E * cfg["classes"]
    return float(stem + len(cfg["dilations"]) * block + mfa + attention
                 + head)


def kernel_work(cfg: dict, batch: int, train: bool) -> dict:
    """{kernel: its operations, bytes and peak a unit of work}: a batch
    scored (B2 once a block, B3) or a training step (B4a, B4b)."""
    T, dt = cfg["feat_len"], cfg["compute_dtype"]
    M, H = cfg["mfa_channels"], cfg["attention_hidden"]
    if train:
        return {"B4a": kernels.softmax_stats_b4a(batch, T, M, H, dt),
                "B4b": kernels.softmax_stats_b4b(batch, T, M, H, dt)}
    b2 = kernels.res2_chain_b2(batch, T, cfg["channels"], cfg["scale"], 3, dt)
    n = len(cfg["dilations"])
    return {"B2_" + {"bfloat16": "bf16", "float32": "f32"}[dt]: {
        "flops": n * b2["flops"], "bytes": n * b2["bytes"],
        "peak": b2["peak"]},
        "B3": kernels.attn_pool_b3(batch, T, M, H, dt)}


def train_noise(cfg, seed, step, batch, frames, device):
    """ECAPA draws nothing in train mode."""
    return None
