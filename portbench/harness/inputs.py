"""Inputs made from the seed: the weights, and the traffic's pools.

Everything is drawn on the run's device from ``torch.Generator``s seeded
from ``--seed`` through numpy's SeedSequence, in a few large calls, so
that a seed gives the same inputs on the same card and software. The
traffic's sizes do not depend on the seed: the utterance lengths are the
same stratified quantiles of the traffic's length distribution for every
seed, and the bona fide rows the same count, only shuffled by the seed,
so every seed asks for the same work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

WEIGHTS, WAVES, FEATURES, ORDER = range(4)


def generator(seed: int, stream: int, device) -> torch.Generator:
    word = np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def make_weights(spec: List[Tuple[str, tuple, str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``spec``'s (name, shape, kind), from one
    standard-normal draw z, by kind (:data:`INIT`): a weight z / sqrt(fan-in),
    a bias 0.05 z, BN's weight 1 + 0.1 z, its bias and running mean 0.1 z,
    its running variance exp(0.2 z), the loss's centre z."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device),
                    device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        v = z[at:at + n].view(shape)
        at += n
        out[name] = INIT[kind](v, n // shape[0]).clone()
    return out


INIT = {
    "weight": lambda v, fan_in: v / math.sqrt(fan_in),
    "bias": lambda v, fan_in: 0.05 * v,
    "bn_weight": lambda v, fan_in: 1.0 + 0.1 * v,
    "bn_bias": lambda v, fan_in: 0.1 * v,
    "running_mean": lambda v, fan_in: 0.1 * v,
    "running_var": lambda v, fan_in: torch.exp(0.2 * v),
    "center": lambda v, fan_in: v,
}


def lengths_quantiles(n: int, params: dict) -> np.ndarray:
    """n utterance lengths in seconds: the stratified quantiles (i + 0.5) / n
    of a log-normal (median ``median_s``, ``sigma`` in log) clipped to
    [``min_s``, ``max_s``]."""
    from statistics import NormalDist

    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
    s = params["median_s"] * np.exp(params["sigma"] * z)
    return np.clip(s, params["min_s"], params["max_s"])


def shuffled_sizes(n: int, traffic: dict, seed: int):
    """(lengths in samples, labels) of n utterances, shuffled by the seed;
    labels 0 (bona fide) for round(share n) rows, 1 (spoof) for the rest."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, ORDER]))
    secs = lengths_quantiles(n, traffic["lengths"])
    samples = np.round(secs * traffic["sample_rate"]).astype(np.int64)
    labels = np.ones(n, np.int64)
    labels[:int(round(traffic["bonafide_share"] * n))] = 0
    return samples[rng.permutation(n)], labels[rng.permutation(n)]


def pinned(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    return t.pin_memory() if torch.cuda.is_available() else t


def wave_pool(traffic: dict, seed: int, device) -> dict:
    """``pool_batches`` batches of ``batch`` waveforms, {"wave": (P, B,
    max_samples) f32, "length": (P, B) int64} on the host
    (pinned where there is a card). An utterance longer than
    ``max_samples`` is cut to it; past its length a row is zero. The
    signal is Gaussian noise with a per-utterance gain (log-uniform over
    ``gain``) under a slow amplitude modulation (``mod_hz``)."""
    P, B, L = traffic["pool_batches"], traffic["batch"], traffic["max_samples"]
    n = P * B
    samples, _labels = shuffled_sizes(n, traffic, seed)
    length = torch.from_numpy(np.minimum(samples, L))
    gen = generator(seed, WAVES, device)
    sig = traffic["signal"]
    u = torch.rand((n, 3), generator=gen, device=device)
    lo, hi = (math.log(g) for g in sig["gain"])
    gain = torch.exp(lo + (hi - lo) * u[:, 0])
    f_lo, f_hi = sig["mod_hz"]
    freq = f_lo + (f_hi - f_lo) * u[:, 1]
    phase = 2 * math.pi * u[:, 2]
    t = torch.arange(L, device=device, dtype=torch.float32) / traffic[
        "sample_rate"]
    idx = torch.arange(L, device=device)
    wave = torch.empty((n, L), device=device)
    rows = 256
    for r in range(0, n, rows):
        sl = slice(r, min(n, r + rows))
        env = 1.0 + sig["mod_depth"] * torch.sin(
            2 * math.pi * freq[sl, None] * t[None, :] + phase[sl, None])
        z = torch.randn((sl.stop - r, L), generator=gen, device=device)
        keep = idx[None, :] < length[sl].to(device)[:, None]
        wave[sl] = gain[sl, None] * env * z * keep
    return {"wave": pinned(wave.view(P, B, L)),
            "length": pinned(length.view(P, B))}


def feature_pool(traffic: dict, feat_dim: int, seed: int, device) -> dict:
    """``pool_batches`` batches of features, stacked ``steps_per_call`` to
    a call: {"feat": (P / K, K, B, feat_len, F) f32, "label": (P / K, K, B)
    int64} on the host (pinned where there is a card). Each utterance
    has 1 + samples // hop frames of standard-normal features, scaled per
    dimension by ``feature_scale`` (from the first dimension to the last),
    repeat-padded to ``feat_len`` or, when longer, cropped at a start drawn
    from the seed."""
    P, B, K = traffic["pool_batches"], traffic["batch"], traffic[
        "steps_per_call"]
    T, hop = traffic["feat_len"], traffic["hop"]
    n = P * B
    samples, labels = shuffled_sizes(n, traffic, seed)
    frames = torch.from_numpy(1 + samples // hop)
    longest = int(frames.max())
    gen = generator(seed, FEATURES, device)
    lo, hi = traffic["feature_scale"]
    scale = torch.linspace(lo, hi, feat_dim, device=device)
    starts = (torch.rand(n, generator=gen, device=device)
              * torch.clamp(frames.to(device) - T + 1, min=1)).long()
    out = torch.empty((n, T, feat_dim), device=device)
    t = torch.arange(T, device=device)
    rows = 128
    for r in range(0, n, rows):
        sl = slice(r, min(n, r + rows))
        raw = torch.randn((sl.stop - r, longest, feat_dim), generator=gen,
                          device=device) * scale
        fr = frames[sl].to(device)[:, None]
        idx = torch.where(fr >= T, starts[sl, None] + t[None, :],
                          t[None, :] % fr)
        out[sl] = raw[torch.arange(sl.stop - r, device=device)[:, None], idx]
    return {"feat": pinned(out.view(P // K, K, B, T, feat_dim)),
            "label": pinned(torch.from_numpy(labels).view(P // K, K, B))}
