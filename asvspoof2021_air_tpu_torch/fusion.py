"""Multi-system score fusion, in numpy.

The port's own copy of the JAX package's ``fusion.py``, which uses pandas:
average fusion (per-trial score sum over systems) and entropy-weighted
fusion driven by per-system EERs. A score frame here is a dict of numpy
columns ``fname``, ``sysid``, ``key`` (str) and ``score`` (float64). The
fused frame has one row per (fname, sysid, key), sorted by those three
keys, each score reduced over its rows in file order: the rows and order of
pandas' ``groupby(["fname", "sysid", "key"]).sum()`` / ``.mean()``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from asvspoof2021_air_tpu_torch.metrics.eer import polarity_min_eer

COLUMNS = ("fname", "sysid", "key", "score")
Frame = Dict[str, np.ndarray]


def read_score_frame(path: str) -> Frame:
    """A score file as a frame: the 4-column (fname sysid key score)
    layout, the 3-column (fname score key) one with sysid "-", or the
    2-column (fname score) one with sysid and key "-"."""
    data = np.genfromtxt(path, dtype=str)
    if data.ndim == 1:
        data = data[None, :]
    ncol = data.shape[1]
    dash = np.full(len(data), "-")
    if ncol == 2:
        cols = (data[:, 0], dash, dash, data[:, 1])
    elif ncol == 3:
        cols = (data[:, 0], dash, data[:, 2], data[:, 1])
    elif ncol == 4:
        cols = (data[:, 0], data[:, 1], data[:, 2], data[:, 3])
    else:
        raise ValueError(f"unsupported score file with {ncol} columns: {path}")
    frame = dict(zip(COLUMNS, cols))
    frame["score"] = frame["score"].astype(np.float64)
    return frame


def _group(frames: Sequence[Frame], mean: bool) -> Frame:
    """The frames' rows concatenated, grouped by (fname, sysid, key) in
    sorted order, and each group's scores summed (or averaged)."""
    cat = {c: np.concatenate([f[c] for f in frames]) for c in COLUMNS}
    # lexsort is stable: rows of a group keep their file order.
    order = np.lexsort((cat["key"], cat["sysid"], cat["fname"]))
    cols = {c: cat[c][order] for c in COLUMNS}
    new = np.zeros(len(order), bool)
    new[0] = True
    for c in ("fname", "sysid", "key"):
        new[1:] |= cols[c][1:] != cols[c][:-1]
    starts = np.flatnonzero(new)
    score = np.add.reduceat(cols["score"], starts)
    if mean:
        score = score / np.diff(np.append(starts, len(order)))
    out = {c: cols[c][starts] for c in ("fname", "sysid", "key")}
    out["score"] = score
    return out


def write_score_frame(frame: Frame, output: str) -> None:
    """``fname sysid key score`` lines, as pandas' ``to_csv(sep=" ",
    header=False, index=False)`` writes them."""
    with open(output, "w") as f:
        for fname, sysid, key, score in zip(*(frame[c] for c in COLUMNS)):
            f.write(f"{fname} {sysid} {key} {float(score)!r}\n")


def avg_fuse(paths: Sequence[str], output: Optional[str] = None) -> Frame:
    """Average fusion: the per-(fname, sysid, key) sum of system scores."""
    merged = _group([read_score_frame(p) for p in paths], mean=False)
    if output is not None:
        write_score_frame(merged, output)
    return merged


def entropy_weights(eers: Sequence[float]) -> List[float]:
    """EER-derived entropy weights: min-max normalize the inverted EERs,
    then weight each system by one minus its normalized entropy share.
    Systems with equal EERs get equal weights."""
    weight = [float(e) for e in eers]
    max_w, min_w = max(weight), min(weight)
    if max_w == min_w:
        return [1.0 / len(weight)] * len(weight)

    for i in range(len(weight)):
        w = (max_w - weight[i]) / (max_w - min_w)
        weight[i] = w if w != 0 else 1e-5

    k = 1.0 / math.log(len(weight))
    total = sum(weight)
    for i in range(len(weight)):
        p = weight[i] / total
        lnfi = math.log(p) * p * (-k) if weight[i] != 0 else 0.0
        weight[i] = 1 - lnfi
    sum_w = sum(weight)
    return [w / sum_w for w in weight]


def weighted_fuse(paths: Sequence[str],
                  eers: Optional[Sequence[float]] = None,
                  output: Optional[str] = None) -> Frame:
    """Entropy-weighted fusion: weight each system's scores, then average
    per trial. Without ``eers``, each system's polarity-min EER is taken
    from its own keyed score file."""
    frames = [read_score_frame(p) for p in paths]
    if eers is None:
        eers = [fused_eer(f) for f in frames]
    for frame, w in zip(frames, entropy_weights(eers)):
        frame["score"] = frame["score"] * w
    merged = _group(frames, mean=True)
    if output is not None:
        write_score_frame(merged, output)
    return merged


def fused_eer(frame: Frame) -> float:
    """Polarity-min EER of a fused (or single-system) score frame."""
    return polarity_min_eer(frame["score"][frame["key"] == "bonafide"],
                            frame["score"][frame["key"] == "spoof"])
