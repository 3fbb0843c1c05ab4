"""DET curve and equal error rate, and the EER of a score file.

The port's own copy of the JAX package's ``metrics/eer.py``: stable
mergesort over pooled scores, cumulative-sum sweep of the threshold, EER at
the operating point minimizing |FRR - FAR|.
"""

from __future__ import annotations

import numpy as np


def compute_det_curve(target_scores, nontarget_scores):
    """Sweep all thresholds; return (frr, far, thresholds). Higher scores
    mean stronger support for the target (bona fide) class."""
    target_scores = np.asarray(target_scores, dtype=np.float64).ravel()
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64).ravel()
    n_tar = target_scores.size
    n_non = nontarget_scores.size
    if n_tar == 0 or n_non == 0:
        raise ValueError("need at least one target and one nontarget score")

    pooled = np.concatenate((target_scores, nontarget_scores))
    is_target = np.concatenate(
        (np.ones(n_tar, dtype=np.float64), np.zeros(n_non, dtype=np.float64))
    )
    order = np.argsort(pooled, kind="mergesort")
    is_target = is_target[order]

    tar_below = np.cumsum(is_target)
    non_above = n_non - (np.arange(1, pooled.size + 1) - tar_below)

    frr = np.concatenate(([0.0], tar_below / n_tar))
    far = np.concatenate(([1.0], non_above / n_non))
    thresholds = np.concatenate(([pooled[order[0]] - 0.001], pooled[order]))
    return frr, far, thresholds


def compute_eer(target_scores, nontarget_scores):
    """(eer, threshold): the mean of FRR and FAR where they are closest."""
    frr, far, thresholds = compute_det_curve(target_scores, nontarget_scores)
    idx = int(np.argmin(np.abs(frr - far)))
    eer = float((frr[idx] + far[idx]) / 2.0)
    return eer, float(thresholds[idx])


def polarity_min_eer(target_scores, nontarget_scores):
    """EER invariant to score polarity: min(EER(s), EER(-s))."""
    eer_pos, _ = compute_eer(target_scores, nontarget_scores)
    eer_neg, _ = compute_eer(-np.asarray(target_scores),
                             -np.asarray(nontarget_scores))
    return min(eer_pos, eer_neg)


def eer_from_score_file(path: str) -> float:
    """Polarity-min EER of a ``fname score bonafide|spoof`` score file."""
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    if not rows or len(rows[0]) != 3:
        raise ValueError(f"score file needs 3 columns (fname score key): {path}")
    scores = np.array([float(r[1]) for r in rows])
    keys = np.array([r[2] for r in rows])
    return polarity_min_eer(scores[keys == "bonafide"],
                            scores[keys == "spoof"])
