"""Score-file evaluation: EER and min-tDCF from score files on disk.

The port's own copy of the JAX package's ``metrics/evaluate.py``. Score
files are whitespace-separated lines of ``fname score [key]`` (key
``bonafide``/``spoof``), the layout the scorer writes, or ``fname sysid key
score``, the layout the fusion utility reads. The histogram plot of
``compute_eer_and_tdcf(plot=True)`` comes with the port of the visualize
module (ROADMAP Queue A, the tooling item).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from asvspoof2021_air_tpu_torch.metrics.eer import (
    compute_eer, polarity_min_eer)
from asvspoof2021_air_tpu_torch.metrics.tdcf import (
    ASVSPOOF2019_COST_MODEL, compute_tDCF, obtain_asv_error_rates)


def read_score_file(path: str):
    """A score file as a dict of numpy columns ``fname``, ``score``
    (float64), ``key`` and ``sysid`` (None where the layout has none), from
    the 2-column (fname score), 3-column (fname score key) or 4-column
    (fname sysid key score) layout."""
    data = np.genfromtxt(path, dtype=str)
    if data.ndim == 1:
        data = data[None, :]
    ncol = data.shape[1]
    if ncol == 2:
        return {"fname": data[:, 0], "score": data[:, 1].astype(np.float64),
                "key": None, "sysid": None}
    if ncol == 3:
        return {"fname": data[:, 0], "score": data[:, 1].astype(np.float64),
                "key": data[:, 2], "sysid": None}
    if ncol == 4:
        return {"fname": data[:, 0], "sysid": data[:, 1], "key": data[:, 2],
                "score": data[:, 3].astype(np.float64)}
    raise ValueError(f"unsupported score file with {ncol} columns: {path}")


def eer_from_score_file(path: str) -> float:
    """Polarity-min EER of a keyed score file (a fraction, not percent)."""
    cols = read_score_file(path)
    if cols["key"] is None:
        raise ValueError(f"score file has no bonafide/spoof key column: {path}")
    return polarity_min_eer(cols["score"][cols["key"] == "bonafide"],
                            cols["score"][cols["key"] == "spoof"])


def compute_eer_and_tdcf(
    cm_score_file: str,
    path_to_database: Optional[str] = None,
    asv_score_file: Optional[str] = None,
    plot: bool = False,
    plot_path_prefix: Optional[str] = None,
) -> Tuple[float, Optional[float]]:
    """(EER, min-tDCF) of a keyed CM score file.

    The ASV operating point is fixed at the EER threshold of the
    organizers' ASV score file; min-tDCF is taken for whichever CM score
    polarity gives the lower EER. min-tDCF is None when there is no ASV
    score file. ``plot`` (with an ASV score file) writes the score
    histograms to ``<prefix>1.png`` and the t-DCF curve to
    ``<prefix>2.png``, the prefix the score file's path without ``.txt``
    unless ``plot_path_prefix`` names one (matplotlib on the host, Agg,
    imported only then)."""
    if asv_score_file is None and path_to_database is not None:
        asv_score_file = os.path.join(
            path_to_database, "LA/ASVspoof2019_LA_asv_scores/"
            "ASVspoof2019.LA.asv.eval.gi.trl.scores.txt")

    cm = read_score_file(cm_score_file)
    if cm["key"] is None:
        raise ValueError("CM score file must carry bonafide/spoof keys")
    bona_cm = cm["score"][cm["key"] == "bonafide"]
    spoof_cm = cm["score"][cm["key"] == "spoof"]

    eer_cm = compute_eer(bona_cm, spoof_cm)[0]
    other_eer_cm = compute_eer(-bona_cm, -spoof_cm)[0]
    eer = min(eer_cm, other_eer_cm)

    min_tdcf = None
    if asv_score_file is not None and os.path.exists(asv_score_file):
        asv_data = np.genfromtxt(asv_score_file, dtype=str)
        asv_keys = asv_data[:, 1]
        asv_scores = asv_data[:, 2].astype(np.float64)
        tar_asv = asv_scores[asv_keys == "target"]
        non_asv = asv_scores[asv_keys == "nontarget"]
        spoof_asv = asv_scores[asv_keys == "spoof"]

        _, asv_threshold = compute_eer(tar_asv, non_asv)
        pfa_asv, pmiss_asv, pmiss_spoof_asv = obtain_asv_error_rates(
            tar_asv, non_asv, spoof_asv, asv_threshold)
        if eer_cm <= other_eer_cm:
            b, s = bona_cm, spoof_cm
        else:
            b, s = -bona_cm, -spoof_cm
        tdcf_curve, cm_thresholds = compute_tDCF(
            b, s, pfa_asv, pmiss_asv, pmiss_spoof_asv,
            ASVSPOOF2019_COST_MODEL)
        min_idx = int(np.argmin(tdcf_curve))
        min_tdcf = float(tdcf_curve[min_idx])
        if plot:
            _plot_score_histograms_and_tdcf(
                tar_asv, non_asv, spoof_asv, asv_threshold, bona_cm,
                spoof_cm, tdcf_curve, cm_thresholds, min_idx,
                plot_path_prefix or cm_score_file[:-4])

    print("\nCM SYSTEM")
    print("   EER            = {:8.5f} % (Equal error rate for "
          "countermeasure)".format(eer * 100))
    if min_tdcf is not None:
        print("\nTANDEM")
        print("   min-tDCF       = {:8.5f}".format(min_tdcf))
    return eer, min_tdcf


def _plot_score_histograms_and_tdcf(
    tar_asv, non_asv, spoof_asv, asv_threshold,
    bona_cm, spoof_cm, tdcf_curve, cm_thresholds, min_idx, prefix,
):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.subplot(121)
    plt.hist(tar_asv, histtype="step", density=True, bins=50, label="Target")
    plt.hist(non_asv, histtype="step", density=True, bins=50, label="Nontarget")
    plt.hist(spoof_asv, histtype="step", density=True, bins=50, label="Spoof")
    plt.plot(asv_threshold, 0, "o", markersize=10, mfc="none", mew=2,
             clip_on=False, label="EER threshold")
    plt.legend()
    plt.xlabel("ASV score")
    plt.ylabel("Density")
    plt.title("ASV score histogram")

    plt.subplot(122)
    plt.hist(bona_cm, histtype="step", density=True, bins=50, label="Bona fide")
    plt.hist(spoof_cm, histtype="step", density=True, bins=50, label="Spoof")
    plt.legend()
    plt.xlabel("CM score")
    plt.title("CM score histogram")
    fig.savefig(prefix + "1.png")
    plt.close(fig)

    fig = plt.figure()
    plt.plot(cm_thresholds, tdcf_curve)
    plt.plot(cm_thresholds[min_idx], tdcf_curve[min_idx], "o", markersize=10,
             mfc="none", mew=2)
    plt.xlabel("CM threshold index (operating point)")
    plt.ylabel("Norm t-DCF")
    plt.title("Normalized tandem t-DCF")
    plt.plot([np.min(cm_thresholds), np.max(cm_thresholds)], [1, 1], "--",
             color="black")
    plt.xlim([np.min(cm_thresholds), np.max(cm_thresholds)])
    plt.ylim([0, 1.5])
    fig.savefig(prefix + "2.png")
    plt.close(fig)
